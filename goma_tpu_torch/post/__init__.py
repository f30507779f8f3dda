from goma_tpu_torch.post.postproc import (flow_rate,
                                          heat_flux, sideset_integral,
                                          stream_function, traction_integrand,
                                          volume_integral)
from goma_tpu_torch.post.quality import (QualityReport, element_quality,
                                         make_quality_fn)
from goma_tpu_torch.post.stats import format_stats, variable_stats
