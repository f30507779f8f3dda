from goma_tpu_torch.post.quality import (QualityReport, element_quality,
                                         make_quality_fn)
