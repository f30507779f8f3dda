from goma_tpu_torch.bc.free_surface import (CapillaryBC, KinematicBC,
                                            NormalFlux, SurfaceViscosity,
                                            Traction)
from goma_tpu_torch.bc.shell_end import (
    EndpointAdvectiveOutflow,
    EndpointFlux,
    shell_end_sidesets,
)
