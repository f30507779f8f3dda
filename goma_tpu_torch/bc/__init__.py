from goma_tpu_torch.bc.free_surface import (CapillaryBC, KinematicBC,
                                            NormalFlux, SurfaceViscosity,
                                            Traction)
