from goma_tpu_torch.bc.free_surface import (CapillaryBC, KinematicBC,
                                            NormalFlux, SurfaceViscosity,
                                            Traction)
from goma_tpu_torch.bc.shell_end import (
    EndpointAdvectiveOutflow,
    EndpointFlux,
    shell_end_sidesets,
)
from goma_tpu_torch.bc.porous_leak import (
    LatentHeatFlux,
    PorousMassFlux,
    VNormLeak,
    kelvin_gas_density,
)
from goma_tpu_torch.bc.fluid import FlowPressure
from goma_tpu_torch.bc.traction import (
    CoulombFriction,
    ElecTraction,
    FlowGradV,
    ForceSIC,
    SlopeBC,
)
