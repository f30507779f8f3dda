from goma_tpu_torch.bc.free_surface import (CapillaryBC, KinematicBC,
                                            NormalFlux, SurfaceViscosity,
                                            Traction)
from goma_tpu_torch.bc.surface_domain import (
    SDCStefanFlow,
    SDCStefanVolumeFlow,
    SurfDomainMassFlux,
)
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
from goma_tpu_torch.bc.fluid import (
    AirFilmSlip,
    ConvectiveHeatFlux,
    ElectrokineticSlip,
    FlowPressure,
    LaserWeldFlux,
    LatentHeatInternal,
    DvzdrZero,
    LevelSetSlip,
    LSNoPenetration,
    MassTransferFlux,
    NavierSlip,
    PowerLawSlip,
    QVaporFlux,
    RadiativeHeatFlux,
    SlipHeating,
    SpeciesKinematicFlux,
    cap_end_force,
    contact_angle_force,
)
from goma_tpu_torch.bc.traction import (
    CoulombFriction,
    ElecTraction,
    FlowGradV,
    ForceSIC,
    SlopeBC,
)
