from goma_tpu_torch.physics.fluid import Continuity, Momentum
from goma_tpu_torch.physics.scalar_transport import Energy, Species
from goma_tpu_torch.physics import materials
from goma_tpu_torch.physics.viscoelastic import (AxisymHoopStress,
                                                 DGStressInflow, DGStressUpwind,
                                                 LogConformationStress,
                                                 SqrtConformationStress,
                                                 VelocityGradientProjection,
                                                 VEStress)
