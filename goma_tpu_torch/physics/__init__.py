from goma_tpu_torch.physics.fluid import Continuity, Momentum, SwirlMomentum
from goma_tpu_torch.physics.scalar_transport import (BondEvolution, Energy,
                                                     LightIntensity,
                                                     ResidenceTime, Species)
from goma_tpu_torch.physics.species_flux import (
    GeneralizedFickianSpecies,
    HydroSpecies,
    StefanMaxwellSpecies,
)
from goma_tpu_torch.physics import materials
from goma_tpu_torch.physics.mesh_motion import (EllipticMesh, LinearElasticMesh,
                                                PseudoSolidMesh)
from goma_tpu_torch.physics.solid import (RealSolid, SolidKinematics,
                                          SolidTraction, tie_mesh_to_solid)
from goma_tpu_torch.physics.porous import (PorousFlow, TanhHystSaturation,
                                           TwoPhasePorous, VanGenuchten)
from goma_tpu_torch.physics.viscoelastic import (AxisymHoopStress,
                                                 DGStressInflow, DGStressUpwind,
                                                 LogConformationStress,
                                                 SqrtConformationStress,
                                                 VelocityGradientProjection,
                                                 VEStress, stress_var)
from goma_tpu_torch.physics.normal_mode import (
    NormalModeContinuity,
    NormalModeEnergy,
    NormalModeMomentum,
    NormalModeW,
)
from goma_tpu_torch.physics.normal_mode_ale import (
    CapillaryZNormal,
    ContinuityZ,
    MeshZ,
    MomentumZ,
    ScalarZ,
    WMomentum,
    embed_state,
    zmode_equations,
)
from goma_tpu_torch.physics.level_set import (
    CSFSurfaceTension,
    ExtensionVelocity,
    FillEquation,
    FillExtV,
    LevelSetProperty,
    LSExtVKinematic,
    LSExtVLatent,
    SolvedNormal,
    LSEmbeddedDirichlet,
    LSEmbeddedFlux,
    LSFlowPressure,
    LSRecoilPressure,
    delta,
    heaviside,
    kanouff_recoil,
    qrad_flux,
    renormalize,
    renormalize_mass,
    XFEMPressureContinuity,
    XFEMPressureMomentum,
    sharp_heaviside,
)
from goma_tpu_torch.physics.acoustic import (AcousticHelmholtz,
                                             ProjectionEquation, SommerfeldBC)
from goma_tpu_torch.physics.electro import (ButlerVolmerBC, HORFlux, ORRFlux,
                                            Potential)
from goma_tpu_torch.physics.interface import InterfaceExchange
from goma_tpu_torch.physics.em import (EMAbsorbingBC, EMAbsorbingBCH, EMWave,
                                       EMWaveEdge, EMWaveH)
from goma_tpu_torch.physics.overset import OversetLM, OversetNoSlip
from goma_tpu_torch.physics.lubrication import (LubricationCurvature,
                                                ReynoldsFilm,
                                                ReynoldsFilmPowerLaw)
from goma_tpu_torch.physics.shell import (ShellAngle, ShellConduction,
                                          ShellCoordinates, ShellCurvaturePair,
                                          ShellDiffKinematic,
                                          ShellDiffusionFlux, ShellNormal,
                                          ShellSurfCurv, SurfaceCharge,
                                          TensionedString, attach_shell_block,
                                          tie_fluid_shell)
from goma_tpu_torch.physics.shell_film import (FilmHeight, FilmParticles,
                                               FilmPressure, ShellEnergy,
                                               ShellSpecies)
from goma_tpu_torch.physics.shell_porous import (LubPorousSink,
                                                 PorousShellClosed,
                                                 PorousShellGasN,
                                                 PorousShellOpen,
                                                 PorousShellStackLayer)
from goma_tpu_torch.physics.suspension import (
    ParticleMomentum,
    QTensorHydroSpecies,
    VorticityDirection,
    flow_frame_qtensor,
    particle_drag_force,
    qtensor_from_vort_dir,
)
from goma_tpu_torch.physics.turbulence import (SATurbulentViscosity,
                                               SpalartAllmaras, wall_distance)
from goma_tpu_torch.physics.population import MomentEquations, wheeler_n2
from goma_tpu_torch.physics.kinetics import ReactionNetwork
from goma_tpu_torch.physics.placid import (SurfaceMechanism, placid,
                                           surface_kinetics_flux)
