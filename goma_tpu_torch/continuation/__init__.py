from goma_tpu_torch.continuation.conti import (
    ArcStep,
    ContinuationStep,
    arclength_continue,
    continue_problem,
)
from goma_tpu_torch.continuation.augmenting import (
    AugmentedNewtonSolver,
    AugmentedResult,
    AugmentingCondition,
)
from goma_tpu_torch.continuation.stability import (
    StabilityResult, mass_and_jacobian, solve_stability,
    solve_stability_3d_of_2d, solve_stability_3d_of_2d_ale)
from goma_tpu_torch.continuation.hunting import HuntSpec, detect_folds, hunt_problem
from goma_tpu_torch.continuation.bifurcation import FoldResult, fold_track
