from goma_tpu_torch.solvers.linear import (BlockJacobi, LinearResult, bicgstab,
                                           direct_solve_host, gmres,
                                           identity_precond)
from goma_tpu_torch.solvers.newton import NewtonOptions, NewtonResult, NewtonSolver
from goma_tpu_torch.solvers.projection import ProjectionResult, ProjectionSolver
