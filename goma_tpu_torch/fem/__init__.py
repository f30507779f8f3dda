from goma_tpu_torch.fem.assembly import Problem
from goma_tpu_torch.fem.dofmap import DofMap, build_dofmap
from goma_tpu_torch.fem.equations import Equation, FaceKernel, SurfaceVars
from goma_tpu_torch.fem.fields import FieldVars
from goma_tpu_torch.fem.sparsity import build_pattern
