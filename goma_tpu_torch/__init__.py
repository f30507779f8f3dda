"""goma_tpu_torch — the PyTorch/CUDA port of goma_tpu.

It mirrors goma_tpu's module layout and names, so each module's counterpart
is found under the same path; ``goma_tpu/`` stays the reference it is held
against. The package imports torch, numpy and scipy, never jax. Its
hand-written device kernels (``csrc/``: the nested-dissection front LU,
front substitution and front gather) target Hopper (sm_90a); every kernel
has a plain PyTorch twin that runs for CPU tensors.

Numerics: every factor, Schur update and element product must run in full
float32/float64. goma_tpu pins them to exact f32 because bf16-rounded dots
made a deck diverge; TF32 is the same hazard on the GPU, so it is switched
off here and the float32 matmul precision must stay "highest".
"""

import torch

from goma_tpu_torch import config as config
from goma_tpu_torch.config import fp_dtype, resolve_device, set_fp_dtype

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.get_float32_matmul_precision() != "highest":
    raise RuntimeError(
        "goma_tpu_torch needs torch.get_float32_matmul_precision() == "
        f"'highest', found {torch.get_float32_matmul_precision()!r}")
