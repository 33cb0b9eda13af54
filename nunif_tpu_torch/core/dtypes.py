"""Mixed-precision policy (counterpart of ``nunif_tpu/core/dtypes.py``):
params fp32, compute bf16, blend and accumulate fp32.

Importing this module also turns TF32 off for matmuls and cuDNN
convolutions: cuDNN allows TF32 by default, which rounds fp32 inputs to a
10-bit mantissa, so "fp32" would silently mean something else on the card
than on the CPU.
"""
import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


BF16_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
DEFAULT_POLICY = BF16_POLICY
