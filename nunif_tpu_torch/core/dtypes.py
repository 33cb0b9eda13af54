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


def cast_param(p: torch.Tensor, dtype: torch.dtype,
               memory_format=None) -> torch.Tensor:
    """``p`` in ``dtype``, as a flax layer casts its fp32 params to the
    compute dtype; with ``memory_format`` also in that layout (a conv
    weight in ``torch.channels_last``, so that cuDNN does not relayout it
    on every call).  Outside autograd the cast is made once per weight load
    (cached on the parameter, keyed by its storage and version), not on
    every call.  Under ``torch.export`` the cast is traced, not cached."""
    if p.dtype == dtype and (memory_format is None
                             or p.is_contiguous(memory_format=memory_format)):
        return p
    if (torch.is_grad_enabled() and p.requires_grad) \
            or torch.compiler.is_compiling():
        p = p.to(dtype)
        return p if memory_format is None else p.contiguous(
            memory_format=memory_format)
    key = (dtype, memory_format, p.data_ptr(), p.device, p._version)
    cached = getattr(p, "_nunif_cast", None)
    if cached is None or cached[0] != key:
        q = p.detach().to(dtype)
        if memory_format is not None:
            q = q.contiguous(memory_format=memory_format)
        cached = (key, q)
        p._nunif_cast = cached
    return cached[1]


# iw3 reads images in this dtype for the stereo warp and the half-SBS /
# half-TB downscale, where the JAX package hard-codes ``jnp.bfloat16``
# (``grid_sample.py:189,249``, ``composition.py:109,117``).  K3 reads only
# bf16.  Read at call time, so a parity test can set it to fp32.
IMAGE_DTYPE = torch.bfloat16

BF16_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
DEFAULT_POLICY = BF16_POLICY
