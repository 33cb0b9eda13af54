"""PyTorch/CUDA port of nunif_tpu for one NVIDIA H100.

Mirrors ``nunif_tpu``'s module paths; imports ``torch`` and never JAX.
Kernels written by hand for Hopper live in ``csrc/`` and are built at first
use by ``ops/_build.py``.
"""
# importing the policy turns TF32 off for every entry into the package
from .core import dtypes as _dtypes  # noqa: F401
