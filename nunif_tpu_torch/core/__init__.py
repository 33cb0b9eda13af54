from .dtypes import Policy, BF16_POLICY, FP32_POLICY, DEFAULT_POLICY
from .device import resolve_device

__all__ = ["Policy", "BF16_POLICY", "FP32_POLICY", "DEFAULT_POLICY",
           "resolve_device"]
