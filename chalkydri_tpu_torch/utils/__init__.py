"""Shared helpers: the float32 precision policy."""

from chalkydri_tpu_torch.utils.precision import full_fp32  # noqa: F401
