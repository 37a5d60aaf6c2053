"""Precision policy.

Counterpart of `feast_tpu/config.py`.  The JAX package backs its complex
pairs with float64 only after `jax_enable_x64`; torch has native complex128
and float64 at all times, and the port's drivers run their outer math in
complex128 (complex64 for the mixed-precision solves), so there is nothing
to switch.
"""

from __future__ import annotations

import torch


def enable_x64():
    """A no-op: float64 is always available in torch (kept for the JAX
    package's API)."""


def default_rdtype() -> torch.dtype:
    """Real dtype of the drivers' outer math: float64."""
    return torch.float64


def eps(dtype) -> float:
    """Machine epsilon of a real or complex torch dtype."""
    from .cx import real_dtype

    dtype = real_dtype(dtype) if dtype.is_complex else dtype
    return float(torch.finfo(dtype).eps)
