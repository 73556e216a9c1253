"""Hand-written CUDA kernels and their plain PyTorch versions."""

from __future__ import annotations

import torch


def scalar_as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``. JAX rounds a Python scalar to the
    array's dtype before it multiplies (weak typing); PyTorch multiplies in
    fp32, so the JAX package's ``x * scalar`` is ``x * scalar_as(...)``."""
    return torch.tensor(value, dtype=dtype).item()
