"""Plain PyTorch RMSNorm: the kernel's oracle and its version for CPU
tensors (the port's copy of ``repro.models.layers.rms_norm``)."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
