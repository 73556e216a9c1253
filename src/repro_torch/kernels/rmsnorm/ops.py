"""RMSNorm wrapper: the CUDA kernel for a CUDA tensor, the plain version for
a CPU tensor.

Kernel source: ``repro_torch/csrc/rmsnorm.cu`` (replaces the Pallas kernel
``src/repro/kernels/rmsnorm/kernel.py``). ``rmsnorm.launches`` counts the
kernel's launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    p = ctypes.c_void_p
    return _build.entry(
        "rmsnorm_forward",
        [p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int, p],
    )


def check_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x, got {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes a float32 scale, got {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} does not match last dim {D}")
    if (D * x.element_size()) % 16:
        raise ValueError(f"rmsnorm kernel needs the last dim in whole 16-byte vectors, got {D}")
    if x.device != scale.device:
        raise ValueError(f"x on {x.device} but scale on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rmsnorm kernel needs 16-byte aligned x and scale")
    if x.numel() // D >= 2**31:
        raise ValueError("rmsnorm kernel takes fewer than 2**31 rows")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale over the last dim, fp32 statistics,
    output in x's dtype. x: [..., D] float32/bfloat16; scale: [D] float32."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda tensors, got {x.device}")
    check_inputs(x, scale)
    out = torch.empty_like(x)
    D = x.shape[-1]
    code = _kernel()(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // D, D, eps,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
