"""Flash-attention wrapper: the CUDA kernel for CUDA tensors, the plain
version (``chunked_attention``) for CPU tensors.

Kernel source: ``repro_torch/csrc/flash_attention.cu`` (replaces the Pallas
kernel ``src/repro/kernels/flash_attention/kernel.py``). Unlike the JAX
wrapper, no transpose is made: the kernel reads the model's [B, S, H, Dh]
layout. ``flash_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, scalar_as
from repro_torch.kernels.flash_attention.ref import chunked_attention

HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(
        "flash_attention_forward",
        [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, p],
    )


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int | None) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,Dh] and k, v [B,Sk,Hk,Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Bk, Sk, Hk, Dhk = k.shape
    if Bk != B or Dhk != Dh or Hk == 0 or H % Hk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit "
                         "(GQA needs H % Hk == 0)")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {Dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one dtype of {_DTYPES}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    if Sk == 0:
        raise ValueError("flash kernel needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if B > 65535 or H > 65535 or max(B * Sq * H * Dh, B * Sk * Hk * Dh) >= 2**31:
        raise ValueError(f"shape too large for the flash kernel's grid: {tuple(q.shape)}")


def flash_attention(
    q: torch.Tensor,           # [B, Sq, H, Dh]  (model layout)
    k: torch.Tensor,           # [B, Sk, Hk, Dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Forward attention with GQA (kv head = h // (H // Hk)), causal and
    sliding-window masks. Returns [B, Sq, H, Dh] in q's dtype.

    ``softcap`` and ``q_offset`` are taken on the CPU only: the kernel has
    neither, and a CUDA call that passes one raises."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    if softcap is not None:
        raise NotImplementedError("the flash kernel has no logit softcap")
    if q_offset:
        raise NotImplementedError("the flash kernel has no q_offset")
    check_inputs(q, k, v, window)
    B, Sq, H, Dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    code = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hk, Dh, scalar_as(1.0 / math.sqrt(Dh), q.dtype),
        int(causal), window or 0, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
