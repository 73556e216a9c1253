"""Core layer primitives: norms, rotary embeddings, GLU MLPs, embeddings.

The port of ``src/repro/models/layers.py``. Parameters are plain tensors in
nested dicts with the JAX param tree's names; every init takes an explicit
``torch.Generator`` and a ``lead`` shape that stacked periods prepend.

Numerics policy: params/activations bf16; RMSNorm statistics, softmax and
final logits in fp32. ``rms_norm`` is the rmsnorm CUDA kernel on a CUDA
tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm


def to_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Dtype bundle threaded through model construction."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    @classmethod
    def from_config(cls, cfg) -> "Layout":
        return cls(to_dtype(cfg.param_dtype), to_dtype(cfg.compute_dtype))


# ------------------------------------------------------------------ inits
def dense_init(gen: torch.Generator, lead: tuple[int, ...], in_dim: int, out_dim: int,
               layout: Layout, scale: float | None = None) -> torch.Tensor:
    """Dense kernel [*lead, in, out] with truncated-normal fan-in init."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.empty((*lead, in_dim, out_dim), device=gen.device)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return w.mul_(std).to(layout.param_dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, layout: Layout) -> torch.Tensor:
    # unit-RMS after the sqrt(d_model) embed scaling in the model
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(dim)).to(layout.param_dtype)


def norm_init(lead: tuple[int, ...], dim: int, device: torch.device) -> torch.Tensor:
    # norm scales stay fp32 — they are tiny and numerically sensitive
    return torch.ones((*lead, dim), dtype=torch.float32, device=device)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm(x, scale, eps)


def qk_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the head dim (qwen3/gemma3-style qk-norm)."""
    return rmsnorm(x, scale, eps)


# ------------------------------------------------------------------ rotary
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (int). Rotates interleaved
    pairs (x[..., 0::2], x[..., 1::2]) of the last dim, fp32 trig."""
    dt = x.dtype
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [Dh/2]
    ang = positions[..., :, None].float() * freqs             # [..., S, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]                     # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(dt)


# ------------------------------------------------------------------ acts
def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


# ------------------------------------------------------------------ MLP
def mlp_init(gen: torch.Generator, lead: tuple[int, ...], d_model: int, d_ff: int,
             layout: Layout) -> dict:
    return {
        "wi": dense_init(gen, lead, d_model, d_ff, layout),
        "wg": dense_init(gen, lead, d_model, d_ff, layout),
        "wo": dense_init(gen, lead, d_ff, d_model, layout),
    }


def mlp_apply(p: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    """SwiGLU/GeGLU MLP."""
    act = activation(act_name)
    h = act(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


# ------------------------------------------------------------------ logits
def unembed_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """fp32 logits; `table` may be the (tied) embedding [V, D] or an
    untied head stored as [D, V]."""
    if table.shape[0] == x.shape[-1]:
        return x.float() @ table.float()
    return x.float() @ table.float().T
