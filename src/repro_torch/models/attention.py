"""GQA attention: prefill through the flash kernel (CUDA) or its plain
version (CPU), sliding windows, KV caches (full + ring-buffer for local
layers), decode paths. The port of ``src/repro/models/attention.py``.

Where the JAX model calls ``chunked_attention`` (its XLA twin of the
Pallas flash kernel), the port calls ``flash_attention``: the CUDA kernel
for CUDA tensors, ``chunked_attention`` for CPU tensors. Decode attention
was XLA in the JAX package and stays plain PyTorch here.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import scalar_as
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401  (re-export)
    NEG_INF,
    chunked_attention,
)
from repro_torch.models.layers import (
    Layout,
    apply_rope,
    dense_init,
    norm_init,
    qk_head_norm,
)


def decode_attention(
    q: torch.Tensor,            # [B, 1, H, Dh]
    k_cache: torch.Tensor,      # [B, S, Hk, Dh]
    v_cache: torch.Tensor,
    length: torch.Tensor | int, # valid cache length (inclusive of current token)
    *,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Single-token attention against a cache: one matmul pass, fp32
    softmax. Memory-bound by the cache read."""
    B, _, H, Dh = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, Dh) * scalar_as(1.0 / math.sqrt(Dh), q.dtype)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    cur = torch.as_tensor(length, device=q.device).expand(B)[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < cur
    if window is not None:
        valid &= pos > cur - 1 - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p.float(), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def attn_init(gen: torch.Generator, lead: tuple[int, ...], cfg: AttentionConfig, d_model: int,
              layout: Layout) -> dict:
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, lead, d_model, H * Dh, layout),
        "wk": dense_init(gen, lead, d_model, Hk * Dh, layout),
        "wv": dense_init(gen, lead, d_model, Hk * Dh, layout),
        "wo": dense_init(gen, lead, H * Dh, d_model, layout),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(lead, Dh, gen.device)
        p["k_norm"] = norm_init(lead, Dh, gen.device)
    return p


def _project_qkv(p, cfg: AttentionConfig, x, positions, theta, eps):
    B, S, _ = x.shape
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hk, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hk, Dh)
    if cfg.qk_norm:
        q = qk_head_norm(q, p["q_norm"], eps)
        k = qk_head_norm(k, p["k_norm"], eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def self_attention(q, k, v, cfg: AttentionConfig, *, local: bool) -> torch.Tensor:
    """Prefill self-attention over projected q, k, v: [B, S, H*Dh]."""
    out = flash_attention(
        q, k, v,
        causal=cfg.causal,
        window=cfg.sliding_window if local else None,
        softcap=cfg.logit_softcap,
    )
    return out.reshape(q.shape[0], q.shape[1], -1)


def attn_apply(
    p,
    cfg: AttentionConfig,
    x: torch.Tensor,                  # [B, S, D]
    *,
    local: bool,
    eps: float,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Training/prefill self-attention."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    q, k, v = _project_qkv(p, cfg, x, positions, theta, eps)
    return self_attention(q, k, v, cfg, local=local) @ p["wo"]


def attn_decode(
    p,
    cfg: AttentionConfig,
    x: torch.Tensor,                  # [B, 1, D]
    cache_k: torch.Tensor,            # [B, S_cache, Hk, Dh]  (ring if local)
    cache_v: torch.Tensor,
    length: torch.Tensor,             # [B] current position (tokens so far)
    *,
    local: bool,
    eps: float,
) -> torch.Tensor:
    """One decode step: insert the new k/v, attend over the cache.

    The new k/v are written into ``cache_k``/``cache_v`` in place (the JAX
    version returns updated copies; in place saves a cache copy per layer
    and step). Local layers use a ring buffer: slot = length % cache_len.
    Returns out [B, 1, D]."""
    B = x.shape[0]
    theta = cfg.rope_theta_local if local else cfg.rope_theta
    q, k, v = _project_qkv(p, cfg, x, length[:, None], theta, eps)
    S_cache = cache_k.shape[1]
    slot = (length % S_cache if local else length.clamp(max=S_cache - 1)).long()
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    # ring buffer: every live slot is within the window by construction
    mask_len = (length + 1).clamp(max=S_cache) if local else length + 1
    out = decode_attention(q, cache_k, cache_v, mask_len, softcap=cfg.logit_softcap)
    return out.reshape(B, 1, -1) @ p["wo"]


def attn_cache_shape(cfg: AttentionConfig, batch: int, seq_len: int, local: bool,
                     dtype) -> tuple[tuple, torch.dtype]:
    S = min(cfg.sliding_window, seq_len) if (local and cfg.sliding_window) else seq_len
    return (batch, S, cfg.num_kv_heads, cfg.head_dim), dtype
