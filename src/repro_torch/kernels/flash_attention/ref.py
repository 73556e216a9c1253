"""Plain PyTorch attention: the flash kernel's oracle, its version for CPU
tensors, and the model's prefill attention on the CPU.

``chunked_attention`` is the port of ``repro.models.attention.
chunked_attention`` (the XLA twin the JAX model calls in place of the
Pallas kernel): online softmax over kv chunks with fp32 scores and
statistics, q scaled in the compute dtype before the product, P rounded to
the compute dtype before P.V. It keeps ``softcap`` and ``q_offset``, which
the kernel does not take.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import scalar_as

NEG_INF = -1e30


def chunked_attention(
    q: torch.Tensor,            # [B, Sq, H, Dh]
    k: torch.Tensor,            # [B, Sk, Hk, Dh]
    v: torch.Tensor,            # [B, Sk, Hk, Dh]
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    softcap: float | None = None,
    q_offset: int = 0,          # absolute position of q[0] (prefill continuation)
) -> torch.Tensor:
    """Flash-style attention with O(S·chunk) live memory."""
    B, Sq, H, Dh = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    cdt = q.dtype
    dev = q.device
    scale = scalar_as(1.0 / math.sqrt(Dh), cdt)

    qs = (q * scale).reshape(B, Sq, Hk, G, Dh).permute(0, 2, 3, 1, 4)   # [B,Hk,G,Sq,Dh]
    ks = k.permute(0, 2, 1, 3)                                          # [B,Hk,Sk,Dh]
    vs = v.permute(0, 2, 1, 3)
    out = torch.empty((B, Hk, G, Sq, Dh), dtype=cdt, device=dev)
    for q0 in range(0, Sq, q_chunk):
        qblk = qs[:, :, :, q0:q0 + q_chunk].float()
        qpos = torch.arange(q0, q0 + qblk.shape[3], device=dev) + q_offset
        m = torch.full(qblk.shape[:4], NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qblk.shape, dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, kv_chunk):
            kblk = ks[:, :, k0:k0 + kv_chunk].float()
            vblk = vs[:, :, k0:k0 + kv_chunk].float()
            kpos = torch.arange(k0, k0 + kblk.shape[2], device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk)
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(cdt).float(), vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, q0:q0 + qblk.shape[3]] = (acc / l.clamp_min(1e-30)[..., None]).to(cdt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)
