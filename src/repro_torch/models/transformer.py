"""Model assembly: the dense slice of ``repro.models.transformer.LM``.

A config's layer stack is ``pattern * n_periods + remainder``. Parameters
keep the JAX param tree's layout: each pattern position's params are
stacked with a leading ``n_periods`` dim, and ``LM.state_dict()`` keys are
the JAX tree paths joined by ``.`` (e.g. ``stack.pat0.mixer.wq``). The
``lax.scan`` over periods becomes a Python loop over that leading dim.

This slice runs the ``attn`` and ``local`` mixers and the ``mlp`` ffn.
The other sublayer kinds, the encoder-decoder and the stub frontends
raise ``NotImplementedError`` naming the slice that ports them.

Entry points: ``forward`` (the JAX ``apply``: final hidden states),
``logits``, ``prefill`` (last-position logits + caches) and
``decode_step`` (one token with caches, updated in place).
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import scalar_as
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Layout,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    norm_init,
    rms_norm,
    to_dtype,
    unembed_logits,
)

_LATER_SLICES = {
    "mamba": "the jamba slice (ssm_scan kernel)",
    "rwkv": "the rwkv6 slice (wkv6 kernel)",
    "attnx": "the whisper slice (encoder-decoder)",
    "moe": "the MoE slice",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    for entry in cfg.pattern:
        for kind in entry.split(":"):
            if kind in _LATER_SLICES:
                raise NotImplementedError(
                    f"{cfg.name}: {kind!r} sublayers are ported in {_LATER_SLICES[kind]}"
                )
    if cfg.encdec is not None:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder is ported in the whisper slice")
    if cfg.frontend_tokens:
        raise NotImplementedError(f"{cfg.name}: stub frontend embeddings are ported in the phi-3 slice")


# ============================================================== sublayers
def _entry_init(gen: torch.Generator, lead: tuple[int, ...], cfg: ModelConfig,
                layout: Layout) -> dict:
    return {
        "norm1": norm_init(lead, cfg.d_model, gen.device),
        "norm2": norm_init(lead, cfg.d_model, gen.device),
        "mixer": attn.attn_init(gen, lead, cfg.attention, cfg.d_model, layout),
        "ffn": mlp_init(gen, lead, cfg.d_model, cfg.d_ff, layout),
    }


def _entry_apply(p, entry: str, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """Pre-LN residual block."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.attn_apply(
        p["mixer"], cfg.attention, h,
        local=entry.startswith("local:"), eps=cfg.norm_eps, positions=positions,
    )
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.act)


def _entry_prefill(p, entry: str, cfg: ModelConfig, x, positions, cache: dict,
                   cache_len: int) -> torch.Tensor:
    """Like _entry_apply, and writes this entry's k/v into ``cache``."""
    a = cfg.attention
    local = entry.startswith("local:")
    S = x.shape[1]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    theta = a.rope_theta_local if local else a.rope_theta
    q, k, v = attn._project_qkv(p["mixer"], a, h, positions, theta, cfg.norm_eps)
    x = x + attn.self_attention(q, k, v, a, local=local) @ p["mixer"]["wo"]
    if local and a.sliding_window and a.sliding_window < cache_len:
        W = a.sliding_window
        take = min(W, S)
        idx = torch.arange(S - take, S, device=x.device) % W
        cache["k"][:, idx] = k[:, S - take:]
        cache["v"][:, idx] = v[:, S - take:]
    else:
        if S > cache_len:
            raise ValueError(f"prompt of {S} tokens does not fit a cache of {cache_len}")
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.act)


def _entry_decode(p, entry: str, cfg: ModelConfig, x, cache: dict, lengths) -> torch.Tensor:
    """One-token step. x: [B, 1, D]; ``cache`` is updated in place."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.attn_decode(
        p["mixer"], cfg.attention, h, cache["k"], cache["v"], lengths,
        local=entry.startswith("local:"), eps=cfg.norm_eps,
    )
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["ffn"], h, cfg.act)


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _vocab_pad_mask(cfg: ModelConfig, device) -> torch.Tensor:
    """-1e30 additive mask over padded vocab rows (0 where real)."""
    pos = torch.arange(cfg.vocab_padded, device=device)
    return torch.where(pos >= cfg.vocab_size, -1e30, 0.0).float()


# ============================================================== the model
class ParamTree(nn.Module):
    """A nested dict of tensors held as (frozen) parameters: tensors become
    parameters and dicts become sub-modules, so ``state_dict()`` keys are
    the dict paths joined by ``.``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        """The parameters as the nested dict the functions below take."""
        out: dict[str, Any] = dict(self._parameters)
        out.update((name, m.tree()) for name, m in self._modules.items())
        return out


class LM(ParamTree):
    """Decoder-only language model (dense slice) on an explicit device.

    Weights are drawn from ``torch.Generator(device).manual_seed(seed)``;
    ``load_state_dict`` takes weights converted from the JAX package
    (``repro_torch.convert.params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        check_supported(cfg)
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        layout = Layout.from_config(cfg)
        p: dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, layout)}
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(gen, (), cfg.d_model, cfg.vocab_padded, layout)
        p["final_norm"] = norm_init((), cfg.d_model, gen.device)
        if cfg.n_periods > 0:
            p["stack"] = {
                f"pat{pos}": _entry_init(gen, (cfg.n_periods,), cfg, layout)
                for pos in range(len(cfg.pattern))
            }
        for i in range(len(cfg.remainder)):
            p[f"rem{i}"] = _entry_init(gen, (), cfg, layout)
        super().__init__(p)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _sublayers(self, caches: dict | None = None) -> Iterator[tuple[dict, str, dict | None]]:
        """(params, entry, cache) of every sublayer in stack order; a
        period's params and cache are views into the stacked tensors."""
        cfg, p = self.cfg, self.tree()
        for i in range(cfg.n_periods):
            for pos, entry in enumerate(cfg.pattern):
                name = f"pat{pos}"
                cache = None if caches is None else _index(caches["stack"][name], i)
                yield _index(p["stack"][name], i), entry, cache
        for i, entry in enumerate(cfg.remainder):
            yield p[f"rem{i}"], entry, None if caches is None else caches[f"rem{i}"]

    # ---------------------------------------------------------- forward
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        cdt = to_dtype(self.cfg.compute_dtype)
        x = F.embedding(tokens, self.embed).to(cdt)
        return x * scalar_as(math.sqrt(self.cfg.d_model), cdt)

    def backbone(self, x: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
        """Residual stream through the full layer stack. x: [B, S, D].
        Returns the final hidden states (the JAX version also returns the
        MoE aux loss, which comes with the MoE slice)."""
        if positions is None:
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
        for p, entry, _ in self._sublayers():
            x = _entry_apply(p, entry, self.cfg, x, positions)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        """Full forward returning the final hidden states: the JAX ``LM.apply``."""
        return self.backbone(self.embed_tokens(tokens), positions=positions)

    def unembed_table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return unembed_logits(hidden, self.unembed_table()) + _vocab_pad_mask(self.cfg, hidden.device)

    # ---------------------------------------------------------- caches
    def init_caches(self, batch: int, cache_len: int, dtype: torch.dtype) -> dict:
        cfg, dev = self.cfg, self.device

        def one(entry: str, lead: tuple[int, ...]) -> dict:
            shape, dt = attn.attn_cache_shape(
                cfg.attention, batch, cache_len, entry.startswith("local:"), dtype
            )
            return {n: torch.zeros((*lead, *shape), dtype=dt, device=dev) for n in ("k", "v")}

        caches: dict[str, Any] = {}
        if cfg.n_periods > 0:
            caches["stack"] = {
                f"pat{pos}": one(entry, (cfg.n_periods,)) for pos, entry in enumerate(cfg.pattern)
            }
        for i, entry in enumerate(cfg.remainder):
            caches[f"rem{i}"] = one(entry, ())
        return caches

    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Forward pass that also builds decode caches. Returns
        (last-position logits [B, V], caches, n_prefilled [B])."""
        x = self.embed_tokens(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        caches = self.init_caches(B, cache_len, x.dtype)
        for p, entry, cache in self._sublayers(caches):
            x = _entry_prefill(p, entry, self.cfg, x, positions, cache, cache_len)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = self.logits(x[:, -1:])[:, 0]
        return logits, caches, torch.full((B,), S, dtype=torch.int32, device=x.device)

    def decode_step(self, token: torch.Tensor, caches: dict, lengths: torch.Tensor):
        """token: [B, 1] int; lengths: [B] tokens already in cache.
        Writes the token's k/v into ``caches`` in place. Returns
        (logits [B, V] fp32, caches)."""
        x = self.embed_tokens(token)
        for p, entry, cache in self._sublayers(caches):
            x = _entry_decode(p, entry, self.cfg, x, cache, lengths)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.logits(x)[:, 0], caches
