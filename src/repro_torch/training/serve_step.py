"""Serving: prefill + decode steps and a batched greedy/sampling loop.

The port of ``src/repro/training/serve_step.py``. ``make_serve_fns``
returns (prefill_fn, decode_fn) bound to a model; ``generate`` drives them.
Greedy decoding is exact; sampling draws from an explicit
``torch.Generator`` and cannot reproduce ``jax.random`` draws.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import LM


def make_serve_fns(model: LM, cache_len: int):
    def prefill_fn(tokens):
        return model.prefill(tokens, cache_len)

    def decode_fn(token, caches, lengths):
        return model.decode_step(token, caches, lengths)

    return prefill_fn, decode_fn


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """[B, V] logits -> [B] int32 tokens: argmax at temperature 0, else a
    draw from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.inference_mode()
def generate(
    model: LM,
    prompt: torch.Tensor,            # [B, S] int
    max_new_tokens: int,
    *,
    cache_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Batched autoregressive generation. Returns [B, max_new_tokens] int32."""
    S = prompt.shape[1]
    prefill_fn, decode_fn = make_serve_fns(model, cache_len or (S + max_new_tokens))
    logits, caches, lengths = prefill_fn(prompt)
    tok = sample_token(logits, temperature, generator)[:, None]
    outs = [tok]
    for _ in range(max_new_tokens - 1):
        logits, caches = decode_fn(tok, caches, lengths)
        lengths = lengths + 1
        tok = sample_token(logits, temperature, generator)[:, None]
        outs.append(tok)
    return torch.cat(outs, dim=1)
