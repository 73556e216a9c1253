"""Batched serving entry point: prefill + decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-3-2b --no-reduce --batch 4 --prompt-len 512 --new-tokens 32

The port of ``src/repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``; asking for ``cuda`` without a card
raises). ``--reduce`` defaults on as in the reference, and ``--no-reduce``
serves the full config, which the reference's ``store_true`` flag with
``default=True`` cannot. The reduced configs have head_dim 16, which the
flash kernel does not take, so on CUDA the entry point refuses them and
asks for ``--no-reduce``. Weights and prompts come from seeded
``torch.Generator``s. Reports per-phase latency and tokens/s, and returns
the reference's dict plus the launches of each kernel during the run.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.archs import reduced
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.transformer import LM
from repro_torch.training.serve_step import make_serve_fns, sample_token

KERNELS = {"rmsnorm": rmsnorm, "flash_attention": flash_attention}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def _check_head_dim(cfg, device: torch.device, reduce: bool) -> None:
    """Refuse, before building the model, a config whose head_dim the flash
    kernel does not take when serving on CUDA."""
    if device.type != "cuda" or cfg.attention is None or cfg.attention.head_dim in HEAD_DIMS:
        return
    fix = " (the reduced config; pass --no-reduce)" if reduce else ""
    raise ValueError(f"--device {device}: the flash kernel takes head_dim in {HEAD_DIMS}, "
                     f"{cfg.name} has head_dim {cfg.attention.head_dim}{fix}")


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (head_dim 16, CPU only); "
                         "--no-reduce serves the full one, as CUDA needs")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; needs --no-reduce) or cpu (the plain versions)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    device = _device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    _check_head_dim(cfg, device, args.reduce)
    log = (lambda *a: None) if args.quiet else (lambda *a: print(*a, flush=True))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model = LM(cfg, device=device, seed=0)
    B, S = args.batch, args.prompt_len
    cache_len = S + args.new_tokens
    prompt = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(device)
    sampler = torch.Generator(device=device).manual_seed(2)
    prefill_fn, decode_fn = make_serve_fns(model, cache_len)
    launches0 = {name: fn.launches for name, fn in KERNELS.items()}

    sync()
    t0 = time.perf_counter()
    logits, caches, lengths = prefill_fn(prompt)
    sync()
    t_prefill = time.perf_counter() - t0
    log(f"[prefill] {B}x{S} tokens in {t_prefill:.2f}s "
        f"({B * S / t_prefill:,.0f} tok/s)")

    tok = sample_token(logits, args.temperature, sampler)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        logits, caches = decode_fn(tok, caches, lengths)
        lengths = lengths + 1
        tok = sample_token(logits, args.temperature, sampler)[:, None]
        outs.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    steps = args.new_tokens - 1   # the first new token came from the prefill
    log(f"[decode] {steps} steps x {B} seqs in {t_decode:.2f}s "
        f"({B * steps / max(t_decode, 1e-9):,.0f} tok/s)")
    seqs = torch.cat(outs, dim=1)
    log(f"[out] tokens[0,:8] = {seqs[0, :8].tolist()}")
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens": seqs,
        "launches": {name: fn.launches - launches0[name] for name, fn in KERNELS.items()},
    }


if __name__ == "__main__":
    main()
