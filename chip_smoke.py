"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card's name and power limit, and the toolchain;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes granite-3-2b's serving path gives it;
  4. each kernel's device time (torch.profiler) beside its plain version's,
     one PyTorch library call's (a yardstick only: the port never calls it)
     and its bound;
  5. serve granite-3-2b at full width through ``repro_torch.launch.serve``
     with the launch counts set to 0 just before and read just after; then
     trace a prefill and decode steps of the same model (wall time, device
     busy time and idle share, top kernels);
  6. a two-layer model at granite's full widths, fp32, prefill + 8 greedy
     decode steps on the card (kernels) and on the CPU (plain versions);
  7. one JSON line describing every kernel, then the result line
     ``{"ok": true, "device": {...}}`` last.

It exits non-zero at once when no CUDA device is available, and when it is
run outside a checkout of the repository (the port is not importable).
"""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

GRANITE = dict(B=4, S=512, H=32, Hk=8, Dh=64, D=2048, layers=40, new_tokens=32)
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # those of tests/test_kernels.py
L2_COPIES = 4   # timed calls cycle over this many input copies: more than the 50 MB L2
MODEL_FP32_ATOL = 1e-3   # fp32 logits, card vs CPU: sums over up to 8192 terms in other orders


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cycling(fn, arg_sets: list[tuple]):
    """A call of ``fn`` on the next of ``arg_sets``: copies of the inputs
    whose total exceeds the L2, so each call reads its inputs from device
    memory, as the bound assumes."""
    sets = itertools.cycle(arg_sets)
    return lambda: fn(*next(sets))


def kernel_times(fn, iters: int) -> tuple[float, list]:
    """Device time of the kernels ``fn`` launches, per call, from a
    torch.profiler (CUPTI) trace of ``iters`` calls; and the top kernels."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / iters, e.count // iters)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    require(total > 0, "the profiler saw no device time")
    return total, rows


def device_ms(fn, iters: int = 48, warmup: int = 4) -> float:
    """Device time of one call: its kernels' own time, without host gaps."""
    for _ in range(warmup):
        fn()
    return kernel_times(fn, iters)[0]


def trace(fn, iters: int) -> dict:
    """Wall time of one call (host clock, ending in a synchronize), its
    device busy time, the idle share, and where the device time goes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    busy_ms, rows = kernel_times(fn, iters)
    top = [{"kernel": k[:90], "ms": ms, "per_call": n} for k, ms, n in rows[:8]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms), "top_kernels": top}


def compare(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float, **shape) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    bad = int((err > tol + tol * ref.float().abs()).sum())
    max_err = float(err.max())
    emit({"check": name, **shape, "max_abs_err": max_err, "tol": tol, "n_over_tol": bad})
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{name}: shape or dtype differs")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    require(bad == 0, f"{name}: {bad} values over tolerance {tol} (max err {max_err})")
    return max_err


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave: the work this input needs."""
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    return int(keep.sum())


def bound(nbytes: int, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.launch import serve
    from repro_torch.models.transformer import LM

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32 (phase 6)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "toolchain", "python": sys.version.split()[0], "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc,
          "capability": list(torch.cuda.get_device_capability(dev)),
          "device": torch.cuda.get_device_name(dev)})

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib.name})
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[ptxas]", line.strip(), flush=True)

    # ---------------------------------------------------------------- 3
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, Hk, Dh, D = (GRANITE[k] for k in ("B", "S", "H", "Hk", "Dh", "D"))
    eps = get_config("granite-3-2b").norm_eps
    scale = torch.randn(D, generator=g, device=dev) * 0.1 + 1.0
    x_prefill = torch.randn(B * S, D, generator=g, device=dev).bfloat16()
    x_decode = torch.randn(B, D, generator=g, device=dev).bfloat16()
    err = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for x in (x_prefill, x_decode):
        e = compare("rmsnorm", rmsnorm(x, scale, eps), rmsnorm_ref(x, scale, eps),
                    TOL[x.dtype], shape=list(x.shape), dtype=str(x.dtype))
        err["rmsnorm"] = max(err["rmsnorm"], e)

    def qkv(Sq, dtype):
        return [torch.randn(B, Sq, h, Dh, generator=g, device=dev).to(dtype) for h in (H, Hk, Hk)]

    main_qkv = qkv(S, torch.bfloat16)
    for (q, k, v), window in ((main_qkv, None), (qkv(200, torch.bfloat16), None),
                              (qkv(S, torch.bfloat16), 64), (qkv(S, torch.float32), None)):
        e = compare("flash_attention", flash_attention(q, k, v, causal=True, window=window),
                    chunked_attention(q, k, v, causal=True, window=window), TOL[q.dtype],
                    shape=list(q.shape), kv_heads=Hk, causal=True, window=window,
                    dtype=str(q.dtype))
        if q.dtype == torch.bfloat16:
            err["flash_attention"] = max(err["flash_attention"], e)

    # ---------------------------------------------------------------- 4
    timing = {}
    for label, x in (("prefill", x_prefill), ("decode", x_decode)):
        nbytes = 2 * x.numel() * x.element_size() + scale.numel() * 4
        bound_ms, bound_by = bound(nbytes, 4.0 * x.numel(), torch.float32)
        xs = [(x.clone(),) for _ in range(L2_COPIES)]
        timing[("rmsnorm", label)] = {
            "ms": device_ms(cycling(lambda t: rmsnorm(t, scale, eps), xs)),
            "plain_ms": device_ms(cycling(lambda t: rmsnorm_ref(t, scale, eps), xs)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(cycling(
                lambda t: F.rms_norm(t, (D,), scale.to(t.dtype), eps), xs)),
        }
        emit({"timing": "rmsnorm", "rows": x.shape[0], "dim": D, "dtype": "bfloat16",
              **timing[("rmsnorm", label)]})
        del xs
    q, k, v = main_qkv
    pairs = B * H * attention_pairs(S, S, True, None)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bound_ms, bound_by = bound(nbytes, 4.0 * Dh * pairs, torch.bfloat16)
    qkvs = [tuple(t.clone() for t in (q, k, v)) for _ in range(L2_COPIES)]
    sdpa_in = [tuple(t.transpose(1, 2) for t in s) for s in qkvs]   # [B, H, S, Dh] views
    timing[("flash_attention", "prefill")] = {
        "ms": device_ms(cycling(lambda *a: flash_attention(*a, causal=True), qkvs)),
        "plain_ms": device_ms(cycling(lambda *a: chunked_attention(*a, causal=True), qkvs),
                              iters=12),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": device_ms(cycling(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True), sdpa_in)),
    }
    emit({"timing": "flash_attention", "shape": list(q.shape), "kv_heads": Hk, "causal": True,
          "dtype": "bfloat16", "gflop": 4.0 * Dh * pairs / 1e9, "mbytes": nbytes / 1e6,
          **timing[("flash_attention", "prefill")]})
    del qkvs, sdpa_in

    # ---------------------------------------------------------------- 5
    argv = ["--arch", "granite-3-2b", "--no-reduce", "--batch", str(B), "--prompt-len", str(S),
            "--new-tokens", str(GRANITE["new_tokens"]), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats(dev)
    rmsnorm.launches = 0
    flash_attention.launches = 0
    out = serve.main(argv)
    launches = {"rmsnorm": rmsnorm.launches, "flash_attention": flash_attention.launches}
    n_forward = GRANITE["new_tokens"]   # one prefill + new_tokens - 1 decode steps
    want = {"rmsnorm": (2 * GRANITE["layers"] + 1) * n_forward, "flash_attention": GRANITE["layers"]}
    decode_steps = GRANITE["new_tokens"] - 1
    tokens = out["tokens"]
    emit({"phase": "serve", "argv": argv, "prefill_s": out["prefill_s"],
          "prefill_tok_s": B * S / out["prefill_s"], "decode_s": out["decode_s"],
          "decode_steps": decode_steps, "decode_tok_s": B * decode_steps / out["decode_s"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "launches": launches, "expected_launches": want})
    require(launches == want, f"launches {launches}, expected {want}")
    require(out["launches"] == launches, f"serve reported {out['launches']}, counted {launches}")
    require(tokens.shape == (B, GRANITE["new_tokens"]), f"tokens shape {tuple(tokens.shape)}")
    vocab = get_config("granite-3-2b").vocab_size
    require(bool(((tokens >= 0) & (tokens < vocab)).all()), "generated tokens outside the vocab")

    # ------------------------------------------------------------- 5b
    # Where the serving time goes: the same model and shapes as phase 5,
    # traced apart from it so the tracer does not touch its numbers.
    model = LM(get_config("granite-3-2b"), device=dev, seed=0)
    prompt = torch.randint(0, vocab, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    cache_len = S + GRANITE["new_tokens"]
    with torch.inference_mode():
        model.prefill(prompt, cache_len)   # warm-up
        prefill = trace(lambda: model.prefill(prompt, cache_len), iters=3)
        logits, caches, lengths = model.prefill(prompt, cache_len)
        tok = torch.argmax(logits, -1).int()[:, None]
        decode = trace(lambda: model.decode_step(tok, caches, lengths), iters=8)
    emit({"phase": "serve_trace", "prefill": prefill, "decode_step": decode})
    del model, caches

    # ---------------------------------------------------------------- 6
    cfg = get_config("granite-3-2b").replace(n_layers=2, param_dtype="float32",
                                            compute_dtype="float32")
    model = LM(cfg, device=dev, seed=0)
    prompt = torch.randint(0, vocab, (2, 128), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    steps = 8
    cache_len = prompt.shape[1] + steps

    def run(device, feed=None):
        with torch.inference_mode():
            logits, caches, lengths = model.prefill(prompt.to(device), cache_len)
            seen = [logits.cpu()]
            toks = [torch.argmax(logits, -1).int().cpu()]
            for i in range(steps):
                tok = (toks[-1] if feed is None else feed[i]).to(device)[:, None]
                logits, caches = model.decode_step(tok, caches, lengths)
                lengths = lengths + 1
                seen.append(logits.cpu())
                toks.append(torch.argmax(logits, -1).int().cpu())
        return torch.stack(seen), torch.stack(toks)

    card_logits, card_toks = run(dev)
    model.to("cpu")
    cpu_logits, cpu_toks = run("cpu", feed=card_toks)
    real = slice(0, vocab)
    model_err = float((card_logits[..., real] - cpu_logits[..., real]).abs().max())
    agree = float((card_toks == cpu_toks).float().mean())
    emit({"phase": "model_vs_cpu", "layers": 2, "d_model": cfg.d_model, "dtype": "float32",
          "prompt": list(prompt.shape), "decode_steps": steps, "max_abs_logit_err": model_err,
          "atol": MODEL_FP32_ATOL, "greedy_agreement": agree})
    require(bool(torch.isfinite(card_logits[..., real]).all()), "non-finite logits on the card")
    require(model_err <= MODEL_FP32_ATOL, f"card vs CPU logits differ by {model_err}")
    require(agree == 1.0, f"greedy tokens agree on {agree:.3f} of positions")

    # ---------------------------------------------------------------- 7
    kernels = [
        {"name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:13", "launches": launches["rmsnorm"],
         "max_abs_err": err["rmsnorm"], **timing[("rmsnorm", "prefill")]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
         "launches": launches["flash_attention"], "max_abs_err": err["flash_attention"],
         **timing[("flash_attention", "prefill")]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
