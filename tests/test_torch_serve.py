"""The port's serving path against the JAX package's, for the same weights.

JAX ``LM.init`` params go to numpy, through ``params_from_jax`` into the
port's ``LM``; both models get the same prompt. Prefill logits, decode-step
logits and greedy tokens must agree: atol 1e-4 in fp32 with identical
greedy tokens; in bf16 the reference's own atol 0.15 / rtol 0.05
(``tests/test_arch_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import reduced as jax_reduced
from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro.training.serve_step import generate as jax_generate
from repro_torch.configs.archs import reduced
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models.transformer import LM
from repro_torch.training.serve_step import generate

TOL = {"float32": dict(atol=1e-4, rtol=0.0), "bfloat16": dict(atol=0.15, rtol=0.05)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch to one thread so the suite's timing tests, running in
    other workers, are not starved."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str, **kw):
    """The same reduced config from both packages."""
    kw.update(param_dtype=dtype, compute_dtype=dtype)
    return jax_reduced(jax_get_config(arch)).replace(**kw), reduced(get_config(arch)).replace(**kw)


def _models(arch: str, dtype: str, seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    params, _ = JaxLM.init(jax.random.PRNGKey(seed), jcfg)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, params, model


def _close(ours: torch.Tensor, theirs, dtype: str):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), **TOL[dtype])


@pytest.mark.parametrize("arch, dtype, n_layers", [
    ("granite-3-2b", "float32", 3),
    ("granite-3-2b", "bfloat16", 3),
    ("gemma3-4b", "float32", None),    # local ring caches, qk-norm, gelu, tied embeddings
])
def test_prefill_and_decode_match_jax(arch, dtype, n_layers):
    kw = {"n_layers": n_layers} if n_layers else {}
    jcfg, params, model = _models(arch, dtype, **kw)
    B, S, steps = 2, 12, 4
    cache_len = S + steps
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S + steps), dtype=np.int32)

    jprefill = jax.jit(lambda p, t: JaxLM.prefill(p, jcfg, t, cache_len))
    jdecode = jax.jit(lambda p, t, c, n: JaxLM.decode_step(p, jcfg, t, c, n))
    jl, jc, jn = jprefill(params, jnp.asarray(toks[:, :S]))
    with torch.inference_mode():
        tl, tc, tn = model.prefill(torch.from_numpy(toks[:, :S]), cache_len)
        assert tl.dtype == torch.float32 and tl.shape == (B, jcfg.vocab_padded)
        _close(tl, jl, dtype)
        for t in range(S, S + steps):
            jl, jc = jdecode(params, jnp.asarray(toks[:, t:t + 1]), jc, jn)
            tl, tc = model.decode_step(torch.from_numpy(toks[:, t:t + 1]), tc, tn)
            jn, tn = jn + 1, tn + 1
            _close(tl, jl, dtype)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-4b"])
def test_greedy_generate_matches_jax_fp32(arch):
    jcfg, params, model = _models(arch, "float32", seed=2)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 10), dtype=np.int32)
    ref = jax_generate(params, jcfg, jnp.asarray(prompt), max_new_tokens=6)
    out = generate(model, torch.from_numpy(prompt), 6)
    assert out.dtype == torch.int32 and out.shape == (2, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_consistency_with_forward():
    """Decode steps reproduce the full-forward logits step by step (the port
    of test_arch_smoke.test_decode_consistency_with_forward)."""
    model = LM(reduced(get_config("granite-3-2b")), device="cpu", seed=3)
    B, S = 1, 8
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        hidden = model(toks)
        full_logits = model.logits(hidden)                       # [B, S, V]
        caches = model.init_caches(B, S, torch.bfloat16)
        lengths = torch.zeros((B,), dtype=torch.int32)
        steps = []
        for t in range(S):
            lg, caches = model.decode_step(toks[:, t:t + 1], caches, lengths)
            lengths = lengths + 1
            steps.append(lg)
    _close(torch.stack(steps, dim=1), full_logits.numpy(), "bfloat16")


def test_prefill_matches_decode_chain():
    """prefill(S tokens) == S decode steps (the port of
    test_arch_smoke.test_prefill_matches_decode_chain)."""
    model = LM(reduced(get_config("qwen3-4b")), device="cpu", seed=8)
    B, S, cache_len = 1, 8, 16
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        pf_logits, _, n = model.prefill(toks, cache_len)
        caches = model.init_caches(B, cache_len, torch.bfloat16)
        lengths = torch.zeros((B,), dtype=torch.int32)
        for t in range(S):
            lg, caches = model.decode_step(toks[:, t:t + 1], caches, lengths)
            lengths = lengths + 1
    _close(pf_logits, lg.numpy(), "bfloat16")
    assert int(n[0]) == S


def test_serve_main_reduced_on_cpu():
    out = serve.main(["--arch", "granite-3-2b", "--reduce", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "4", "--device", "cpu", "--quiet"])
    assert out["tokens"].shape == (2, 4)
    assert (out["tokens"] >= 0).all() and (out["tokens"] < 512).all()
    assert out["prefill_s"] > 0 and out["decode_s"] > 0
    # CPU tensors take the plain versions: no kernel launches
    assert out["launches"] == {"rmsnorm": 0, "flash_attention": 0}


def test_serve_main_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda", "--quiet"])


@pytest.mark.parametrize("reduce, match", [
    (True, "head_dim 16 .*pass --no-reduce"),
    (False, "head_dim 256"),
])
def test_serve_refuses_head_dim_the_kernel_lacks_on_cuda(reduce, match):
    arch = "granite-3-2b" if reduce else "gemma3-4b"
    cfg = get_config(arch)
    cfg = reduced(cfg) if reduce else cfg
    with pytest.raises(ValueError, match=match):
        serve._check_head_dim(cfg, torch.device("cuda"), reduce)
    serve._check_head_dim(cfg, torch.device("cpu"), reduce)   # the CPU takes any head_dim
    serve._check_head_dim(get_config("granite-3-2b"), torch.device("cuda"), False)


def test_params_from_jax_keeps_paths_dtypes_and_bits():
    jcfg, _ = _cfgs("granite-3-2b", "bfloat16", n_layers=3)
    params, _ = JaxLM.init(jax.random.PRNGKey(5), jcfg)
    flat = {jax.tree_util.keystr(path, simple=True, separator="."): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    state = params_from_jax(jax.tree.map(np.asarray, params))
    assert set(state) == set(flat)
    assert state["stack.pat0.mixer.wq"].shape == (3, 64, 64)
    for key, a in flat.items():
        t = state[key]
        if a.dtype == np.float32:
            assert t.dtype == torch.float32 and key.endswith(("norm", "norm1", "norm2"))
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("tree, err", [
    ({"embed": np.zeros(4, np.float16)}, TypeError),
    ({"embed": [1.0]}, TypeError),
    ({"a.b": np.zeros(4, np.float32)}, KeyError),
])
def test_params_from_jax_raises_on_what_does_not_map(tree, err):
    with pytest.raises(err):
        params_from_jax(tree)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b", "whisper-base",
                                  "phi-3-vision-4.2b", "qwen2-moe-a2.7b"])
def test_later_slices_raise(arch):
    with pytest.raises(NotImplementedError, match="slice"):
        LM(reduced(get_config(arch)), device="cpu")
