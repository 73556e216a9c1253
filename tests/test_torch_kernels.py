"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpret mode and its pure-jnp
oracles, on the same numpy inputs. Tolerances are those of
``tests/test_kernels.py``: flash 2e-5 fp32 / 2e-2 bf16, rmsnorm 1e-5 fp32 /
2e-2 bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.attention import chunked_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Keep torch to one thread so the suite's timing tests, running in
    other workers, are not starved."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(a, jnp.float32).astype(jdt)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _close(ours: torch.Tensor, theirs, tol: float):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                               rtol=tol, atol=tol)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.parametrize("call", [
    lambda t: rms_ops.rmsnorm(t, t[0], 1e-5),
    lambda t: flash_ops.flash_attention(t[None, :, None], t[None, :, None], t[None, :, None]),
])
def test_wrappers_take_only_cpu_or_cuda_tensors(call):
    with pytest.raises(ValueError, match="cpu or cuda"):
        call(torch.empty((8, 64), device="meta"))


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape) * 3.0, dtype)
    s = (rng.standard_normal(shape[-1:]) + 1.0).astype(np.float32)
    out = rms_ops.rmsnorm(xt, torch.from_numpy(s), 1e-5)
    ref = jax_rmsnorm(xj, jnp.asarray(s), interpret=True, block_rows=8)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(out, ref, 2e-2 if dtype == "bfloat16" else 1e-5)


def test_rmsnorm_cpu_tensor_takes_plain_version():
    before = rms_ops.rmsnorm.launches
    rms_ops.rmsnorm(torch.ones(2, 64), torch.ones(64), 1e-5)
    assert rms_ops.rmsnorm.launches == before


@pytest.mark.parametrize("x, scale, err", [
    (torch.ones(2, 64, dtype=torch.float16), torch.ones(64), TypeError),
    (torch.ones(2, 64), torch.ones(64, dtype=torch.bfloat16), TypeError),
    (torch.ones(2, 64), torch.ones(32), ValueError),
    (torch.ones(2, 6), torch.ones(6), ValueError),               # not whole 16-byte vectors
    (torch.ones(64, 2).T, torch.ones(64), ValueError),           # not contiguous
])
def test_rmsnorm_kernel_rejects_what_it_does_not_take(x, scale, err):
    with pytest.raises(err):
        rms_ops.check_inputs(x, scale)


# ------------------------------------------------------------------ flash
def _qkv(B, H, Hk, Sq, Sk, Dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s), dtype)
            for s in ((B, Sq, H, Dh), (B, Sk, Hk, Dh), (B, Sk, Hk, Dh))]


@pytest.mark.parametrize("B,H,Hk,S,Dh,dtype", [
    (1, 8, 2, 128, 64, "bfloat16"),     # GQA 4:1
    (1, 4, 4, 100, 64, "float32"),      # ragged: padded by the Pallas wrapper
])
def test_flash_plain_matches_pallas_interpret(B, H, Hk, S, Dh, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, H, Hk, S, S, Dh, dtype)
    out = flash_ops.flash_attention(qt, kt, vt, causal=True)
    ref = jax_flash(qj, kj, vj, causal=True, block_q=64, block_k=64, interpret=True)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, 2e-2 if dtype == "bfloat16" else 2e-5)


FLASH_CASES = [
    # (B, H, Hk, Sq, Sk, Dh, causal, window, dtype): cases of test_kernels.FLASH_SWEEP
    (1, 4, 4, 128, 128, 64, True, None, "float32"),
    (2, 8, 2, 256, 256, 64, True, None, "float32"),      # GQA 4:1
    (1, 4, 1, 128, 128, 128, True, None, "float32"),     # MQA
    (1, 4, 4, 200, 200, 64, True, None, "float32"),      # ragged
    (1, 4, 2, 256, 256, 64, True, 64, "float32"),        # sliding window
    (1, 4, 4, 128, 128, 64, False, None, "float32"),     # bidirectional
    (2, 4, 2, 256, 256, 64, True, None, "bfloat16"),
    (1, 8, 8, 256, 256, 96, True, None, "bfloat16"),     # phi3 head_dim
]


@pytest.mark.parametrize("B,H,Hk,Sq,Sk,Dh,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_attention_ref(B, H, Hk, Sq, Sk, Dh, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, H, Hk, Sq, Sk, Dh, dtype, seed=Sq + H)
    out = flash_ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    ref = attention_ref(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                        vj.transpose(0, 2, 1, 3), causal=causal, window=window)
    _close(out, ref.transpose(0, 2, 1, 3), 2e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("softcap, q_offset, q_chunk, kv_chunk", [
    (None, 0, 32, 48),
    (5.0, 0, 64, 32),
    (None, 16, 32, 32),
])
def test_chunked_attention_matches_jax(softcap, q_offset, q_chunk, kv_chunk):
    """The plain version keeps the JAX twin's softcap and q_offset."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 4, 2, 80, 96, 64, "float32", seed=3)
    kw = dict(causal=True, window=None, q_chunk=q_chunk, kv_chunk=kv_chunk,
              softcap=softcap, q_offset=q_offset)
    _close(chunked_attention(qt, kt, vt, **kw), jax_chunked(qj, kj, vj, **kw), 2e-5)


def test_flash_cpu_tensor_takes_plain_version():
    (_, qt), (_, kt), (_, vt) = _qkv(1, 2, 2, 16, 16, 64, "float32")
    before = flash_ops.flash_attention.launches
    flash_ops.flash_attention(qt, kt, vt, softcap=3.0, q_offset=4)
    assert flash_ops.flash_attention.launches == before


@pytest.mark.parametrize("shapes, dtype, window, err", [
    (((1, 8, 4, 96), (1, 8, 4, 96)), torch.bfloat16, None, ValueError),   # Dh 96
    (((1, 8, 4, 64), (1, 8, 3, 64)), torch.bfloat16, None, ValueError),   # H % Hk
    (((1, 8, 4, 64), (1, 8, 2, 64)), torch.float16, None, TypeError),
    (((1, 8, 4, 64), (1, 0, 2, 64)), torch.float32, None, ValueError),    # no keys
    (((1, 8, 4, 64), (1, 8, 2, 64)), torch.float32, 0, ValueError),
])
def test_flash_kernel_rejects_what_it_does_not_take(shapes, dtype, window, err):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    with pytest.raises(err):
        flash_ops.check_inputs(q, k, k.clone(), window)
