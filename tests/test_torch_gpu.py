"""The port's CUDA kernels on the card against their plain versions, and
the port's refusals on CUDA tensors. Every test needs a CUDA device and
skips without one; on the GPU machine:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX: the GPU machine has none."""

import dataclasses

import pytest
import torch

from repro_torch.configs.archs import reduced
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import chunked_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.transformer import LM

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _reduced_granite(**attention):
    """Reduced granite with a head_dim the flash kernel takes (reduced() sets 16)."""
    cfg = reduced(get_config("granite-3-2b"))
    return cfg.replace(attention=dataclasses.replace(cfg.attention, head_dim=64, **attention))


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("shape", [(4, 2048), (33, 64), (2, 7, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    x = _randn(shape, dtype, cuda, 0) * 3
    scale = _randn(shape[-1:], torch.float32, cuda, 1) + 1
    before = rmsnorm.launches
    out = rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out, rmsnorm_ref(x, scale, 1e-5), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,Hk,Sq,Sk,Dh,causal,window", [
    (2, 8, 2, 256, 256, 64, True, None),
    (1, 4, 1, 200, 200, 128, True, None),
    (1, 4, 2, 256, 256, 64, True, 64),
    (1, 4, 4, 130, 190, 128, False, None),
    (1, 4, 4, 1, 1, 64, True, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, H, Hk, Sq, Sk, Dh, causal, window, dtype):
    q = _randn((B, Sq, H, Dh), dtype, cuda, 2)
    k = _randn((B, Sk, Hk, Dh), dtype, cuda, 3)
    v = _randn((B, Sk, Hk, Dh), dtype, cuda, 4)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = chunked_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("kw, err", [
    (dict(softcap=30.0), NotImplementedError),
    (dict(q_offset=8), NotImplementedError),
])
def test_flash_kernel_refuses_what_it_lacks(cuda, kw, err):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    with pytest.raises(err):
        flash_attention(q, q, q, **kw)


def test_flash_kernel_refuses_head_dim_96(cuda):
    q = torch.zeros((1, 8, 4, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)


def test_model_with_softcap_raises_on_cuda(cuda):
    cfg = _reduced_granite(logit_softcap=30.0)
    model = LM(cfg, device=cuda)
    with pytest.raises(NotImplementedError, match="softcap"):
        model.prefill(torch.zeros((1, 8), dtype=torch.int32, device=cuda), 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_card_matches_cpu(cuda, dtype):
    cfg = _reduced_granite().replace(n_layers=3, param_dtype=dtype, compute_dtype=dtype)
    model = LM(cfg, device=cuda, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        before = (rmsnorm.launches, flash_attention.launches)
        card, _, _ = model.prefill(tokens.to(cuda), 32)
        assert (rmsnorm.launches, flash_attention.launches) == (before[0] + 7, before[1] + 3)
        model.to("cpu")
        cpu, _, _ = model.prefill(tokens, 32)
    tol = dict(atol=1e-4, rtol=0.0) if dtype == "float32" else dict(atol=0.15, rtol=0.05)
    torch.testing.assert_close(card.cpu(), cpu, **tol)
