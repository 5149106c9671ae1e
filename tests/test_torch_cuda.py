"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit's nvcc (a hand-written
kernel has no CPU form); without a card they skip.  They import no JAX,
so they run where only PyTorch is installed, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  ``chip_smoke.py``
phase 3 holds every kernel at the main path's full shapes.

Tolerance of K7 against its plain version: in float32 the reference's
sweep tolerance (``tests/test_kernels.py``), atol 4e-5 / rtol 2e-5; in
bfloat16 atol 4e-3 / rtol 1e-2, one bf16 ulp (<= 2^-7 |x|) and a margin,
since the kernel and the plain version both compute in float32 and round
once to bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import flash_attention_3d
from repro_torch.models import attention as attn

TOL = {torch.float32: (4e-5, 2e-5), torch.bfloat16: (4e-3, 1e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _normal(seed, shape, dtype, device):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,t,hd,causal,period,dtype", [
    (4, 256, 256, 64, True, 0, torch.float32),
    (4, 256, 256, 64, True, 0, torch.bfloat16),
    (2, 1000, 1000, 64, True, 0, torch.float32),     # ragged tails
    (2, 4 * 200, 200, 128, True, 200, torch.float32),  # GQA-folded rows
    (3, 100, 77, 32, False, 0, torch.float32),
    (3, 70, 130, 32, True, 0, torch.bfloat16),
    (1, 1, 1, 128, True, 0, torch.float32),
])
def test_flash_attention_kernel_matches_plain(card, bh, s, t, hd, causal,
                                              period, dtype):
    q = _normal(1, (bh, s, hd), dtype, card)
    k = _normal(2, (bh, t, hd), dtype, card)
    v = _normal(3, (bh, t, hd), dtype, card)
    build.reset_launch_counts()
    got = flash_attention_3d(q, k, v, causal=causal, causal_period=period)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention"] == 1
    want = ref.flash_attention_3d_ref(q, k, v, causal=causal,
                                      causal_period=period)
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Kv,S", [(4, 4, 96), (8, 2, 130)])
def test_model_attention_runs_k7_on_the_card(card, H, Kv, S):
    """``attention`` on CUDA tensors launches K7 once, in the model's head
    order, and agrees with the plain dispatch on the card."""
    q = _normal(4, (2, S, H, 64), torch.float32, card)
    k = _normal(5, (2, S, Kv, 64), torch.float32, card)
    v = _normal(6, (2, S, Kv, 64), torch.float32, card)
    build.reset_launch_counts()
    got = attn.attention(q, k, v, causal=True)
    assert build.launch_counts["flash_attention"] == 1
    want = attn.plain_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=4e-5, rtol=2e-5)
