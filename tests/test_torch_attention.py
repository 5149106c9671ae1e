"""The port's attention layer and K7's plain path against the JAX package.

On the CPU the K7 wrapper (``repro_torch.kernels.flash_attention``) takes
its plain version, so these tests hold the arithmetic and, above all, the
layouts around the kernel: the reference's GQA wrapper in its ``repeat``
head order (``kernels.ops.flash_attention``) and the model path's fold in
the model's tile order (``models.attention.flash_gqa``), which is the code
the card runs around the kernel.  The CUDA kernel itself is held against
the same plain version on the card (``chip_smoke.py`` phase 3 and the
``cuda``-marked tests in ``tests/test_torch_cuda.py``).

Tolerances:
- K7's plain path against the Pallas kernel in interpret mode: the
  reference's own sweep tolerance (``tests/test_kernels.py``): atol 4e-5 /
  rtol 2e-5 in float32, atol 4e-2 / rtol 2e-2 in bfloat16 (an ulp of a
  bf16 output is 8e-3 at magnitude 1-2);
- the model's attention functions: float32 softmax sums in another order
  than XLA's: atol 2e-5 for attention through the K7 route, 1e-5 for the
  plain versions, the cached path and RoPE.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.kernels.flash_attention import \
    flash_attention_3d as j_flash_attention_3d
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn

ROUTE_ATOL = 2e-5
PLAIN_ATOL = 1e-5


def sweep_tol(dtype):
    """(atol, rtol) of the reference's flash-attention sweep."""
    t = 2e-2 if dtype == "bfloat16" else 2e-5
    return 2 * t, t


def _qkv(seed, B, S, H, Kv, hd, T=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return [rng.normal(size=s).astype(dtype)
            for s in ((B, S, H, hd), (B, T, Kv, hd), (B, T, Kv, hd))]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


#: The reference's flash-attention sweep (tests/test_kernels.py).
SWEEP = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 4, 1, 128),
         (2, 128, 6, 6, 32)]


@pytest.mark.parametrize("B,S,H,Kv,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_path_matches_pallas(B, S, H, Kv, hd, causal,
                                                   dtype):
    """``kernels.ops.flash_attention`` (repeat order, CPU: the plain
    version) against the reference's wrapper over its Pallas kernel in
    interpret mode, on the reference's sweep."""
    q, k, v = _qkv(B * S + H, B, S, H, Kv, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jops.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                causal=causal, interpret=True)
    got = ops.flash_attention(*(_t(x, tdt) for x in (q, k, v)),
                              causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    atol, rtol = sweep_tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,S,H,Kv,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_its_oracle(B, S, H, Kv, hd, causal, dtype):
    """The 4-D oracle ``ref.flash_attention_ref`` against the reference's
    oracle, and ``kernels.ops.flash_attention`` against it with K/V
    repeated in the wrapper's head order, as ``tests/test_kernels.py``
    holds the Pallas kernel."""
    q, k, v = _qkv(B * S + H + 1, B, S, H, Kv, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (_t(x, tdt) for x in (q, k, v))

    def rep(a):
        return a.repeat_interleave(H // Kv, dim=2).permute(0, 2, 1, 3)

    oracle = ref.flash_attention_ref(tq.permute(0, 2, 1, 3), rep(tk),
                                     rep(tv), causal=causal)
    want = jref.flash_attention_ref(
        *(jnp.asarray(x, jdt).transpose(0, 2, 1, 3)
          for x in (q, np.repeat(k, H // Kv, 2), np.repeat(v, H // Kv, 2))),
        causal=causal)
    assert oracle.dtype == tdt and oracle.shape == (B, H, S, hd)
    atol, rtol = sweep_tol(dtype)
    np.testing.assert_allclose(oracle.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               oracle.permute(0, 2, 1, 3).float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal,period", [(True, 0), (True, 64),
                                           (False, 64)])
def test_flash_attention_3d_matches_pallas(causal, period):
    """The 3-D wrapper with and without ``causal_period`` against the
    Pallas kernel in interpret mode (whose blocks tile S and T)."""
    q, k, v = (x[0] for x in _qkv(3, 1, 256, 2, 2, 64))
    q3 = _t(q).permute(1, 0, 2).contiguous()   # (BH=2, S=256, hd)
    k3 = _t(k).permute(1, 0, 2).contiguous()
    v3 = _t(v).permute(1, 0, 2).contiguous()
    want = j_flash_attention_3d(
        jnp.asarray(q3.numpy()), jnp.asarray(k3.numpy()),
        jnp.asarray(v3.numpy()), causal=causal, causal_period=period,
        interpret=True)
    got = fa.flash_attention_3d(q3, k3, v3, causal=causal,
                                causal_period=period)
    atol, rtol = sweep_tol("float32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("S,T,causal", [(100, 100, True), (37, 90, False),
                                        (1, 5, True)])
def test_flash_attention_3d_ragged_lengths(S, T, causal):
    """Lengths that no 64-row block divides (the CUDA kernel masks the
    tails): the plain path against the reference's full attention."""
    q, k, v = _qkv(S + T, 1, S, 2, 2, 32, T=T)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    got = fa.flash_attention_3d(_t(q)[0].permute(1, 0, 2),
                                _t(k)[0].permute(1, 0, 2),
                                _t(v)[0].permute(1, 0, 2), causal=causal)
    np.testing.assert_allclose(got.permute(1, 0, 2).numpy(),
                               np.asarray(want)[0], atol=PLAIN_ATOL)


@pytest.mark.parametrize("H,Kv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("S", [64, 200])
def test_attention_k7_route_matches_model_attention(monkeypatch, H, Kv, S):
    """``flash_gqa`` -- the fold, the kernel call and the unfold that the
    card runs -- against the reference's ``models.attention.attention``.
    On the CPU the kernel call takes ``flash_attention_3d_ref``.  A fold
    in the reference wrapper's repeat order differs by O(1) for GQA, and
    this test is built to see it."""
    q, k, v = _qkv(H * S + Kv, 2, S, H, Kv, 64)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True))
    calls = []

    def spy(q3, k3, v3, **kw):
        calls.append((tuple(q3.shape), tuple(k3.shape), kw))
        return ref.flash_attention_3d_ref(q3, k3, v3, **kw)

    monkeypatch.setattr(attn, "flash_attention_3d", spy)
    got = attn.flash_gqa(_t(q), _t(k), _t(v), causal=True).numpy()
    assert calls == [((2 * Kv, (H // Kv) * S, 64), (2 * Kv, S, 64),
                      {"causal": True, "causal_period": S})]
    np.testing.assert_allclose(got, want, atol=ROUTE_ATOL)
    repeat = ops.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    if H != Kv:
        assert np.abs(repeat - want).max() > 0.1
    else:
        np.testing.assert_allclose(repeat, want, atol=ROUTE_ATOL)


@pytest.mark.parametrize("S,H,Kv", [(64, 4, 2), (4096, 2, 1)])
def test_attention_cpu_dispatch_matches_reference(S, H, Kv):
    """On the CPU ``attention`` takes the plain versions by the
    reference's rule: full below CHUNK_THRESHOLD, chunked (1024-key
    chunks at S=4096) from it on."""
    q, k, v = _qkv(S, 1, S, H, Kv, 32)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True)
    got = attn.attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL)


@pytest.mark.parametrize("causal,window,offset", [
    (True, 0, 0), (False, 0, 0), (True, 16, 0), (True, 0, 5)])
def test_full_attention_matches_reference(causal, window, offset):
    q, k, v = _qkv(7, 2, 40, 4, 2, 32, T=45)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, q_offset=offset)
    got = attn.full_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("S", [256, 200])
def test_chunked_attention_matches_reference(window, S):
    """64-key chunks; at S=200 no chunk size divides and both fall back
    to full attention."""
    q, k, v = _qkv(11 + S, 2, S, 4, 2, 32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window, kv_chunk=64)
    got = attn.chunked_attention(_t(q), _t(k), _t(v), causal=True,
                                 window=window, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL)


def test_cached_attention_over_a_wrapping_ring():
    """Twenty tokens through an 8-slot ring cache: each step's cache and
    attention against the reference's functional update."""
    B, H, Kv, hd, cap, T = 2, 4, 2, 16, 8, 20
    q, k, v = _qkv(5, B, T, H, Kv, hd)
    jkc = jnp.zeros((B, cap, Kv, hd))
    jvc = jnp.zeros((B, cap, Kv, hd))
    kc = torch.zeros(B, cap, Kv, hd)
    vc = torch.zeros(B, cap, Kv, hd)
    for t in range(T):
        sl = slice(t, t + 1)
        jkc, jvc = jattn.update_cache(jkc, jvc, jnp.asarray(k[:, sl]),
                                      jnp.asarray(v[:, sl]), t)
        kc, vc = attn.update_cache(kc, vc, _t(k[:, sl]), _t(v[:, sl]), t)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
        want = jattn.cached_attention(jnp.asarray(q[:, sl]), jkc, jvc,
                                      cache_len=min(t + 1, cap))
        got = attn.cached_attention(_t(q[:, sl]), kc, vc,
                                    cache_len=min(t + 1, cap))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PLAIN_ATOL, err_msg=f"step {t}")


def test_cached_attention_per_row_lengths():
    q, k, v = _qkv(9, 3, 12, 4, 4, 16)
    lens = np.array([1, 7, 12], np.int32)
    want = jattn.cached_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                  jnp.asarray(v), cache_len=jnp.asarray(lens))
    got = attn.cached_attention(_t(q[:, :1]), _t(k), _t(v),
                                cache_len=_t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_apply_rope_matches_reference(theta, hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 300, 3, hd)).astype(np.float32)
    pos = np.arange(300, dtype=np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = attn.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_ATOL)
    np.testing.assert_allclose(attn.rope_frequencies(hd, theta).numpy(),
                               np.asarray(jattn.rope_frequencies(hd, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("bad,err,match", [
    (dict(q=torch.zeros(2, 8, 64, 1)), ValueError, "3-D"),
    (dict(k=torch.zeros(3, 8, 64)), ValueError, "BH, T, hd"),
    (dict(v=torch.zeros(2, 9, 64)), ValueError, "BH, T, hd"),
    (dict(q=torch.zeros(2, 8, 48), k=torch.zeros(2, 8, 48),
          v=torch.zeros(2, 8, 48)), ValueError, "head dim 48"),
    (dict(k=torch.zeros(2, 0, 64), v=torch.zeros(2, 0, 64)), ValueError,
     "no keys"),
    (dict(q=torch.zeros(2, 8, 64, dtype=torch.float16),
          k=torch.zeros(2, 8, 64, dtype=torch.float16),
          v=torch.zeros(2, 8, 64, dtype=torch.float16)), TypeError,
     "float32 or bfloat16"),
    (dict(v=torch.zeros(2, 8, 64, dtype=torch.bfloat16)), TypeError,
     "v is torch.bfloat16"),
    (dict(k=torch.zeros(2, 8, 64, device="meta")), ValueError, "is on meta"),
    (dict(causal_period=-1), ValueError, "causal_period"),
])
def test_flash_attention_3d_checks_its_inputs(bad, err, match):
    args = dict(q=torch.zeros(2, 8, 64), k=torch.zeros(2, 8, 64),
                v=torch.zeros(2, 8, 64), causal_period=0)
    args.update(bad)
    with pytest.raises(err, match=match):
        fa.flash_attention_3d(args.pop("q"), args.pop("k"), args.pop("v"),
                              **args)


def test_cpu_attention_launches_no_kernel():
    build.reset_launch_counts()
    q, k, v = (_t(x) for x in _qkv(1, 1, 16, 2, 1, 32))
    attn.flash_gqa(q, k, v, causal=True)
    ops.flash_attention(q, k, v, causal=False)
    assert build.launch_counts["flash_attention"] == 0


def test_attention_on_the_card_refuses_a_window(monkeypatch):
    """The card's path has no windowed kernel and no plain fallback."""
    q, k, v = (_t(x) for x in _qkv(1, 1, 16, 2, 1, 32))

    class OnCard:
        type = "cuda"

    monkeypatch.setattr(torch.Tensor, "device", property(lambda s: OnCard))
    with pytest.raises(ValueError, match="sliding window"):
        attn.attention(q, k, v, causal=True, window=8)

