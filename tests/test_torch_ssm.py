"""The port's Mamba mixer (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU.

The reference draws the weights; a random ``a_log`` and ``b_dt`` replace
its zeros (``A = -1`` everywhere would not tell A's layout apart), and
the same numpy-seeded inputs go through both packages: ``chunked_scan``
in each of its three cases, the mixer, the decode step and the scan's
plain version ``kernels/ref.selective_scan_ref`` (K8's function).  The
reference runs under ``jax.jit``.

Tolerance: atol 1e-5 (f32 products and sums in another order than
XLA's, through O(1) activations; the scan's states decay, so rounding
does not grow with S).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jconfigs
from repro.models import param as jparam
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models import param, ssm

ATOL = 1e-5
ARCH = "jamba-v0.1-52b"
SMALL = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128)


def _cfgs():
    return (jconfigs.get_arch(ARCH).reduced(**SMALL),
            configs.get_arch(ARCH).reduced(**SMALL))


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


_PARAMS = {}


def _params():
    """The reference's mamba weights with a random ``a_log`` and
    ``b_dt``, as a numpy tree."""
    if not _PARAMS:
        jcfg, _ = _cfgs()
        p = jparam.init_params(jssm.mamba_specs(jcfg), jax.random.PRNGKey(0))
        p = jax.tree_util.tree_map(np.asarray, p)
        p["a_log"] = _normal(1, p["a_log"].shape, 0.5)
        p["b_dt"] = _normal(2, p["b_dt"].shape, 0.5)
        _PARAMS["p"] = p
    return _PARAMS["p"]


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 96, 128])
def test_chunked_scan_matches_reference(S):
    """S=32: one scan (S <= chunk); 96: one scan (S % chunk != 0); 128:
    two chunks.  A tree of inputs and a tuple of outputs."""
    a, b = _normal(3, (S, 2, 5), 0.5), _normal(4, (S, 2, 5))
    h0 = _normal(5, (2, 5))

    def jstep(h, xs):
        a_t, b_t = xs
        h = jnp.tanh(h * a_t + b_t)
        return h, (h.sum(-1), 2.0 * h)

    def tstep(h, xs):
        a_t, b_t = xs
        h = torch.tanh(h * a_t + b_t)
        return h, (h.sum(-1), 2.0 * h)

    jh, (jy0, jy1) = jax.jit(lambda h, a, b: jssm.chunked_scan(
        jstep, h, (a, b), 64))(h0, a, b)
    th, (ty0, ty1) = ssm.chunked_scan(tstep, torch.from_numpy(h0),
                                      (torch.from_numpy(a),
                                       torch.from_numpy(b)), 64)
    assert ty0.shape == (S, 2) and ty1.shape == (S, 2, 5)
    _close(th, jh, "carry")
    _close(ty0, jy0, "ys[0]")
    _close(ty1, jy1, "ys[1]")


# ---------------------------------------------------------------------------
# Specs and state
# ---------------------------------------------------------------------------

def _rows(tree):
    return {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
            for k, s in tree.items()}


@pytest.mark.parametrize("full", [False, True])
def test_mamba_specs_match_reference(full):
    j, t = jconfigs.get_arch(ARCH), configs.get_arch(ARCH)
    if not full:
        j, t = j.reduced(**SMALL), t.reduced(**SMALL)
    assert ssm.mamba_dims(t) == jssm.mamba_dims(j)
    assert _rows(ssm.mamba_specs(t)) == _rows(jssm.mamba_specs(j))


def test_mamba_init_state_keeps_h_in_f32():
    jcfg, tcfg = _cfgs()
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        js = jssm.mamba_init_state(jcfg, 3, jdt)
        ts = ssm.mamba_init_state(tcfg, 3, tdt, device="cpu")
        assert sorted(ts) == sorted(js)
        for k in js:
            assert tuple(ts[k].shape) == js[k].shape
            assert str(ts[k].dtype).replace("torch.", "") == str(js[k].dtype)
            assert not ts[k].any()
        assert ts["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The mixer, the scan and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 96, 128])
def test_mamba_mixer_matches_reference(S):
    jcfg, tcfg = _cfgs()
    p = _params()
    x = _normal(10 + S, (2, S, tcfg.d_model))
    want = jax.jit(lambda p, x: jssm.mamba_mixer(p, x, jcfg))(p, x)
    got = ssm.mamba_mixer(param.params_from_numpy(p, device="cpu"),
                          torch.from_numpy(x), tcfg)
    assert got.shape == (2, S, tcfg.d_model)
    _close(got, want)


def _scan_inputs(S, seed=20):
    """The reference's scan inputs of the mixer at ``S``, as numpy."""
    jcfg, _ = _cfgs()
    x = _normal(seed, (2, S, jcfg.d_model))
    xs, _, dt, Bc, Cc, A, _ = jax.jit(
        lambda p, x: jssm._mamba_inputs(p, x, jcfg))(_params(), x)
    return tuple(np.array(a) for a in (xs, dt, Bc, Cc, A))


@pytest.mark.parametrize("S", [1, 77, 128])
def test_selective_scan_ref_matches_reference_scan(S):
    """K8's plain version, the wrapper on CPU tensors and the mixer's
    plain scan against the reference's ``chunked_scan`` of its step."""
    xs, dt, Bc, Cc, A = _scan_inputs(S)

    def jscan(xs, dt, Bc, Cc, A):
        h0 = jnp.zeros((xs.shape[0], xs.shape[2], A.shape[1]), jnp.float32)
        swap = lambda a: a.swapaxes(0, 1)
        _, ys = jssm.chunked_scan(jssm._mamba_step(A), h0,
                                  (swap(xs), swap(dt), swap(Bc), swap(Cc)))
        return ys.swapaxes(0, 1)

    want = jax.jit(jscan)(xs, dt, Bc, Cc, A)
    args = [torch.from_numpy(a) for a in (xs, dt, Bc, Cc, A)]
    for got in (ref.selective_scan_ref(*args), selective_scan(*args),
                ssm.plain_scan(*args), ssm.selective_scan(*args)):
        assert got.shape == xs.shape and got.dtype == torch.float32
        _close(got, want)


def test_selective_scan_refuses_mismatched_shapes():
    xs, dt, Bc, Cc, A = (torch.from_numpy(a) for a in _scan_inputs(8))
    with pytest.raises(ValueError, match="Bc must be"):
        selective_scan(xs, dt, Bc[:, :4], Cc, A)
    with pytest.raises(ValueError, match="A must be"):
        selective_scan(xs, dt, Bc, Cc, A[:4])
    with pytest.raises(ValueError, match=r"xs must be \(B, S, di\)"):
        selective_scan(xs[0], dt, Bc, Cc, A)


def test_mamba_decode_steps_match_mixer_and_reference():
    """S steps of ``mamba_decode_step`` from the zero state: each step's
    output against the mixer's at that position (the scan and the
    conv's zero padding), and against the reference's decode step, with
    ``h`` and the conv window after every step."""
    jcfg, tcfg = _cfgs()
    p = _params()
    tp = param.params_from_numpy(p, device="cpu")
    S = 20
    x = _normal(30, (2, S, tcfg.d_model))
    full = ssm.mamba_mixer(tp, torch.from_numpy(x), tcfg)
    jstep = jax.jit(lambda p, x, st: jssm.mamba_decode_step(p, x, st, jcfg))
    jstate = jssm.mamba_init_state(jcfg, 2)
    tstate = ssm.mamba_init_state(tcfg, 2, device="cpu")
    h_cache, conv_cache = tstate["h"], tstate["conv"]
    for t in range(S):
        want, jstate = jstep(p, x[:, t:t + 1], jstate)
        got, tstate = ssm.mamba_decode_step(
            tp, torch.from_numpy(x[:, t:t + 1]), tstate, tcfg)
        # the state is written into the cache's own tensors
        assert tstate["h"] is h_cache and tstate["conv"] is conv_cache
        _close(got, want, f"step {t}")
        _close(got[:, 0], full[:, t], f"step {t} vs the mixer")
        _close(tstate["h"], jstate["h"], f"h, step {t}")
        _close(tstate["conv"], jstate["conv"], f"conv, step {t}")
