"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and xlstm-350m's
serving path against the JAX package's, on the CPU.

The reference draws the weights at the reduced preset (d=256, 4 heads,
dk=128, dh=64, 4 layers, V=512); ``params_from_numpy`` carries them
across.  The mixer-level cases replace the reference's zero gate biases
(``b_if``, ``b_x``) by random ones, so that a swapped gate would show.
The same numpy-seeded inputs then go through both packages: the plain
scans (K9's and K10's functions) and the mixers at S=16, 100 and 128
with chunk=64 (128 takes ``chunked_scan``'s chunked branch, 100 its
unchunked one), the decode steps, the model's prefill and decode, and
the serve loop; the wrappers take inputs that require grad (their
training is held in ``tests/test_torch_xlstm_train.py``).  The reference
runs under ``jax.jit``.

The reference's prefill starts the stabiliser ``m`` at -1e30, its decode
cache at 0 (every cache leaf is ``init="zeros"``): the two paths agree
at random init, and not once the mLSTM input gate's bias is -3.  The port
copies each path, and is held to each, not to the other.

Tolerances: scans, mixers and decode steps atol 1e-5 (f32 products and
sums in another order than XLA's, through O(1) activations); logits
1e-4 x max |logit| (4 layers of the same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import param as jparam
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.kernels import ref, xlstm_scan
from repro_torch.launch import serve, steps
from repro_torch.models import param, transformer, xlstm

ATOL = 1e-5
LOGIT_REL = 1e-4
ARCH = "xlstm-350m"
CHUNK = 64


def _cfgs():
    return jconfigs.get_arch(ARCH).reduced(), configs.get_arch(ARCH).reduced()


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def _close_logits(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=LOGIT_REL * np.abs(want).max(),
                               err_msg=what)


_CACHE = {}


def _mixer_params(kind):
    """The reference's ``kind`` mixer weights with random gate biases."""
    if kind not in _CACHE:
        jcfg, _ = _cfgs()
        specs = {"mlstm": jxlstm.mlstm_specs,
                 "slstm": jxlstm.slstm_specs}[kind](jcfg)
        p = jax.tree_util.tree_map(
            np.asarray, jparam.init_params(specs, jax.random.PRNGKey(0)))
        bias = "b_if" if kind == "mlstm" else "b_x"
        p[bias] = _normal(1, p[bias].shape)
        _CACHE[kind] = p
    return _CACHE[kind]


def _model_params(b_if=None):
    """The reference's model weights (numpy) and the port's copy; with
    ``b_if``, every mLSTM block's input-gate bias ``b_if[:, :H]`` set to
    it."""
    key = ("model", b_if)
    if key not in _CACHE:
        jcfg, _ = _cfgs()
        p = jax.tree_util.tree_map(np.array, jparam.init_params(
            jtf.model_specs(jcfg), jax.random.PRNGKey(0)))
        if b_if is not None:
            p["stack"]["pos_1"]["mlstm"]["b_if"][:, :jcfg.num_heads] = b_if
        _CACHE[key] = (p, param.params_from_numpy(p, device="cpu"))
    return _CACHE[key]


def _tokens(seed, vocab, B, S):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Specs and states
# ---------------------------------------------------------------------------

def _rows(tree):
    return {k: (tuple(s.shape), tuple(s.axes), s.init, s.scale)
            for k, s in tree.items()}


@pytest.mark.parametrize("full", [False, True])
def test_xlstm_specs_match_reference(full):
    j, t = jconfigs.get_arch(ARCH), configs.get_arch(ARCH)
    if not full:
        j, t = j.reduced(), t.reduced()
    assert xlstm.mlstm_dims(t) == jxlstm.mlstm_dims(j)
    assert _rows(xlstm.mlstm_specs(t)) == _rows(jxlstm.mlstm_specs(j))
    assert _rows(xlstm.slstm_specs(t)) == _rows(jxlstm.slstm_specs(j))


def test_full_config_parameter_count():
    """xlstm-350m in full: 24 layers at d=1,024, V=50,304, an untied
    head."""
    specs = transformer.model_specs(configs.get_arch(ARCH))
    assert param.param_count(specs) == 405_185_632
    assert param.param_count(specs) == jparam.param_count(
        jtf.model_specs(jconfigs.get_arch(ARCH)))
    assert param.param_count(specs["embed"]) == 50_304 * 1024


def test_init_states_match_reference():
    jcfg, tcfg = _cfgs()
    for jfn, tfn in ((jxlstm.mlstm_init_state, xlstm.mlstm_init_state),
                     (jxlstm.slstm_init_state, xlstm.slstm_init_state)):
        js, ts = jfn(jcfg, 3), tfn(tcfg, 3, device="cpu")
        assert sorted(ts) == sorted(js)
        for k in js:
            assert ts[k].dtype == torch.float32
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


# ---------------------------------------------------------------------------
# The plain scans and the mixers
# ---------------------------------------------------------------------------

def _jscan(step, carry, xs):
    swap = lambda a: a.swapaxes(0, 1)
    _, hs = jssm.chunked_scan(step, carry, tuple(map(swap, xs)), CHUNK)
    return hs.swapaxes(0, 1)


@pytest.mark.parametrize("S", [16, 100, 128])
def test_mlstm_plain_scan_matches_reference(S):
    """K9's plain version, the wrapper on CPU tensors and the mixer's
    scan on the CPU against the reference's ``chunked_scan`` of its
    step, on the mixer's inputs."""
    jcfg, _ = _cfgs()
    x = _normal(10 + S, (2, S, jcfg.d_model))
    q, k, v, log_i, log_f = jax.jit(
        lambda p, x: jxlstm._mlstm_inputs(p, x, jcfg)[:5])(
        _mixer_params("mlstm"), x)
    dk = jxlstm.mlstm_dims(jcfg)[1]
    st = jxlstm.mlstm_init_state(jcfg, 2)
    want = jax.jit(lambda *xs: _jscan(jxlstm._mlstm_step(dk),
                                      (st["C"], st["n"], st["m"]), xs))(
        q, k, v, log_i, log_f)
    args = _t(q, k, v, log_i, log_f)
    for got in (ref.mlstm_scan_ref(*args, CHUNK),
                xlstm_scan.mlstm_scan(*args),
                xlstm.mlstm_scan(*args, CHUNK)):
        assert got.shape == q.shape and got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("S", [16, 100, 128])
def test_slstm_plain_scan_matches_reference(S):
    jcfg, _ = _cfgs()
    p = _mixer_params("slstm")
    x = _normal(20 + S, (2, S, jcfg.d_model))
    xs = jax.jit(lambda p, x: jxlstm._slstm_inputs(p, x, jcfg))(p, x)
    st = jxlstm.slstm_init_state(jcfg, 2)
    want = jax.jit(lambda p, *xs: _jscan(
        jxlstm._slstm_step(p, jcfg.num_heads),
        (st["c"], st["n"], st["m"], st["h"]), xs))(p, *xs)
    args = _t(*xs) + _t(*(p[k] for k in ("r_z", "r_i", "r_f", "r_o")))
    for got in (ref.slstm_scan_ref(*args, CHUNK),
                xlstm_scan.slstm_scan(*args),
                xlstm.slstm_scan(*args, CHUNK)):
        assert got.shape == xs[0].shape and got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [16, 100, 128])
def test_mixer_matches_reference(kind, S):
    jcfg, tcfg = _cfgs()
    p = _mixer_params(kind)
    x = _normal(30 + S, (2, S, jcfg.d_model))
    jmix = getattr(jxlstm, f"{kind}_mixer")
    want = jax.jit(lambda p, x: jmix(p, x, jcfg, CHUNK))(p, x)
    got = getattr(xlstm, f"{kind}_mixer")(
        param.params_from_numpy(p, device="cpu"), torch.from_numpy(x), tcfg,
        CHUNK)
    assert got.shape == (2, S, tcfg.d_model)
    _close(got, want)


# ---------------------------------------------------------------------------
# The decode steps
# ---------------------------------------------------------------------------

def _mid_state(kind, jcfg, B):
    """A mid-sequence state: random C, n, c, h; n > 0 for sLSTM; m of
    either sign."""
    H = jcfg.num_heads
    if kind == "mlstm":
        dk = jxlstm.mlstm_dims(jcfg)[1]
        return {"C": _normal(40, (B, H, dk, dk)),
                "n": _normal(41, (B, H, dk)),
                "m": _normal(42, (B, H), 2.0)}
    shape = (B, H, jcfg.d_model // H)
    return {"c": _normal(43, shape), "n": np.abs(_normal(44, shape)) + 0.5,
            "m": _normal(45, shape, 2.0), "h": _normal(46, shape, 0.3)}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("start", ["zeros", "mid-sequence"])
def test_decode_step_matches_reference(kind, start):
    """Three steps from a zero cache (the decode path's start, ``m = 0``)
    or a mid-sequence state: the outputs and the states, which the port
    writes into its cache in place."""
    jcfg, tcfg = _cfgs()
    B = 2
    p = _mixer_params(kind)
    tp = param.params_from_numpy(p, device="cpu")
    if start == "zeros":
        init = getattr(jxlstm, f"{kind}_init_state")(jcfg, B)
        jstate = {k: np.zeros_like(np.asarray(a)) for k, a in init.items()}
    else:
        jstate = _mid_state(kind, jcfg, B)
    tstate = {k: torch.from_numpy(np.array(a)) for k, a in jstate.items()}
    held = dict(tstate)
    jstep = jax.jit(lambda p, x, st: getattr(jxlstm, f"{kind}_decode_step")(
        p, x, st, jcfg))
    tstep = getattr(xlstm, f"{kind}_decode_step")
    for t in range(3):
        x = _normal(50 + t, (B, 1, jcfg.d_model))
        want, jstate = jstep(p, x, jstate)
        got, out_state = tstep(tp, torch.from_numpy(x), tstate, tcfg)
        assert out_state is tstate
        _close(got, want, f"out, step {t}")
        for k in jstate:
            assert tstate[k] is held[k]          # written in place
            _close(tstate[k], jstate[k], f"{k}, step {t}")


# ---------------------------------------------------------------------------
# The model: prefill, decode and serving
# ---------------------------------------------------------------------------

def _reference_decode(jp, jcfg, toks):
    """The reference's teacher-forced decode from its zero cache: the
    logits (B, S, V) and the final cache."""
    B, S = toks.shape
    cache = jax.tree_util.tree_map(
        jnp.zeros_like, jparam.init_params(
            jtf.decode_cache_specs(jcfg, B, S), jax.random.PRNGKey(1)))
    jstep = jax.jit(lambda p, b, c: j_decode_step(p, b, c, jcfg))
    outs = []
    for t in range(S):
        logits, cache = jstep(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                   "t": jnp.int32(t)}, cache)
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, 1), cache


def _port_decode(tp, tcfg, toks):
    B, S = toks.shape
    cache = param.init_params(transformer.decode_cache_specs(tcfg, B, S),
                              torch.Generator(), device="cpu")
    step = steps.make_decode_step(tcfg)
    outs = []
    for t in range(S):
        logits, cache = step(tp, {"tokens": torch.from_numpy(
            toks[:, t:t + 1]), "t": t}, cache)
        outs.append(logits[:, 0].numpy())
    return np.stack(outs, 1), cache


def _reference_full_logits(jp, jcfg, toks):
    hidden, _, _ = jtf.forward_hidden(jp, {"tokens": jnp.asarray(toks)},
                                      jcfg)
    return np.asarray(jnp.einsum("bsd,dv->bsv", hidden, jp["head"]["w"]))


@pytest.mark.parametrize("b_if", [None, -3.0])
def test_prefill_and_decode_match_reference(b_if):
    """The prefill's last logits and hidden states, and 16 teacher-forced
    decode steps (logits and the final cache), each against the
    reference's own path.  With ``b_if = -3`` the reference's decode and
    prefill disagree (their stabilisers start at 0 and -1e30): the port
    matches each, not each other."""
    jp, tp = _model_params(b_if)
    jcfg, tcfg = _cfgs()
    B, S = 2, 16
    toks = _tokens(7, jcfg.vocab_size, B, S)
    want = jtf.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = steps.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(
        toks)})
    assert got.shape == (B, 1, tcfg.vocab_size)
    _close_logits(got.numpy(), want, "prefill")
    hidden = transformer.forward_hidden(tp, {"tokens": torch.from_numpy(
        toks)}, tcfg)
    full = (hidden @ tp["head"]["w"]).numpy()
    want_full = _reference_full_logits(jp, jcfg, toks)
    _close_logits(full, want_full, "full-sequence logits")

    want_dec, jcache = _reference_decode(jp, jcfg, toks)
    got_dec, tcache = _port_decode(tp, tcfg, toks)
    _close_logits(got_dec, want_dec, "decode")
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jcache),
                            jax.tree_util.tree_leaves(
                                jax.tree_util.tree_map(
                                    lambda a: a.numpy(), tcache))):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))

    gap = np.abs(want_dec[:, 0] - want_full[:, 0]).max()
    if b_if is None:
        _close_logits(want_dec, want_full, "reference, decode vs prefill")
    else:
        assert gap > 1.0, gap


def test_generate_gives_the_reference_tokens():
    """Greedy tokens of ``serve.generate`` on the reference's weights equal
    the reference's serve loop (``repro/launch/serve.py:39-58``)."""
    jp, tp = _model_params()
    jcfg, tcfg = _cfgs()
    prompt = _tokens(11, jcfg.vocab_size, 2, 6)
    B, P, new = 2, 6, 6
    cache = jax.tree_util.tree_map(
        jnp.zeros_like, jparam.init_params(
            jtf.decode_cache_specs(jcfg, B, 32), jax.random.PRNGKey(0)))
    step = jax.jit(lambda p, b, c: j_decode_step(p, b, c, jcfg))
    for t in range(P):
        logits, cache = step(jp, {"tokens": jnp.asarray(prompt[:, t:t + 1]),
                                  "t": jnp.int32(t)}, cache)
    want_prompt = np.asarray(logits)
    out = []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + new):
        logits, cache = step(jp, {"tokens": tok, "t": jnp.int32(t)}, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok[:, 0])
    want = np.asarray(jnp.stack(out, axis=1))
    got = serve.generate(tp, tcfg, torch.from_numpy(prompt), new, 32)
    _close_logits(got.prompt_logits.numpy(), want_prompt, "prompt logits")
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_serve_main_serves_xlstm_on_the_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--device", "cpu", "--tokens", "3",
                      "--prompt-len", "4"])
    assert res.tokens.shape == (2, 3)
    assert "decoded 3 tokens x batch 2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Training takes the xLSTM blocks
# ---------------------------------------------------------------------------

def test_scan_wrappers_take_an_input_that_requires_grad():
    """K9 and K10 are differentiable: under grad mode an input that
    requires grad gives an output with a gradient, whose values are
    those of the no-grad launch; a malformed gate still raises."""
    B, S, H, D = 1, 4, 2, 8
    q, k, v = (torch.randn(B, S, H, D) for _ in range(3))
    gates = [torch.randn(B, S, H) for _ in range(2)]
    xs = [torch.randn(B, S, H, D) for _ in range(4)]
    rs = [0.02 * torch.randn(H, D, D) for _ in range(4)]
    with torch.no_grad():
        h_m = xlstm_scan.mlstm_scan(q, k, v, *gates)
        h_s = xlstm_scan.slstm_scan(*xs, *rs)
    got_m = xlstm_scan.mlstm_scan(q.requires_grad_(), k, v, *gates)
    got_s = xlstm_scan.slstm_scan(*xs, rs[0].requires_grad_(), *rs[1:])
    assert got_m.requires_grad and got_s.requires_grad
    assert torch.equal(got_m.detach(), h_m)
    assert torch.equal(got_s.detach(), h_s)
    assert torch.autograd.grad(got_m.sum(), q)[0].shape == q.shape
    assert torch.autograd.grad(got_s.sum(), rs[0])[0].shape == rs[0].shape
    with pytest.raises(ValueError, match="log_f must be"):
        xlstm_scan.mlstm_scan(q.detach(), k, v, gates[0], gates[1][:, :2])


def test_check_trainable_takes_xlstm_and_refuses_the_rest():
    for cfg in (configs.get_arch(ARCH), configs.get_arch(ARCH).reduced()):
        steps.check_trainable(cfg)
        steps.make_fedavg_step(cfg)
    for arch in ("internvl2-26b",):
        with pytest.raises(ValueError, match="not yet ported"):
            steps.check_trainable(configs.get_arch(arch))
    shape = configs.get_shape("decode_32k")
    steps.prefill_batch_specs(configs.get_arch(ARCH), shape)
    steps.abstract_decode_cache(configs.get_arch(ARCH), shape)
