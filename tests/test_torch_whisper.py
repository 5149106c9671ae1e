"""The port's encoder-decoder (whisper-tiny) against the JAX package, on
the CPU.

The reduced preset (2 encoder + 2 decoder layers, d=256, 4 heads, V=512;
the trainer's own reduced preset d=128, V=256); the reference's
``init_params`` draws the weights and ``params_from_numpy`` carries them
across; tokens, labels and frames come from numpy.  Held: the spec
trees, ``gelu_mlp``, ``forward_hidden`` / ``loss_fn`` with as many
frames as tokens and with more, random frames and the trainer's zero
frames, ``prefill`` of one BOS token, ``decode_step`` on equal random
``ck`` / ``cv``, the serve loop without frames against the reference's,
``generate`` with frames against the port's own teacher-forced forward
(the reference's decoder never sees its encoder in decode, ROADMAP R5),
the gradient under every remat policy, the fedavg and feddane steps,
the trainer against the reference's ``launch/train.py``, and the card's
K7 route (``flash_gqa`` into K7's Function, here on its plain versions)
under the trainer's ``vmap(grad)`` with T frames != S tokens.

Tolerances: logits, hidden states, losses and caches atol 1e-5 (f32
sums in another order than XLA's through 4 layers); gradients 1e-5 x
each leaf's own max |g| (zero frames put the encoder's leaves behind
``rsqrt(1e-6)`` = 1,000 at every ``rms_norm``); greedy tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from torch.func import grad, vmap

from repro import configs as jconfigs
from repro.configs.base import FederatedConfig as JConfig
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.core import pytree as pt
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention
from repro_torch.models import layers as L
from repro_torch.models import param, transformer

ARCH = "whisper-tiny"
ATOL = 1e-5
REL = 1e-5

_CACHE = {}


def _model():
    """(reference cfg, port cfg, reference params, port params) at the
    reduced preset."""
    if "model" not in _CACHE:
        jcfg = jconfigs.get_arch(ARCH).reduced()
        tcfg = configs.get_arch(ARCH).reduced()
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        tp = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
        _CACHE["model"] = (jcfg, tcfg, jp, tp)
    return _CACHE["model"]


def _batch(seed, B, S, T, frames="random", vocab=512, d=256):
    """numpy tokens, labels (B, S) (the first 3 labels of row 0 -1) and
    frames (B, T, d): N(0, 1) or zeros."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    f = (rng.normal(size=(B, T, d)) if frames == "random"
         else np.zeros((B, T, d)))
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels, "frames": f.astype(np.float32)}


def _tt(tree):
    return pt.tmap(torch.from_numpy, tree)


def _close(got, want, atol=ATOL):
    g, w = pt.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)


def _rel_close(got, want, floor=1e-30):
    """Leaf by leaf within REL x max(``floor``, the leaf's own max
    |want|)."""
    g, w = pt.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), floor)
        err = float(np.abs(a.detach().numpy() - b).max())
        assert err <= REL * scale, f"{err} > {REL} x {scale}"


def _spec_rows(tree, is_leaf):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): (tuple(s.shape), tuple(s.axes), s.init,
                                      s.scale) for p, s in leaves}


# ---------------------------------------------------------------------------
# Specs and the GELU MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_specs_match_reference(reduced):
    """The spec tree -- paths (``encoder``, ``enc_final_norm``, each
    decoder block's ``ln_x``, ``xattn``, ``mlp``), shapes, axes,
    initialisers -- and the parameter count; the decode cache's ``ck`` /
    ``cv`` of ``enc_len`` rows."""
    j, t = jconfigs.get_arch(ARCH), configs.get_arch(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    tspecs = transformer.model_specs(t)
    assert _spec_rows(tspecs, lambda x: isinstance(x, param.ParamSpec)) == \
        _spec_rows(jtf.model_specs(j), jparam.is_spec)
    assert param.param_count(tspecs) == jparam.param_count(
        jtf.model_specs(j))
    assert _spec_rows(transformer.decode_cache_specs(t, 2, 8, 24),
                      lambda x: isinstance(x, param.ParamSpec)) == \
        _spec_rows(jtf.decode_cache_specs(j, 2, 8, 24), jparam.is_spec)
    if not reduced:
        assert param.param_count(tspecs) == 56_371_200


def test_gelu_mlp_matches_reference():
    """The biased GELU MLP in jax.nn.gelu's default (tanh) form."""
    rng = np.random.default_rng(0)
    p = {"w_in": rng.normal(size=(16, 40)) / 4, "b_in": rng.normal(size=40),
         "w_out": rng.normal(size=(40, 16)) / 6, "b_out": rng.normal(size=16)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 2
    want = JL.gelu_mlp(p, x)
    got = L.gelu_mlp(_tt(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Forward, loss, prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", ["random", "zero"])
@pytest.mark.parametrize("T", [16, 24])
def test_forward_and_loss_match_reference(T, frames):
    """``forward_hidden`` and ``loss_fn`` (remat none) of 16 tokens with
    16 or 24 frames, random or the trainer's zeros."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(1, 2, 16, T, frames)
    jh, _, _ = jax.jit(lambda p, b: jtf.forward_hidden(p, b, jcfg, "none"))(
        jp, b)
    th = transformer.forward_hidden(tp, _tt(b), tcfg)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=ATOL, rtol=0)
    jl = jtf.loss_fn(jp, b, jcfg, remat="none")
    tl = transformer.loss_fn(tp, _tt(b), tcfg, remat="none")
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)


def test_prefill_matches_reference():
    """The reference's serving batch: 24 frames, one BOS token (B, 1)."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(2, 2, 1, 24)
    del b["labels"]
    want = jtf.prefill(jp, b, jcfg)
    got = transformer.prefill(tp, _tt(b), tcfg)
    assert got.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_decode_steps_match_reference():
    """3 decode steps from equal caches (k, v zeros; ``ck``, ``cv`` of 24
    random rows): logits and every cache leaf."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(3)
    specs = jtf.decode_cache_specs(jcfg, 2, 8, 24)
    cache = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) if s.shape[2] == 24
                   else np.zeros(s.shape)).astype(np.float32),
        specs, is_leaf=jparam.is_spec)
    jc = jax.tree_util.tree_map(jnp.asarray, cache)
    tc = param.params_from_numpy(cache, device="cpu")
    step = jax.jit(lambda p, b, c: jtf.decode_step(p, b, c, jcfg))
    toks = rng.integers(0, jcfg.vocab_size, (3, 2, 1)).astype(np.int32)
    for t in range(3):
        jl, jc = step(jp, {"tokens": toks[t], "t": jnp.int32(t)}, jc)
        tl, tc = transformer.decode_step(
            tp, {"tokens": torch.from_numpy(toks[t]), "t": t}, tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    _close(tc, jc)


def _reference_serve_loop(jp, jcfg, prompt, tokens, cache_len):
    """The reference's ``launch/serve.py`` loop on ``prompt``: zero caches
    (``ck`` / ``cv`` of ``cache_len`` rows), the prompt teacher-forced
    through the jitted decode step, then greedy tokens."""
    B, P = prompt.shape
    cache = jparam.init_params(
        jtf.decode_cache_specs(jcfg, B, cache_len, cache_len),
        jax.random.PRNGKey(0))
    step = jax.jit(lambda p, b, c: jtf.decode_step(p, b, c, jcfg))
    for t in range(P):
        logits, cache = step(jp, {"tokens": prompt[:, t:t + 1],
                                  "t": jnp.int32(t)}, cache)
    out = []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + tokens):
        logits, cache = step(jp, {"tokens": tok, "t": jnp.int32(t)}, cache)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok[:, 0])
    return np.asarray(jnp.stack(out, axis=1))


def test_generate_without_frames_matches_reference_serve_loop():
    jcfg, tcfg, jp, tp = _model()
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = _reference_serve_loop(jp, jcfg, prompt, 6, 16)
    got = serve.generate(tp, tcfg, torch.from_numpy(prompt), 6, 16)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


def test_generate_with_frames_matches_teacher_forcing():
    """With frames the decode path's cross-attention reads ``ck`` / ``cv``
    filled from the encoder: its logits after every prompt token equal
    the teacher-forced forward's at that position, and each greedy token
    is the forward's argmax over the prompt and the tokens before it.
    Without frames the cross-attention sees nothing of the encoder."""
    _, tcfg, _, tp = _model()
    b = _tt(_batch(5, 2, 6, 20))
    prompt, frames = b["tokens"], b["frames"]
    hidden = transformer.forward_hidden(tp, b, tcfg)
    forced = transformer._logits(tp, hidden, tcfg)           # (2, 6, V)
    cache = pt.tmap(lambda s: torch.zeros(s.shape),
                    transformer.decode_cache_specs(tcfg, 2, 16, 20))
    transformer.fill_cross_cache(tp, frames, cache, tcfg)
    for t in range(prompt.shape[1]):
        logits, cache = transformer.decode_step(
            tp, {"tokens": prompt[:, t:t + 1], "t": t}, cache, tcfg)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   forced[:, t].detach().numpy(), atol=ATOL,
                                   rtol=0)
    gen = serve.generate(tp, tcfg, prompt, 5, 16, frames=frames)
    # the loop feeds the argmax after the prompt, then keeps each step's
    fed = torch.cat([gen.prompt_logits.argmax(-1), gen.tokens], dim=1)
    seq = torch.cat([prompt, fed.to(prompt.dtype)], dim=1)
    full = transformer._logits(tp, transformer.forward_hidden(
        tp, {"tokens": seq, "frames": frames}, tcfg), tcfg)
    assert torch.equal(full[:, 5:-1].argmax(-1), fed)
    without = serve.generate(tp, tcfg, prompt, 5, 16)
    assert not torch.equal(gen.prompt_logits, without.prompt_logits)


# ---------------------------------------------------------------------------
# Gradients, steps, the trainer
# ---------------------------------------------------------------------------

_GRADS = {}


@pytest.mark.parametrize("remat,frames", [("none", "random"),
                                          ("full", "random"),
                                          ("dots", "random"),
                                          ("none", "zero")])
def test_grad_matches_reference(remat, frames):
    """``loss_fn``'s gradient (plain autograd through the remat policy's
    checkpoints) against ``jax.grad`` of the reference's, 16 tokens and
    24 frames; every leaf within 1e-5 x its own max |g|.  The three
    policies give the port the same gradient."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(6, 2, 16, 24, frames)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, b, jcfg, remat=remat)))(jp)
    tl, tg = steps.value_and_grad(
        lambda p: transformer.loss_fn(p, _tt(b), tcfg, remat=remat), tp)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    _rel_close(tg, jg)
    if frames == "random":
        _GRADS[remat] = tg
        if len(_GRADS) == 3:
            for a, c in zip(pt.leaves(_GRADS["none"]),
                            pt.leaves(_GRADS["full"])):
                assert torch.equal(a, c)
            for a, c in zip(pt.leaves(_GRADS["none"]),
                            pt.leaves(_GRADS["dots"])):
                assert torch.equal(a, c)


@pytest.mark.parametrize("algo", ["fedavg", "feddane"])
def test_round_step_matches_reference(algo):
    """One step of each builder (remat full) on one batch with frames
    (g_t 0.01 everywhere for feddane) against the reference's jitted
    step: the new state within 1e-5 and the loss."""
    jcfg, tcfg, jp, _ = _model()
    b = _batch(7, 2, 16, 24)
    kw = dict(eta=0.05, remat="full")
    if algo == "fedavg":
        js = {"params": jp}
    else:
        kw["mu"] = 0.1
        js = {"params": jp, "anchor": jp, "g_t": jax.tree_util.tree_map(
            lambda x: 0.01 * jnp.ones_like(x), jp)}
    ts = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    js, jm = jax.jit(jsteps.STEP_BUILDERS[algo](jcfg, **kw))(js, b)
    ts, tm = steps.STEP_BUILDERS[algo](tcfg, **kw)(ts, _tt(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=ATOL, rtol=0)
    assert sorted(ts) == sorted(js)
    _close(ts, js)


TRAIN_ARGV = ["--arch", ARCH, "--num-devices", "4", "--devices-per-round",
              "2", "--local-epochs", "1", "--batch-size", "2", "--seq-len",
              "16", "--samples-per-device", "8", "--rounds", "2",
              "--seed", "0"]


def test_train_main_matches_reference(monkeypatch, capsys):
    """``launch/train.py``'s ``main`` against the reference's on the same
    argv (the reduced preset, d=128, V=256; zero frames; feddane N=4 K=2
    E=1 B=2 S=16, 2 rounds at its lr 0.05), the port's weights the
    reference's draw: the selections, each round's global loss within
    1e-5, and the params within 1e-5 x max(1, each leaf's max |p|).  The
    zero frames meet every encoder ``rms_norm`` at 0, whose derivative is
    ``rsqrt(1e-6)`` = 1,000, so the encoder's MLP biases reach ~2.8e6 in
    2 rounds, and a 1e-7 relative nudge of the weights moves them by
    1.24e-6 of that in the port's own run (an additive 1e-7 nudge, which
    leaves the zero point, by all of it)."""
    jrounds, jsel = [], []

    class Recorder(jtrain.FederatedTrainer):
        def _sample(self):
            s = super()._sample()
            jsel.append(np.asarray(s).tolist())
            return s

        def round(self, st):
            st = super().round(st)
            jrounds.append((st.params, self.global_loss(st.params)))
            return st

    monkeypatch.setattr(jtrain, "FederatedTrainer", Recorder)
    jtrain.main(TRAIN_ARGV)
    jcfg = jconfigs.get_arch(ARCH).reduced(num_layers=2, d_model=128,
                                           vocab_size=256)
    jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(train, "init_params", lambda specs, gen, device:
                        param.params_from_numpy(jax.tree_util.tree_map(
                            np.asarray, jp), device=device))
    tsel, orig = [], train.FederatedTrainer._sample

    def sample(self):
        s = orig(self)
        tsel.append(np.asarray(s).tolist())
        return s

    monkeypatch.setattr(train.FederatedTrainer, "_sample", sample)
    res = train.main(TRAIN_ARGV + ["--device", "cpu"])
    assert "stub frontends" in capsys.readouterr().out
    assert tsel == jsel
    _rel_close(res.state.params, jrounds[-1][0], floor=1.0)
    np.testing.assert_allclose(res.losses, [r[1] for r in jrounds],
                               atol=ATOL, rtol=0)
    assert max(float((a - torch.from_numpy(np.array(b))).abs().max())
               for a, b in zip(
        pt.leaves(res.state.params),
        jax.tree_util.tree_leaves(jp))) > 10 * ATOL


def test_k7_route_under_vmap_grad_matches_plain(monkeypatch):
    """The card's route (``flash_gqa`` into K7's Function, its plain
    versions here) under the trainer's ``vmap(grad)`` over 3 clients, 16
    tokens against 24 frames, random and zero: the plain attention's
    gradients within 1e-5 x each leaf's max |g|, with one K7 forward and
    one K7 backward call for the 3 clients a layer's attention (2
    encoder, 2 decoder self, 2 cross)."""
    _, tcfg, _, tp = _model()
    b = {k: v[:, None] for k, v in _batch(8, 3, 16, 24).items()}
    b["frames"][2] = 0.0
    lf = functools.partial(transformer.loss_fn, cfg=tcfg, remat="none")
    run = lambda: vmap(grad(lambda p, b: lf(p, b)),  # noqa: E731
                       in_dims=(None, 0))(tp, _tt(b))
    want = run()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = (flash_attention.flash_attention_3d_fwd,
                flash_attention.flash_attention_3d_bwd)

    def count(key, fn):
        def spy(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(flash_attention, "flash_attention_3d_fwd",
                        count("fwd", fwd))
    monkeypatch.setattr(flash_attention, "flash_attention_3d_bwd",
                        count("bwd", bwd))
    monkeypatch.setattr(attention, "attention",
                        lambda q, k, v, causal, window=0:
                        attention.flash_gqa(q, k, v, causal=causal))
    got = run()
    assert calls == {"fwd": 6, "bwd": 6}
    _rel_close(got, pt.tmap(lambda x: x.numpy(), want))
