"""The port's LM training against the JAX package, on the CPU.

Reduced configs (qwen1.5-0.5b tied and yi-9b untied, 2 layers,
d_model=64, 4 heads on 2 KV heads, V=128; the hybrid jamba-v0.1-52b at
one repeat of its 8-block pattern, expert d_ff 128); the reference's
``init_params`` draws the weights and ``params_from_numpy`` carries them
across; tokens and labels come from numpy.  Held: ``loss_fn`` and its
gradient under every remat policy, the chunked cross-entropy, the three
round steps, the train specs, the federated LM data and trainer, the
training driver, the pod-as-client round (one process and two gloo
ranks), and K7's autograd Function on the CPU (its plain forward and
the explicit backward formula) against the reference's attention.

Tolerances: atol 1e-5 (f32 sums in another order through 2 layers and
3 steps); the pod round 2e-5, the reference's own bar for it; the
trainer's flat and per_leaf modes and the vmap fold bit for bit.
jamba's gradient leaves reach |g| ~ 10 (8 layers, 7 of them mamba), so
its leaves are held to 1e-5 x max(1, max |g|): 1e-5 where |g| <= 1, as
the others, and the same relative bar beyond.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from torch.func import grad, vmap

import _torch_podfed_child as podfed_child
from repro import configs as jconfigs
from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.kernels import ref as jref
from repro.launch import podfed as jpodfed
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import use_mesh
from repro.models import layers as JL
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core import sharding
from repro_torch.core.client import make_batched_solver
from repro_torch.data.batching import stack_device_batches
from repro_torch.kernels import dane_update, flash_attention, ref
from repro_torch.launch import podfed, steps, train
from repro_torch.models import layers as L
from repro_torch.models import param, transformer

ATOL = 1e-5
POD_ATOL = 2e-5
REDUCE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              vocab_size=128)
ARCHS = {"qwen": "qwen1.5-0.5b", "yi": "yi-9b",       # tied, untied
         "jamba": "jamba-v0.1-52b"}                   # hybrid
#: Per-name changes to REDUCE: jamba at one repeat of its pattern.
REDUCE_FOR = {"jamba": dict(num_layers=1, d_ff=128)}
DENSE = ["qwen1.5-0.5b", "yi-9b", "minitron-8b", "phi4-mini-3.8b"]
MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
HYBRID = ["jamba-v0.1-52b"]
XLSTM = ["xlstm-350m"]
ENC_DEC = ["whisper-tiny"]
NOT_PORTED = ["internvl2-26b"]

_CACHE = {}


def _model(name):
    """(reference cfg, port cfg, reference params, port params)."""
    if name not in _CACHE:
        arch = ARCHS[name]
        kw = dict(REDUCE, **REDUCE_FOR.get(name, {}))
        jcfg = jconfigs.get_arch(arch).reduced(**kw)
        tcfg = configs.get_arch(arch).reduced(**kw)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        tp = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
        _CACHE[name] = (jcfg, tcfg, jp, tp)
    return _CACHE[name]


def _batch(seed, B, S, vocab=128, ignore=3):
    """numpy tokens and labels (B, S); the first ``ignore`` labels of
    row 0 are -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labs = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labs[0, :ignore] = -1
    return {"tokens": toks, "labels": labs}


def _t(tree):
    return pt.tmap(torch.from_numpy, tree) if isinstance(tree, dict) \
        else torch.from_numpy(tree)


def _close(got, want, atol=ATOL, scaled=False):
    """Leaf by leaf within ``atol``; ``scaled``: within ``atol`` x
    max(1, the leaf's max |want|)."""
    g, w = pt.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        tol = atol * max(1.0, float(np.abs(b).max())) if scaled else atol
        np.testing.assert_allclose(a.detach().numpy(), b, atol=tol, rtol=0)


@pytest.fixture
def small_chunk(monkeypatch):
    """Both packages' chunked cross-entropy at chunk=8, so S=16 takes
    the two-chunk path."""
    monkeypatch.setattr(L, "chunked_softmax_xent", functools.partial(
        L.chunked_softmax_xent, chunk=8))
    monkeypatch.setattr(JL, "chunked_softmax_xent", functools.partial(
        JL.chunked_softmax_xent, chunk=8))


# ---------------------------------------------------------------------------
# The loss and the chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", ["one", "two"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grad_match_reference(name, remat, chunks, request):
    """``loss_fn`` and its gradient (plain autograd, through the remat
    policy's checkpoints) against ``jax.value_and_grad`` of the
    reference's, with -1 labels; S=16 in one chunk, or two of 8."""
    if chunks == "two":
        request.getfixturevalue("small_chunk")
    jcfg, tcfg, jp, tp = _model(name)
    b = _batch(1, 2, 16)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, b, jcfg, remat=remat))(jp)
    tl, tg = steps.value_and_grad(
        lambda p: transformer.loss_fn(p, _t(b), tcfg, remat=remat), tp)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    _close(tg, jg, scaled=name == "jamba")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("chunk", [16, 8, 5])
@pytest.mark.parametrize("transpose", [True, False])
def test_chunked_xent_matches_reference(transpose, chunk, remat):
    """S=16 in one chunk (chunk=16: ``S <= chunk``; chunk=5: ``S %
    chunk``) or two of 8, tied or head weights; value and both
    gradients, with and without the chunk checkpoints."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 16, 12)).astype(np.float32)
    w = rng.normal(size=(40, 12) if transpose else (12, 40)).astype(
        np.float32)
    labels = rng.integers(0, 40, (2, 16)).astype(np.int32)
    labels[1, 5:9] = -1

    def jf(h, w):
        return JL.chunked_softmax_xent(h, w, labels, transpose=transpose,
                                       chunk=chunk)

    jl, (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(h, w)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = L.chunked_softmax_xent(th, tw, torch.from_numpy(labels),
                                transpose=transpose, chunk=chunk,
                                remat=remat)
    tgh, tgw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), atol=ATOL)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), atol=ATOL)


def test_all_labels_ignored_gives_zero():
    """Every label -1: the count clamps to 1 and the loss is 0."""
    h = torch.ones(1, 4, 3)
    w = torch.ones(5, 3)
    out = L.chunked_softmax_xent(h, w, torch.full((1, 4), -1),
                                 transpose=True)
    assert float(out) == 0.0


def test_unknown_remat_policy_is_refused():
    _, tcfg, _, tp = _model("qwen")
    with pytest.raises(ValueError, match="remat policy"):
        transformer.loss_fn(tp, _t(_batch(0, 1, 8)), tcfg, remat="some")


def test_prefill_keeps_inference_mode_and_loss_takes_grads():
    """``forward_hidden`` records a graph; prefill still runs without."""
    _, tcfg, _, tp = _model("qwen")
    leaf = pt.leaves(tp)[0].detach().requires_grad_(True)
    p = pt.unflatten(pt.flatten(tp)[1], [leaf] + pt.leaves(tp)[1:])
    toks = _t(_batch(0, 1, 8))["tokens"]
    assert transformer.forward_hidden(p, {"tokens": toks}, tcfg).requires_grad
    assert not transformer.prefill(p, {"tokens": toks}, tcfg).requires_grad


# ---------------------------------------------------------------------------
# Train steps and specs
# ---------------------------------------------------------------------------

def _step_state(jp, algo):
    g0 = jax.tree_util.tree_map(lambda x: 0.01 * jnp.ones_like(x), jp)
    return {"params": jp} if algo == "fedavg" else \
        {"params": jp, "anchor": jp, "g_t": g0}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("algo", sorted(jsteps.STEP_BUILDERS))
def test_round_steps_match_reference(algo, remat):
    """Each step builder over 3 steps on one batch (g_t starts at 0.01
    everywhere) against the reference's jitted step: the new state and
    the loss, atol 1e-5; the input state untouched."""
    jcfg, tcfg, jp, tp = _model("qwen")
    kw = dict(eta=0.05, remat=remat)
    if algo != "fedavg":
        kw["mu"] = 0.1
    b = _batch(3, 2, 16)
    jstep = jax.jit(jsteps.STEP_BUILDERS[algo](jcfg, **kw))
    tstep = steps.STEP_BUILDERS[algo](tcfg, **kw)
    js = _step_state(jp, algo)
    ts = param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    first = pt.tmap(torch.clone, ts)
    for _ in range(3):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _t(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL, rtol=0)
    assert sorted(ts) == sorted(js)
    _close(ts, js)
    nxt = tstep(first, _t(b))[0]
    assert all(torch.equal(a, c) for a, c in zip(
        pt.leaves(first), pt.leaves(param.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, _step_state(jp, algo)),
            device="cpu"))))
    assert not torch.equal(pt.leaves(nxt["params"])[1],
                           pt.leaves(first["params"])[1])


def _spec_rows(tree, is_leaf=None):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), tuple(s.shape),
             str(s.dtype).replace("torch.", "")) for p, s in leaves]


def _param_rows(tree, is_leaf):
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), tuple(s.shape), tuple(s.axes))
            for p, s in leaves]


@pytest.mark.parametrize("arch", DENSE + MOE + HYBRID + XLSTM + ENC_DEC)
def test_train_specs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_arch(arch), configs.get_arch(arch)
    is_sd = lambda x: isinstance(x, steps.ShapeDtype)  # noqa: E731
    is_ps = lambda x: isinstance(x, param.ParamSpec)  # noqa: E731
    for algo in ("feddane", "fedavg"):
        assert _param_rows(steps.train_state_specs(tcfg, algo), is_ps) == \
            _param_rows(jsteps.train_state_specs(jcfg, algo),
                        lambda x: isinstance(x, jparam.ParamSpec))
        assert _spec_rows(steps.abstract_train_state(tcfg, algo), is_sd) == \
            _spec_rows(jsteps.abstract_train_state(jcfg, algo))
        assert _spec_rows(steps.abstract_train_state(
            tcfg, algo, dtype=torch.float32), is_sd) == _spec_rows(
            jsteps.abstract_train_state(jcfg, algo, dtype=jnp.float32))
    for shape in sorted(jconfigs.INPUT_SHAPES):
        js, ts = jconfigs.get_shape(shape), configs.get_shape(shape)
        assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
                for k, v in steps.train_batch_specs(tcfg, ts).items()} == \
            {k: (tuple(v.shape), str(v.dtype))
             for k, v in jsteps.train_batch_specs(jcfg, js).items()}


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_train_specs_refuse_the_rest(arch):
    cfg = configs.get_arch(arch)
    shape = configs.get_shape("train_4k")
    for fn in (lambda: steps.train_batch_specs(cfg, shape),
               lambda: steps.train_state_specs(cfg),
               lambda: steps.abstract_train_state(cfg)):
        with pytest.raises(ValueError, match="not yet ported"):
            fn()


# ---------------------------------------------------------------------------
# The federated LM data, trainer and driver
# ---------------------------------------------------------------------------

def test_make_lm_fed_data_matches_reference():
    """Tokens and labels, every device's padded batch stack, bitwise."""
    want = jtrain.make_lm_fed_data(5, 17, 2, 8, seed=3)
    got = train.make_lm_fed_data(5, 17, 2, 8, seed=3, device="cpu")
    assert got.num_devices == want.num_devices
    assert got.weights == want.weights
    for k in range(want.num_devices):
        for key, arr in want.device_batches(k).items():
            np.testing.assert_array_equal(
                got.device_batches(k)[key].numpy(), np.asarray(arr))


LM_FED = dict(num_devices=4, devices_per_round=2, local_epochs=1,
              learning_rate=0.05, mu=0.01, seed=0)


def _lm_setting():
    """tests/test_system.py's transformer round: qwen reduced to 1
    layer, d=64, V=128; 4 devices of 8 samples, S=16, B=2."""
    key = ("lm", 1)
    if key not in _CACHE:
        kw = dict(num_layers=1, d_model=64, vocab_size=128)
        jcfg = jconfigs.get_arch("qwen1.5-0.5b").reduced(**kw)
        tcfg = configs.get_arch("qwen1.5-0.5b").reduced(**kw)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        _CACHE[key] = (jcfg, tcfg, jp)
    return _CACHE[key]


def _jloss(jcfg):
    def loss_fn(p, b):
        return jtf.loss_fn(p, {"tokens": b["tokens"][:, :-1],
                               "labels": b["labels"][:, :-1]}, jcfg,
                           remat="none")
    return loss_fn


def _rounds(trainer, params, n=2):
    drawn, orig = [], trainer._sample

    def sample():
        s = orig()
        drawn.append(np.asarray(s).tolist())
        return s

    trainer._sample = sample
    st, losses = trainer.init(params), []
    for _ in range(n):
        st = trainer.round(st)
        losses.append(trainer.global_loss(st.params))
    return st, drawn, losses


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", ["feddane", "fedprox", "fedavg"])
def test_lm_trainer_matches_reference(algo, engine):
    """2 rounds of the transformer through ``FederatedTrainer`` against
    the reference's python driver: the same selections, params and
    global losses within 1e-5."""
    jcfg, tcfg, jp = _lm_setting()
    jdata = jtrain.make_lm_fed_data(4, 17, 2, 8, seed=0)
    jtr = JTrainer(_jloss(jcfg), jdata,
                   JConfig(algorithm=algo, engine="loop",
                           round_driver="python", **LM_FED))
    want, jdrawn, jlosses = _rounds(jtr, jp)
    tdata = train.make_lm_fed_data(4, 17, 2, 8, seed=0, device="cpu")
    ttr = FederatedTrainer(train.make_lm_loss(tcfg), tdata,
                           FederatedConfig(algorithm=algo, engine=engine,
                                           round_driver="python", **LM_FED),
                           device="cpu")
    got, tdrawn, tlosses = _rounds(ttr, param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    assert tdrawn == jdrawn
    _close(got.params, want.params)
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL, rtol=0)
    assert (got.round, got.comm_rounds) == (want.round, want.comm_rounds)


def test_lm_flat_bitwise_equals_per_leaf():
    """The batched solver over 2 devices' LM batches (one step masked):
    flat (K1's plain version) and per_leaf (K4's) bit for bit."""
    _, tcfg, jp = _lm_setting()
    data = train.make_lm_fed_data(4, 17, 2, 8, seed=0, device="cpu")
    batches, valid = stack_device_batches(data, np.array([0, 2]))
    valid[1, 0] = 0.0
    w0 = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")
    rng = np.random.default_rng(1)
    corr = pt.tmap(lambda x: torch.from_numpy(
        (0.01 * rng.normal(size=(2,) + tuple(x.shape))).astype(np.float32)),
        w0)
    out = {}
    for mode in ("flat", "per_leaf"):
        solve = make_batched_solver(train.make_lm_loss(tcfg),
                                    learning_rate=0.05, num_epochs=1,
                                    solver=mode)
        out[mode] = solve(w0, corr, 0.01, batches, valid)
    for a, b in zip(pt.leaves(out["flat"].params),
                    pt.leaves(out["per_leaf"].params)):
        assert torch.equal(a, b)
    assert not torch.equal(pt.leaves(out["flat"].params)[1][0],
                           pt.leaves(w0)[1])


def test_flat_update_refuses_a_device_past_its_count(monkeypatch):
    """K1 counts a device's elements in 32 bits: a longer device segment
    is refused with a clear error (here the limit is lowered)."""
    monkeypatch.setattr(dane_update, "MAX_PER_DEV", 1000)
    w = torch.ones(16, 128)
    with pytest.raises(ValueError, match="32-bit per-device count"):
        dane_update.dane_update_flat(w, w, w, w, 0.1, 0.0, torch.ones(2), 8)


def test_train_main_on_the_cpu(tmp_path, capsys):
    """The driver end to end on the CPU: 2 rounds, a checkpoint each."""
    res = train.main(["--device", "cpu", "--rounds", "2", "--num-devices",
                      "4", "--samples-per-device", "8", "--seq-len", "16",
                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert len(res.losses) == len(res.round_ms) == 2
    assert all(np.isfinite(res.losses))
    assert res.state.round == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000001.msgpack", "ckpt_00000002.msgpack"]
    assert "round    2" in capsys.readouterr().out


def test_train_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "1"])


# ---------------------------------------------------------------------------
# Pods as clients
# ---------------------------------------------------------------------------

POD_KW = dict(num_layers=1, d_model=64, vocab_size=128)


def _pod_setting():
    key = ("pod",)
    if key not in _CACHE:
        jcfg = jconfigs.get_arch("qwen1.5-0.5b").reduced(**POD_KW)
        tcfg = configs.get_arch("qwen1.5-0.5b").reduced(**POD_KW)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        _CACHE[key] = (jcfg, tcfg, jax.tree_util.tree_map(np.asarray, jp))
    return _CACHE[key]


def _pod_state(p_np, pods, seed=5):
    """``pods`` clients: params and anchors apart, g_t zero."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.stack([x + 0.01 * i * rng.normal(size=x.shape)
                            .astype(np.float32) for i in range(pods)]),
        p_np)
    anchor = jax.tree_util.tree_map(
        lambda x: np.stack([x] * pods), p_np)
    g_t = jax.tree_util.tree_map(np.zeros_like, anchor)
    return {"params": params, "anchor": anchor, "g_t": g_t}


def _pod_batch(pods, steps_, seed=6):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 128, (pods, steps_, 2, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_podfed_one_pod_matches_reference():
    """One pod, 2 local steps, against the reference's round on its
    1x1x1 mesh (2e-5): the new state and the loss."""
    jcfg, tcfg, p_np = _pod_setting()
    state, batch = _pod_state(p_np, 1), _pod_batch(1, 2)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    kw = dict(local_steps=2, eta=5e-2, mu=0.01, remat="none")
    with use_mesh(mesh):
        jfn, _ = jpodfed.make_podfed_round_step(jcfg, mesh, **kw)
        jnew, jm = jax.jit(jfn)(state, batch)
    tfn, info = podfed.make_podfed_round_step(tcfg, **kw)
    tnew, tm = tfn(param.params_from_numpy(state, device="cpu"), _t(batch))
    assert info["mesh_devices"] == 1
    _close(tnew, jnew, POD_ATOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=POD_ATOL, rtol=0)


def test_podfed_one_pod_one_step_is_the_feddane_step():
    """With one pod and E=1 the round is ``make_feddane_round_step`` fed
    the anchor's gradient as g_t (the reference's own check)."""
    _, tcfg, p_np = _pod_setting()
    state, batch = _pod_state(p_np, 1), _pod_batch(1, 1)
    tfn, _ = podfed.make_podfed_round_step(tcfg, local_steps=1, eta=1e-2,
                                           mu=0.01, remat="none")
    new, _ = tfn(param.params_from_numpy(state, device="cpu"), _t(batch))
    p = param.params_from_numpy(p_np, device="cpu")
    b = {k: torch.from_numpy(v[0, 0]) for k, v in batch.items()}
    lf = lambda q: transformer.loss_fn(q, b, tcfg, remat="none")  # noqa
    g_anchor = steps.value_and_grad(lf, p)[1]
    want, _ = steps.make_feddane_round_step(tcfg, eta=1e-2, mu=0.01,
                                            remat="none")(
        {"params": p, "anchor": p, "g_t": g_anchor}, b)
    for a, c in zip(pt.leaves(new["params"]), pt.leaves(want["params"])):
        np.testing.assert_allclose(a[0].numpy(), c.numpy(), atol=POD_ATOL)


def test_podfed_one_pod_one_step_is_the_feddane_step_on_jamba():
    """The same for jamba at one repeat of its pattern (7 mamba blocks,
    4 with the MoE FFN): the pod's round is the feddane step."""
    _, tcfg, _, tp = _model("jamba")
    one = pt.tmap(lambda x: x[None], tp)
    b = _batch(6, 2, 16)
    tfn, _ = podfed.make_podfed_round_step(tcfg, local_steps=1, eta=1e-2,
                                           mu=0.01, remat="none")
    new, _ = tfn({"params": one, "anchor": one,
                  "g_t": pt.tmap(torch.zeros_like, one)},
                 {k: torch.from_numpy(v)[None, None] for k, v in b.items()})
    lf = lambda q: transformer.loss_fn(q, _t(b), tcfg, remat="none")  # noqa
    g_anchor = steps.value_and_grad(lf, tp)[1]
    want, _ = steps.make_feddane_round_step(tcfg, eta=1e-2, mu=0.01,
                                            remat="none")(
        {"params": tp, "anchor": tp, "g_t": g_anchor}, _t(b))
    for a, c in zip(pt.leaves(new["params"]), pt.leaves(want["params"])):
        np.testing.assert_allclose(a[0].numpy(), c.numpy(), atol=POD_ATOL)


def _two_pods_by_hand(tcfg, state, batch, eta, mu, local_steps):
    """Alg. 2 over two pods from single-client pieces: each pod's
    anchor gradient, their mean g_t, E DANE steps a pod, the mean."""
    st = param.params_from_numpy(state, device="cpu")
    b = _t(batch)

    def g(p, i, s):
        bi = {k: v[i, s] for k, v in b.items()}
        return steps.value_and_grad(
            lambda q: transformer.loss_fn(q, bi, tcfg, remat="none"), p)[1]

    anchors = [pt.index(st["anchor"], i) for i in range(2)]
    g_a = [g(anchors[i], i, 0) for i in range(2)]
    g_t = pt.scale(pt.add(g_a[0], g_a[1]), 0.5)
    ws = []
    for i in range(2):
        w = pt.index(st["params"], i)
        corr = pt.sub(g_t, g_a[i])
        for s in range(local_steps):
            d = pt.add(pt.add(g(w, i, s), corr),
                       pt.scale(pt.sub(w, anchors[i]), mu))
            w = pt.sub(w, pt.scale(d, eta))
        ws.append(w)
    return pt.scale(pt.add(ws[0], ws[1]), 0.5), g_t


def test_podfed_two_pods_match_hand_computed():
    _, tcfg, p_np = _pod_setting()
    state, batch = _pod_state(p_np, 2), _pod_batch(2, 2)
    w, g_t = _two_pods_by_hand(tcfg, state, batch, 5e-2, 0.01, 2)
    fn, _ = podfed.make_podfed_round_step(tcfg, local_steps=2, eta=5e-2,
                                          mu=0.01, remat="none")
    new, m = fn(param.params_from_numpy(state, device="cpu"), _t(batch))
    for key, want in (("params", w), ("anchor", w), ("g_t", g_t)):
        for a, c in zip(pt.leaves(new[key]), pt.leaves(want)):
            for i in range(2):
                np.testing.assert_allclose(a[i].numpy(), c.numpy(),
                                           atol=POD_ATOL)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="local_steps"):
        fn(param.params_from_numpy(state, device="cpu"),
           {k: v[:, :1] for k, v in _t(batch).items()})


def test_podfed_on_two_gloo_ranks(tmp_path, monkeypatch):
    """Two ranks of one pod each through ``run_on_mesh``: every rank ends
    with the single-process two-pod round's state and loss."""
    _, tcfg, p_np = _pod_setting()
    state, batch = _pod_state(p_np, 2), _pod_batch(2, 2)
    kw = dict(local_steps=2, eta=5e-2, mu=0.01, remat="none")
    fn, _ = podfed.make_podfed_round_step(tcfg, **kw)
    want, wm = fn(param.params_from_numpy(state, device="cpu"), _t(batch))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = sharding.run_on_mesh(
        podfed_child.podfed_round, 2, device="cpu",
        args=("qwen1.5-0.5b", POD_KW, state, batch, kw))
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["info"]["mesh_devices"] == 2
        np.testing.assert_allclose(r["loss"], float(wm["loss"]),
                                   atol=POD_ATOL, rtol=0)
        for a, c in zip(jax.tree_util.tree_leaves(r["state"]),
                        pt.leaves(want)):
            np.testing.assert_allclose(a[0], c[0].numpy(), atol=POD_ATOL)


def test_abstract_podfed_args_shapes():
    _, tcfg, _ = _pod_setting()
    shape = configs.get_shape("train_4k")
    state, batch = podfed.abstract_podfed_args(tcfg, shape, 2, local_steps=4)
    emb = state["params"]["embed"]["embedding"]
    assert emb.shape == (2, 128, 64) and emb.dtype == torch.bfloat16
    assert sorted(state) == ["anchor", "g_t", "params"]
    assert batch["tokens"].shape == (2, 4, 32, 4096)
    with pytest.raises(ValueError, match="too small"):
        podfed.abstract_podfed_args(tcfg, shape, 512, local_steps=4)


# ---------------------------------------------------------------------------
# K7's autograd Function on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_k7_function_grads_match_reference_attention(causal):
    """d/dq, dk, dv of sum(w * K7(q, k, v)) -- the Function's backward,
    the explicit formula from the saved lse -- against ``jax.grad`` of
    the reference's materialised-scores oracle (kernels/ref.py)."""
    rng = np.random.default_rng(7)
    B, H, S, hd = 2, 3, 37, 32
    q, k, v, w = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
                  for _ in range(4))

    def jf(q, k, v):
        return (jref.flash_attention_ref(q, k, v, causal=causal) * w).sum()

    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)

    def tf(q, k, v):
        o = flash_attention.flash_attention_3d(
            q.reshape(B * H, S, hd), k.reshape(B * H, S, hd),
            v.reshape(B * H, S, hd), causal=causal)
        return (o.reshape(B, H, S, hd) * torch.from_numpy(w)).sum()

    tg = grad(tf, argnums=(0, 1, 2))(*map(torch.from_numpy, (q, k, v)))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("t_len", [40, 23])
def test_k7_backward_with_period_matches_autograd(t_len):
    """GQA-folded rows (``causal_period``; T at and under the period):
    the explicit backward against torch autograd through the plain
    forward; dk and dv sum over the folded rows."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(2, 3 * 40, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, t_len, 64)).astype(
        np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(2, 120, 64)).astype(np.float32))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention_3d_ref(*xs, causal=True, causal_period=40)
    want = torch.autograd.grad(o, xs, do)
    got = torch.autograd.grad(flash_attention.flash_attention_3d(
        *xs, causal=True, causal_period=40), xs, do)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_k7_vmap_grad_equals_separate_grads():
    """``vmap(grad)`` over 3 clients (the trainer's fold) equals each
    client's own gradient, bit for bit; unmapped weights broadcast."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(3, 4, 20, 32)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.normal(size=(4, 20, 32)).astype(np.float32))

    def f(q, k, v):
        return (flash_attention.flash_attention_3d(q, k, v, causal=True)
                * w).sum()

    g = vmap(grad(f, argnums=(0, 1, 2)))(q, k, v)
    gk = vmap(grad(f, argnums=(0, 1, 2)), in_dims=(0, None, None))(
        q, k[0], v[0])
    for i in range(3):
        for a, b in zip(g, grad(f, argnums=(0, 1, 2))(q[i], k[i], v[i])):
            assert torch.equal(a[i], b)
        for a, b in zip(gk, grad(f, argnums=(0, 1, 2))(q[i], k[0], v[0])):
            assert torch.equal(a[i], b)


def test_k7_lse_and_double_backward():
    """The forward's log-sum-exp is that of the masked scores; a second
    derivative raises; without grad mode no lse is kept."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 9, 32)).astype(
        np.float32)) for _ in range(3))
    o, lse = flash_attention.flash_attention_3d_fwd(q, k, v, causal=True,
                                                    with_lse=True)
    scores = torch.bmm(q, k.transpose(1, 2)) * 32 ** -0.5
    scores = scores.masked_fill(torch.ones(9, 9).triu(1).bool(), -1e30)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               atol=ATOL)
    assert torch.equal(o, flash_attention.flash_attention_3d(q, k, v))
    with torch.no_grad():
        assert flash_attention.flash_attention_3d_fwd(q, k, v)[1] is None
    x = q.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(flash_attention.flash_attention_3d(
        x, k, v).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(gx.sum(), x)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-9b"])
def test_model_k7_route_under_vmap_grad_matches_plain(arch, monkeypatch):
    """The card's route through the model (``flash_gqa``'s fold into K7's
    Function), here on its plain versions, under the trainer's
    ``vmap(grad)`` over 3 clients and under plain autograd with each
    remat policy: the gradients of the CPU path's plain attention
    within 1e-5 (hd=32, the GQA fold on yi-9b)."""
    from repro_torch.models import attention
    cfg = configs.get_arch(arch).reduced(num_layers=2, d_model=128,
                                         num_heads=4, num_kv_heads=2,
                                         vocab_size=64)
    p = param.init_params(transformer.model_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, 64, (3, 2, 17)).astype(np.int32))
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    lf = lambda p, b: transformer.loss_fn(p, b, cfg, remat="none")  # noqa

    def both(fn):
        plain = fn()
        with monkeypatch.context() as mp:
            mp.setattr(attention, "attention",
                       lambda q, k, v, causal, window=0:
                       attention.flash_gqa(q, k, v, causal=causal))
            return plain, fn()

    want, got = both(lambda: vmap(grad(lf), in_dims=(None, 0))(p, b))
    _close(got, jax.tree_util.tree_map(lambda x: x.numpy(), want))
    for remat in ("none", "full", "dots"):
        want, got = both(lambda: steps.value_and_grad(
            lambda q: transformer.loss_fn(q, pt.index(b, 0), cfg,
                                          remat=remat), p))
        assert abs(float(got[0]) - float(want[0])) <= ATOL
        _close(got[1], jax.tree_util.tree_map(lambda x: x.numpy(), want[1]))
