"""The port's MoE and hybrid training against the JAX package, on the CPU.

Reduced qwen3-moe-235b-a22b (top-2 of 4 experts) and arctic-480b (top-2
of 4, with its dense residual branch): 1 layer, d_model=64, 4 heads on
2 KV heads, expert d_ff 128, V=128; and reduced jamba-v0.1-52b, one
repeat of its 8-block pattern (7 mamba blocks, 4 of them with the MoE
FFN, and an attention block; state N=8) at the same widths, its scan
the plain ``chunked_scan`` that autograd differentiates on the CPU.
The reference's ``init_params``
draws the weights and ``params_from_numpy`` carries them across; tokens
and labels come from numpy.  Held:

- ``moe_ffn`` under ``torch.func.vmap(torch.func.grad(...))`` with
  vmap's per-sample fallback switched off, over the data alone and over
  params and data, at a capacity factor that drops pairs and at one
  that drops none: each client's gradient bit for bit its own; the
  expert products' own vmap rule (``expert_matmul``), which copies no
  weight once a client;
- ``loss_fn``'s gradient under ``vmap(grad)`` (cross-entropy plus the
  blocks' aux) against ``jax.vmap(jax.grad(...))`` of the reference's;
- the three round steps (remat ``"none"`` and ``"full"``) against the
  reference's jitted steps;
- ``FederatedTrainer`` over 2 rounds against the reference's python
  driver: feddane on the loop and batched engines, fedavg on the
  batched engine, the same selections;
- the batched solver's ``flat`` and ``per_leaf`` modes bit for bit;
- podfed with one pod against the reference's round on its 1x1x1 mesh.

Tolerances: atol 1e-5 (f32 sums in another order; the reference jitted),
the pod round 2e-5 (the reference's own bar for it).  jamba's gradient
leaves reach |g| ~ 10, so its gradients (and the g_t they become) are
held to 1e-5 x max(1, the leaf's max |g|).  Its training trajectory
amplifies rounding, in the reference as much as in the port: 1e-7 x
N(0, 1) added to the weights moves the reference's own g_t by more than
1e-4 after one feddane step at eta 0.05, before any expert choice
changes, and past the scaled bar over 3 steps; the port stays within a
tenth of that spread (``test_jamba_steps_track_reference_within_its_
nudge_spread``).  So jamba's cases at that bar take one step of each
builder, and the trainer's lr 1e-3.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._C._functorch as functorch
from _torch_threads import one_torch_thread  # noqa: F401
from torch.func import grad, vmap

from repro import configs as jconfigs
from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.launch import podfed as jpodfed
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.mesh import use_mesh
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.configs.base import FederatedConfig, MoEConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core.client import make_batched_solver
from repro_torch.data.batching import stack_device_batches
from repro_torch.launch import podfed, steps, train
from repro_torch.models import moe, param, transformer

ATOL = 1e-5
POD_ATOL = 2e-5
MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
#: The archs trained here: the MoE archs and the hybrid.
JAMBA = "jamba-v0.1-52b"
ARCHS = MOE + [JAMBA]
#: jamba's steps a step builder is held over, and its trainer's lr
#: (module docstring); the MoE archs take 3 steps and LM_FED's lr.
STEPS = {JAMBA: 1}
LR = {JAMBA: 1e-3}
REDUCE = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=128)

_CACHE = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    if arch not in _CACHE:
        jcfg = jconfigs.get_arch(arch).reduced(**REDUCE)
        tcfg = configs.get_arch(arch).reduced(**REDUCE)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        tp = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
        _CACHE[arch] = (jcfg, tcfg, jp, tp)
    return _CACHE[arch]


def _batch(seed, shape, vocab=128):
    """numpy tokens and labels of ``shape``; the first 3 labels of the
    first row of every client are -1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., 0, :3] = -1
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": labels}


def _t(tree):
    return pt.tmap(torch.from_numpy, tree)


def _close(got, want, atol=ATOL, scaled=False):
    """Leaf by leaf within ``atol``; ``scaled``: within ``atol`` x
    max(1, the leaf's max |want|)."""
    g, w = pt.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        tol = atol * max(1.0, float(np.abs(b).max())) if scaled else atol
        np.testing.assert_allclose(a.detach().numpy(), b, atol=tol, rtol=0)


def _equal(a, b):
    assert all(torch.equal(x, y) for x, y in zip(pt.leaves(a),
                                                 pt.leaves(b)))


@pytest.fixture
def no_vmap_fallback():
    """vmap's per-sample fallback off (an op without a batching rule
    raises) and its warnings raised as errors."""
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield
    functorch._set_vmap_fallback_enabled(was)


# ---------------------------------------------------------------------------
# The layer under vmap(grad)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [16.0, 0.01])
@pytest.mark.parametrize("mapped", ["data", "params and data"])
def test_moe_ffn_vmap_grad_equals_separate_grads(mapped, cf,
                                                 no_vmap_fallback):
    """Three clients' gradients of sum(w * out) + aux (x and every
    weight, Arctic's dense branch included) under ``vmap(grad)`` against
    each client's own ``grad``, bit for bit; no pair dropped at capacity
    factor 16, most at 0.01."""
    cfg = MoEConfig(num_experts=8, top_k=2, dense_residual=True,
                    dense_residual_d_ff=24)
    p = param.init_params(moe.moe_specs(16, 32, cfg),
                          torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 2, 40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 40, 16)).astype(np.float32))
    Cb = moe.group_capacity(40, cfg, cf)
    dropped = [int((moe.slots(moe.route(p, x[i], cfg).idx, 8, Cb)
                    == 8 * Cb).sum()) for i in range(3)]
    assert (sum(dropped) > 0) == (cf < 1)

    def f(p, x):
        out, aux = moe.moe_ffn(p, x, cfg, cf)
        return (out * w).sum() + aux

    if mapped == "data":
        ps = [p] * 3
        got = vmap(grad(f, argnums=(0, 1)), in_dims=(None, 0))(p, x)
    else:
        ps = [pt.tmap(lambda a: a + 0.01 * i, p) for i in range(3)]
        got = vmap(grad(f, argnums=(0, 1)))(
            pt.stack(ps), x)
    for i in range(3):
        _equal(pt.index(got, i), grad(f, argnums=(0, 1))(ps[i], x[i]))


@pytest.mark.parametrize("in_dims", [(0, None), (None, 0), (0, 0)])
def test_expert_matmul_vmap_and_grad_equal_per_sample(in_dims):
    """``expert_matmul`` under ``vmap`` (the rows' operand mapped, the
    weights, or both) and its ``vmap(grad)`` against each sample's own
    ``torch.bmm`` and its gradient: within 1e-6 (the mapped rows make one
    longer product, which the CPU's GEMM may block another way)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 5, 6, 7)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 5, 7, 4)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(5, 6, 4)).astype(np.float32))
    xs = [x[i] if in_dims[0] == 0 else x[0] for i in range(3)]
    ws = [w[i] if in_dims[1] == 0 else w[0] for i in range(3)]
    args = (x if in_dims[0] == 0 else x[0], w if in_dims[1] == 0 else w[0])
    out = vmap(moe.expert_matmul, in_dims=in_dims)(*args)
    f = lambda a, b: (moe.expert_matmul(a, b) * c).sum()  # noqa: E731
    g = vmap(grad(f, argnums=(0, 1)), in_dims=in_dims)(*args)
    close = functools.partial(torch.testing.assert_close, rtol=1e-6,
                              atol=1e-6)
    for i in range(3):
        close(out[i], torch.bmm(xs[i], ws[i]))
        a, b = xs[i].clone().requires_grad_(True), \
            ws[i].clone().requires_grad_(True)
        want = torch.autograd.grad((torch.bmm(a, b) * c).sum(), (a, b))
        close(g[0][i], want[0])
        close(g[1][i], want[1])


def test_vmap_grad_copies_no_expert_weight_a_client():
    """``vmap(grad)`` over the clients' data with the weights unmapped
    (phase A's in_dims): no op makes a tensor of the clients' size of an
    expert weight but the per-client weight gradients themselves
    (functorch's own ``bmm`` rule would copy each weight once a
    client)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = MoEConfig(num_experts=8, top_k=2)
    p = param.init_params(moe.moe_specs(64, 96, cfg),
                          torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 4, 16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16, 64)).astype(np.float32))
    big = 2 * p["w_gate"].numel()
    seen = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(o, torch.Tensor) and o.numel() >= big:
                    seen.append(func.__name__)
            return out

    def f(p, x):
        out, aux = moe.moe_ffn(p, x, cfg)
        return (out * w).sum() + aux

    with Log():
        vmap(grad(f), in_dims=(None, 0))(p, x)
    assert seen and set(seen) <= {"bmm.default", "view.default"}, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_vmap_grad_matches_reference(arch, no_vmap_fallback):
    """``loss_fn`` (remat none, the trainer's) under ``vmap(grad)`` over
    3 clients' (2, 16) batches against ``jax.vmap(jax.grad(...))`` of
    the reference's, jitted."""
    jcfg, tcfg, jp, tp = _model(arch)
    b = _batch(3, (3, 2, 16))
    want = jax.jit(jax.vmap(jax.grad(
        lambda p, b: jtf.loss_fn(p, b, jcfg, remat="none")),
        in_axes=(None, 0)))(jp, b)
    got = vmap(grad(lambda p, b: transformer.loss_fn(p, b, tcfg,
                                                     remat="none")),
               in_dims=(None, 0))(tp, _t(b))
    _close(got, want, scaled=arch in STEPS)


# ---------------------------------------------------------------------------
# The train steps
# ---------------------------------------------------------------------------

def _jstep(arch, algo, **kw):
    """The reference's jitted step, one a configuration (its compile of
    the 8-layer hybrid is most of a jamba case's time)."""
    key = (arch, algo) + tuple(sorted(kw.items()))
    if key not in _CACHE:
        _CACHE[key] = jax.jit(jsteps.STEP_BUILDERS[algo](_model(arch)[0],
                                                         **kw))
    return _CACHE[key]


def _step_state(jp, algo):
    g0 = jax.tree_util.tree_map(lambda x: 0.01 * jnp.ones_like(x), jp)
    return {"params": jp} if algo == "fedavg" else \
        {"params": jp, "anchor": jp, "g_t": g0}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("algo", sorted(jsteps.STEP_BUILDERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_round_steps_match_reference(arch, algo, remat):
    """Each step builder over 3 steps (jamba: 1) on one (2, 16) batch
    (g_t starts at 0.01 everywhere) against the reference's jitted step:
    the new state and the loss."""
    jcfg, tcfg, jp, _ = _model(arch)
    kw = dict(eta=0.05, remat=remat)
    if algo != "fedavg":
        kw["mu"] = 0.1
    b = _batch(4, (2, 16))
    jstep = _jstep(arch, algo, **kw)
    tstep = steps.STEP_BUILDERS[algo](tcfg, **kw)
    js = _step_state(jp, algo)
    ts = param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for _ in range(STEPS.get(arch, 3)):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _t(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL, rtol=0)
    assert sorted(ts) == sorted(js)
    _close(ts, js, scaled=arch in STEPS)


def _choices(tcfg, params, b):
    """The port's expert choices (every MoE block's top-k) in a forward
    of ``loss_fn`` at ``params`` (numpy or torch) on the numpy batch."""
    seen, top_k = [], moe.top_k

    def record(probs, k):
        out = top_k(probs, k)
        seen.append(out[1].clone())
        return out

    if not isinstance(pt.leaves(params)[0], torch.Tensor):
        params = param.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), device="cpu")
    moe.top_k = record
    try:
        with torch.no_grad():
            transformer.loss_fn(params, _t(b), tcfg, remat="none")
    finally:
        moe.top_k = top_k
    return seen


def test_jamba_steps_track_reference_within_its_nudge_spread():
    """jamba's trajectory at the uncut eta 0.05 over 3 feddane steps, held
    against the reference's own sensitivity: the reference run again
    from weights nudged by 1e-7 x N(0, 1) moves g_t by > 1e-4 from step 1
    (before any expert choice can flip, and none flips over the 3 steps),
    past the scaled 1e-5 bar, while the port stays within a tenth of that
    spread of the unnudged reference at every step, for every state
    entry, with the reference's expert choices."""
    jcfg, tcfg, jp, _ = _model(JAMBA)
    rng = np.random.default_rng(9)
    jp2 = jax.tree_util.tree_map(lambda x: (np.asarray(x) + 1e-7 * rng.normal(
        size=x.shape)).astype(np.float32), jp)
    b = _batch(4, (2, 16))
    kw = dict(eta=0.05, mu=0.1, remat="none")
    jstep = _jstep(JAMBA, "feddane", **kw)
    tstep = steps.STEP_BUILDERS["feddane"](tcfg, **kw)
    js, js2 = _step_state(jp, "feddane"), _step_state(jp2, "feddane")
    ts = param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for step in range(3):
        flips = [(_choices(tcfg, js2["params"], b), "the nudge"),
                 (_choices(tcfg, ts["params"], b), "the port")]
        want = _choices(tcfg, js["params"], b)
        for got, who in flips:
            assert all(torch.equal(g, w) for g, w in zip(got, want)), who
        js, _ = jstep(js, b)
        js2, _ = jstep(js2, b)
        ts, _ = tstep(ts, _t(b))
        spread = {}
        for key in sorted(js):
            ref = jax.tree_util.tree_leaves(js[key])
            spread[key] = max(float(np.abs(np.asarray(a) - np.asarray(c))
                                    .max()) for a, c in zip(
                ref, jax.tree_util.tree_leaves(js2[key])))
            off = max(float(np.abs(a.numpy() - np.asarray(c)).max())
                      for a, c in zip(pt.leaves(ts[key]), ref))
            assert off <= 0.1 * spread[key], (step, key, off, spread)
        if step == 0:
            assert spread["g_t"] > 1e-4, spread
    g_t = jax.tree_util.tree_leaves(js["g_t"])
    assert spread["g_t"] > ATOL * max(
        1.0, max(float(np.abs(np.asarray(g)).max()) for g in g_t)), spread


# ---------------------------------------------------------------------------
# The federated trainer
# ---------------------------------------------------------------------------

LM_FED = dict(num_devices=4, devices_per_round=2, local_epochs=1,
              learning_rate=0.05, mu=0.01, seed=0)


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


@pytest.mark.parametrize("algo,engine", [("feddane", "loop"),
                                         ("feddane", "batched"),
                                         ("fedavg", "batched")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_trainer_matches_reference(arch, algo, engine):
    """2 rounds of ``launch/train.py``'s loss through
    ``FederatedTrainer`` (4 devices of 8 samples, S=16, B=2, K=2)
    against the reference's python driver: the same selections, params
    and global losses within 1e-5 (and the params moved by more)."""
    jcfg, tcfg, jp, tp = _model(arch)
    fed = dict(LM_FED, learning_rate=LR.get(arch, LM_FED["learning_rate"]))
    jdata = jtrain.make_lm_fed_data(4, 17, 2, 8, seed=0)
    jtr = JTrainer(_jloss(jcfg), jdata,
                   JConfig(algorithm=algo, engine="loop",
                           round_driver="python", **fed))
    want, jdrawn, jlosses = _rounds(jtr, jp)
    tdata = train.make_lm_fed_data(4, 17, 2, 8, seed=0, device="cpu")
    ttr = FederatedTrainer(train.make_lm_loss(tcfg), tdata,
                           FederatedConfig(algorithm=algo, engine=engine,
                                           round_driver="python", **fed),
                           device="cpu")
    got, tdrawn, tlosses = _rounds(ttr, tp)
    assert tdrawn == jdrawn
    _close(got.params, want.params)
    assert max(float((a - b).abs().max()) for a, b in zip(
        pt.leaves(got.params), pt.leaves(tp))) > 10 * ATOL
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL, rtol=0)
    assert (got.round, got.comm_rounds) == (want.round, want.comm_rounds)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_flat_bitwise_equals_per_leaf(arch):
    """The batched solver over 2 devices' LM batches (one step masked):
    flat (K1's plain version) and per_leaf (K4's) bit for bit."""
    _, tcfg, _, w0 = _model(arch)
    data = train.make_lm_fed_data(4, 17, 2, 8, seed=0, device="cpu")
    batches, valid = stack_device_batches(data, np.array([0, 2]))
    valid[1, 0] = 0.0
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
    _equal(out["flat"].params, out["per_leaf"].params)
    assert not torch.equal(pt.leaves(out["flat"].params)[1][0],
                           pt.leaves(w0)[1])


# ---------------------------------------------------------------------------
# Pods as clients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_podfed_one_pod_matches_reference(arch):
    """One pod, 2 local steps (2, 16) a step, against the reference's
    round on its 1x1x1 mesh: the new state and the loss."""
    jcfg, tcfg, jp, _ = _model(arch)
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.01 * rng.normal(size=x.shape))[None].astype(
            np.float32), p_np)
    anchor = jax.tree_util.tree_map(lambda x: x[None], p_np)
    state = {"params": params, "anchor": anchor,
             "g_t": jax.tree_util.tree_map(np.zeros_like, anchor)}
    batch = _batch(6, (1, 2, 2, 16))
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
