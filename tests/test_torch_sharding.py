"""The port's client mesh against the reference's unsharded python driver.

The port's mesh is D processes (``core/sharding.py``): here 4 gloo ranks
on the CPU, started by ``run_on_mesh(..., device="cpu")`` through a
``file://`` store under the test's temporary directory, once per mesh
shape -- a flat 4-rank mesh and a ``(2, 2)`` tree of two edges of two
leaves.  Each rank runs every case (``tests/_torch_mesh_child.py``) and
returns numpy results; this process runs the reference's unsharded
python driver (batched engine) on the same inputs, as
tests/_sharded_child.py does: N=16, K=8, E=2, lr=0.01, mu=0.001,
seed 3, injected selections, 3 rounds.

The reference's mesh equals its plain python-driver program bitwise, so
the port's mesh is held to that program.  The ranks run the
``fused_epoch`` solver (the mode ``auto`` takes on the card; its plain
version on the CPU), the reference its CPU ``auto`` (flat) mode:
PR 11's parity bar between them is 1e-5.  Bars:

- every registered algorithm: params, loss history and SCAFFOLD
  controls at atol 1e-5;
- ``bernoulli``(0.5) and ``hostile``: every round's masks and
  ``effective_k`` exactly, params at 1e-5;
- int8, topk and dp_gauss, fed the reference's ``jax.random`` draws
  (the ranks take their own slots of the table): params, loss and error
  feedback at the reference's codec bar 1e-4, wire bytes exactly;
- across ranks: every result bitwise equal;
- ``edge_shards=1`` on the flat mesh: bitwise equal to the default.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_mesh_child as child
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core.algorithms as jalgorithms
from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import available_algorithms
from repro.core import codecs as jcodecs
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer, sharding
from repro_torch.data import make_synthetic
from repro_torch.kernels.flatpack import LANES
from repro_torch.models.small import logreg_loss

N, K, ROUNDS = 16, 8, 3
KW = dict(num_devices=N, devices_per_round=K, local_epochs=2,
          learning_rate=0.01, mu=0.001, seed=3)
DATA = dict(num_devices=N, seed=0)
ATOL = 1e-5
CODEC_ATOL = 1e-4
ALGOS = available_algorithms()
SCENARIOS = {"bernoulli": dict(scenario="bernoulli", avail_prob=0.5),
             "hostile": dict(scenario="hostile", avail_prob=0.6,
                             dropout_rate=0.3, straggler_deadline=1.2,
                             straggler_sigma=0.8, partial_min_work=0.3)}
CODECS = ("int8", "topk", "dp_gauss")
MESHES = {"flat": (4, 1), "tree": (4, 2)}
SEL = np.stack([np.stack([(np.arange(K) + t) % N, (np.arange(K) + t + 4) % N])
                for t in range(ROUNDS)])


def _extra(case):
    if case in SCENARIOS:
        return "feddane", SCENARIOS[case]
    if case in CODECS:
        return "feddane", dict(codec=case)
    return case, {}


def _draws_table(codec):
    """The reference's codec draws of every round for all K slots, as
    numpy (signs, u, noise); ``None`` for a codec without randomness."""
    if not jcodecs.codec_spec(codec).uses_rng:
        return None
    cfg = JConfig(codec=codec, **KW)
    rows = 8                                   # logreg(60, 10)'s flat pack
    table = []
    for t in range(ROUNDS):
        key = jcodecs.round_key(cfg, t)
        signs = jax.random.rademacher(jax.random.fold_in(key, 0x5167),
                                      (LANES,), dtype=jnp.float32)
        u = jnp.stack([jax.random.uniform(jax.random.fold_in(key, i),
                                          (rows, LANES)) for i in range(K)])
        noise = jax.random.normal(jax.random.fold_in(key, 0x0D99),
                                  (rows, LANES))
        table.append(tuple(np.array(a) for a in (signs, u, noise)))
    return table


def _dense(rows):
    if rows is None:
        return None
    leaves = [jax.tree_util.tree_leaves(r) for r in rows]
    return [np.stack([np.asarray(x[i]) for x in leaves])
            for i in range(len(leaves[0]))]


@pytest.fixture(scope="module")
def p0():
    p = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def reference(p0):
    """The reference's unsharded python driver on every case: history,
    final params and per-client state, and each round's masks."""
    ds = j_make_synthetic(1, 1, **DATA)
    out = {}
    for case in list(ALGOS) + list(SCENARIOS) + list(CODECS):
        algo, extra = _extra(case)
        tr = JTrainer(j_logreg_loss, ds,
                      JConfig(algorithm=algo, engine="batched",
                              round_driver="python", **KW, **extra))
        states, envs, avails = [], [], []
        init = tr.init
        tr.init = lambda p: states.append(init(p)) or states[-1]

        def rec(fn, store):
            def f(*a, **k):
                r = fn(*a, **k)
                store.append(np.asarray(getattr(r, "active", r)))
                return r
            return f

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jalgorithms, "realize_env",
                       rec(jalgorithms.realize_env, envs))
            mp.setattr(jalgorithms, "availability_mask",
                       rec(jalgorithms.availability_mask, avails))
            hist, final = tr.run(jax.tree_util.tree_map(jnp.asarray, p0),
                                 ROUNDS, selections=SEL)
        st = states[0]
        out[case] = {
            "params": jax.tree_util.tree_map(np.asarray, final),
            "hist": hist, "envs": envs, "avails": avails,
            "controls": _dense(st.controls),
            "ef": (None if st.ef is None
                   else _dense([st.ef[k] for k in range(N)]))}
    return out


def _cases(mesh_devices, edge_shards):
    mesh = dict(mesh_devices=mesh_devices, edge_shards=edge_shards,
                local_solver="fused_epoch", round_driver="python", **KW)
    cases = {}
    for case in list(ALGOS) + list(SCENARIOS) + list(CODECS):
        algo, extra = _extra(case)
        cases[case] = (dict(mesh, algorithm=algo, **extra),
                       _draws_table(case) if case in CODECS else None)
    return cases


#: Trainer builds that must raise on the flat 4-rank mesh: name ->
#: (config kwargs, a word of the message).
MESH_ERRORS = {
    "indivisible_k": (dict(KW, devices_per_round=6, mesh_devices=4),
                      "divisible"),
    "world_size": (dict(KW, mesh_devices=2), "world size"),
    "edge_mismatch": (dict(KW, mesh_devices=4, edge_shards=2), "edge"),
    "edge_not_dividing": (dict(KW, mesh_devices="auto", edge_shards=3),
                          "must divide"),
    "loop_engine": (dict(KW, mesh_devices="auto", engine="loop"),
                    "batched engine"),
    "mesh_not_asked_for": (dict(KW), "resolves to 1"),
}


@pytest.fixture(scope="module")
def ranks(p0, tmp_path_factory):
    """mesh name -> the per-rank results of every case."""
    out = {}
    for name, (d, e) in MESHES.items():
        cases = _cases(d, e)
        errors = {}
        if name == "flat":
            cases["feddane_edge1"] = (dict(cases["feddane"][0],
                                           edge_shards=1), None)
            cases["feddane_default"] = (
                {k: v for k, v in cases["feddane"][0].items()
                 if k != "edge_shards"}, None)
            errors = {k: kw for k, (kw, _) in MESH_ERRORS.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tempfile, "tempdir",
                       str(tmp_path_factory.mktemp(f"store_{name}")))
            res = sharding.run_on_mesh(
                child.run_cases, d, e, device="cpu",
                args=(cases, errors, DATA, p0, SEL, ROUNDS))
        assert [r["rank"] for r in res] == list(range(d))
        out[name] = res
    return out


def _close(got, want, atol, what):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algo", ALGOS)
def test_mesh_algorithm_matches_reference(ranks, reference, mesh, algo):
    got, want = ranks[mesh][0]["cases"][algo], reference[algo]
    _close(got["params"], want["params"], ATOL, f"{algo} params")
    np.testing.assert_allclose(got["loss"], want["hist"]["loss"],
                               atol=ATOL)
    assert (got["controls"] is None) == (want["controls"] is None)
    if want["controls"] is not None:
        _close(got["controls"], want["controls"], ATOL, f"{algo} controls")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_mesh_scenario_matches_reference(ranks, reference, mesh, scenario):
    got, want = ranks[mesh][0]["cases"][scenario], reference[scenario]
    assert len(got["masks"]) == len(want["envs"]) == ROUNDS
    for t, (avail, active) in enumerate(got["masks"]):
        np.testing.assert_array_equal(active, want["envs"][t],
                                      err_msg=f"round {t} active")
        np.testing.assert_array_equal(avail, want["avails"][t],
                                      err_msg=f"round {t} availability")
    assert got["effective_k"] == want["hist"]["effective_k"]
    assert any(e < K for e in got["effective_k"]), "scenario inert"
    _close(got["params"], want["params"], ATOL, f"{scenario} params")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("codec", CODECS)
def test_mesh_codec_matches_reference(ranks, reference, mesh, codec):
    got, want = ranks[mesh][0]["cases"][codec], reference[codec]
    _close(got["params"], want["params"], CODEC_ATOL, f"{codec} params")
    np.testing.assert_allclose(got["loss"], want["hist"]["loss"],
                               atol=CODEC_ATOL)
    assert got["bytes_up"] == want["hist"]["bytes_up"]
    assert (got["ef"] is None) == (want["ef"] is None)
    if want["ef"] is not None:
        _close(got["ef"], want["ef"], CODEC_ATOL, f"{codec} ef")


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype, a.shape, a.tobytes()) == (b.dtype, b.shape,
                                                    b.tobytes())
    return a == b


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_ranks_are_bitwise_equal(ranks, mesh):
    """Replicated state stays bit-identical on every rank: params,
    history, masks, controls and error feedback of every case."""
    first = ranks[mesh][0]["cases"]
    for r in ranks[mesh][1:]:
        for case, res in r["cases"].items():
            assert _same(res, first[case]), f"rank {r['rank']}: {case}"


def test_edge_shards_one_is_the_flat_mesh(ranks):
    cases = ranks["flat"][0]["cases"]
    assert _same(cases["feddane_edge1"], cases["feddane_default"])
    assert _same(cases["feddane_edge1"], cases["feddane"])


@pytest.mark.parametrize("name", list(MESH_ERRORS))
def test_mesh_trainer_rejects(ranks, name):
    for r in ranks["flat"]:
        msg = r["errors"][name]
        assert msg is not None, f"{name} did not raise on rank {r['rank']}"
        assert MESH_ERRORS[name][1] in msg, msg


# -- without ranks ----------------------------------------------------------

def test_mesh_without_a_process_group_raises():
    ds = make_synthetic(1, 1, device="cpu", **DATA)
    with pytest.raises(ValueError, match="process group.*run_on_mesh"):
        FederatedTrainer(logreg_loss, ds,
                         FederatedConfig(mesh_devices=4, **dict(
                             KW, devices_per_round=8)), device="cpu")
    assert sharding.resolve_mesh_devices("auto") == 1
    assert sharding.mesh_for(FederatedConfig(mesh_devices="auto")) is None


@pytest.mark.parametrize("kw,match", [
    (dict(engine="loop", mesh_devices=4), "engine='loop'"),
    (dict(mesh_devices=4, edge_shards=3), "must divide"),
    (dict(edge_shards=0), "positive int"),
])
def test_config_rejects_bad_meshes(kw, match):
    with pytest.raises(ValueError, match=match):
        FederatedConfig(**kw)


def test_edge_shards_need_a_mesh():
    with pytest.raises(ValueError, match="edge_shards=2 needs a real"):
        sharding.mesh_for(FederatedConfig(mesh_devices="auto",
                                          edge_shards=2))


def test_mesh_helpers_without_a_mesh():
    x = torch.arange(4.0)
    assert sharding.tree_psum(x, None) is x
    assert sharding.tree_pmean(x, None) is x
    assert sharding.gather_rows(x, None) is x
    assert sharding.shard_rows(8, None) == (0, 8)
    with pytest.raises(ValueError, match="devices_per_round=6"):
        sharding.check_divisible(6, sharding.ClientMesh(
            world=4, edge_shards=1, rank=0, device=torch.device("cpu")),
            "devices_per_round")


@pytest.mark.parametrize("kw,cuda,err,match", [
    (dict(device="cpu", backend="nccl"), (False, 0), ValueError, "gloo"),
    (dict(), (False, 0), RuntimeError, "device='cpu'"),
    (dict(), (True, 1), ValueError, "backend='gloo'"),
    (dict(device="cuda:0"), (True, 1), ValueError, "one device"),
    (dict(device="cpu", backend="mpi"), (False, 0), ValueError, "backend"),
])
def test_run_on_mesh_placement_is_explicit(monkeypatch, kw, cuda, err,
                                           match):
    """No silent switch of device or backend: the cases the launcher
    cannot place as asked raise before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda[0])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cuda[1])
    with pytest.raises(err, match=match):
        sharding.run_on_mesh(child.fail_on_rank_one, 2, **kw)


def test_run_on_mesh_placement_when_it_can():
    place = sharding._placement
    assert place(4, "cpu", None) == (["cpu"] * 4, "gloo")


def test_run_on_mesh_raises_when_a_rank_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        sharding.run_on_mesh(child.fail_on_rank_one, 2, device="cpu")
    assert not list(tmp_path.glob("mesh-*")), "the store is left behind"
