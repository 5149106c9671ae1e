"""The port's MoE layer against the JAX package, on the CPU.

Module level: ``moe_ffn`` on the reference's weights (``init_params``
through ``params_from_numpy``) and numpy-seeded hidden states, with the
reference's routing read off its own ``jax.lax.top_k`` and slot
``jnp.where`` calls (spies installed while it is traced): the selected experts, their order, every (token,
choice) pair's slot and the dropped pairs exactly equal; outputs within
atol 1e-5 (f32 products summed in another order); the aux loss within
1e-6.  Ties (a zero router, duplicated router columns) on inputs whose
router logits are exact in f32, so that a tie is a tie in both packages:
the lower expert first, as ``jax.lax.top_k`` orders them.

Model level: the reduced qwen3-moe-235b-a22b and arctic-480b (prefill,
decode and ``generate`` are in tests/test_torch_transformer.py);
``loss_fn`` (cross-entropy plus the aux) within 1e-5 and its gradient
within 1e-4 x each leaf's max |g|; the full-width spec trees and
parameter counts; ``serve.main``; the train side's entry points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jconfigs
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models import param as jparam
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.configs.base import MoEConfig
from repro_torch.core import pytree as pt
from repro_torch.launch import podfed, serve, steps, train
from repro_torch.models import moe, param, transformer

ATOL = 1e-5
AUX_TOL = 1e-6
GRAD_REL = 1e-4
MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
D, F = 16, 32


def _cfgs(E, K, dense=False):
    kw = dict(num_experts=E, top_k=K, dense_residual=dense,
              dense_residual_d_ff=24 if dense else 0)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _layer(jcfg, seed=0):
    """The reference's seeded MoE weights, and the same values in the
    port."""
    jp = jparam.init_params(jmoe.moe_specs(D, F, jcfg),
                            jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _hidden(seed, B, S):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _reference(monkeypatch, jp, x, jcfg, cf):
    """The reference's ``moe_ffn`` (jitted), and its routing: the
    (B, S, K) experts its ``top_k`` chose and the (B, S*K) slots of its
    ``jnp.where`` (pad slot ``E * Cb`` = dropped), returned beside its
    outputs by spies installed while it is traced."""
    top_k, where = jax.lax.top_k, jnp.where
    pad = jmoe.group_capacity(x.shape[1], jcfg, cf) * jcfg.num_experts

    def run(jp, x):
        seen = {}

        def spy_top_k(a, k):
            out = top_k(a, k)
            seen["idx"] = out[1]
            return out

        def spy_where(cond, a, b):
            out = where(cond, a, b)
            if isinstance(b, int) and b == pad:
                seen["slot"] = out
            return out

        with monkeypatch.context() as m:
            m.setattr(jax.lax, "top_k", spy_top_k)
            m.setattr(jnp, "where", spy_where)
            out, aux = jmoe.moe_ffn(jp, x, jcfg, cf)
        return out, aux, seen["idx"], seen["slot"]

    out, aux, idx, slot = jax.jit(run)(jp, jnp.asarray(x))
    return np.asarray(out), float(aux), np.asarray(idx), np.asarray(slot)


def _port(tp, x, tcfg, cf):
    """The port's ``moe_ffn`` and its routing, as :func:`_reference`."""
    xt = torch.from_numpy(x)
    out, aux = moe.moe_ffn(tp, xt, tcfg, cf)
    r = moe.route(tp, xt, tcfg)
    slot = moe.slots(r.idx, tcfg.num_experts,
                     moe.group_capacity(x.shape[1], tcfg, cf))
    return out.numpy(), float(aux), r.idx.numpy(), slot.numpy()


def _hold(monkeypatch, jp, tp, x, jcfg, tcfg, cf):
    want = _reference(monkeypatch, jp, x, jcfg, cf)
    got = _port(tp, x, tcfg, cf)
    np.testing.assert_array_equal(got[2], want[2])      # experts, in order
    np.testing.assert_array_equal(got[3], want[3])      # slots and drops
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    assert abs(got[1] - want[1]) <= AUX_TOL
    return want


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [16.0, 1.25, 0.01])
@pytest.mark.parametrize("E,K", [(4, 1), (4, 2), (8, 3)])
def test_moe_ffn_matches_reference(monkeypatch, E, K, cf):
    """B=2, S=40: no drops at capacity factor 16, some at 1.25, most at
    0.01 (every expert keeps the first 8 pairs of a sequence)."""
    jcfg, tcfg = _cfgs(E, K)
    jp, tp = _layer(jcfg, seed=E + K)
    x = _hidden(E * K, 2, 40)
    _, _, idx, slot = _hold(monkeypatch, jp, tp, x, jcfg, tcfg, cf)
    Cb = jmoe.group_capacity(40, jcfg, cf)
    loads = np.stack([np.bincount(i.ravel(), minlength=E) for i in idx])
    assert (slot == E * Cb).sum() == np.maximum(loads - Cb, 0).sum()
    if cf == 0.01:
        assert (loads > Cb).any()


def test_moe_ffn_dense_residual_matches_reference(monkeypatch):
    """Arctic's parallel dense SwiGLU branch (d_ff 24 beside the
    experts' 32)."""
    jcfg, tcfg = _cfgs(4, 2, dense=True)
    jp, tp = _layer(jcfg, seed=5)
    assert set(tp) == {"router", "w_gate", "w_up", "w_down", "dense"}
    _hold(monkeypatch, jp, tp, _hidden(6, 2, 24), jcfg, tcfg, 1.25)


def _exact_inputs(seed, B, S, E, duplicated):
    """Hidden states in {-1, 0, 1} and a router in {-1, 0, 1} / 1024
    (zero, or its odd columns copies of the even ones): every router
    logit is exact in f32 whatever the order of the sums."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, (B, S, D)).astype(np.float32)
    router = np.zeros((D, E), np.float32)
    if duplicated:
        router[:, 0::2] = rng.integers(-1, 2, (D, E // 2)) / 1024
        router[:, 1::2] = router[:, 0::2]
    return x, router


@pytest.mark.parametrize("duplicated", [False, True])
@pytest.mark.parametrize("E,K", [(8, 3), (128, 8)])
def test_ties_take_the_lower_expert_first(monkeypatch, E, K, duplicated):
    """A zero router (all probabilities equal) and one with duplicated
    columns: the reference's experts, order and slots; under a zero
    router every token picks experts 0..K-1 and each keeps its first Cb
    pairs."""
    jcfg, tcfg = _cfgs(E, K)
    jp, tp = _layer(jcfg, seed=1)
    x, router = _exact_inputs(E + int(duplicated), 2, 48, E, duplicated)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    _, _, idx, slot = _hold(monkeypatch, jp, tp, x, jcfg, tcfg, 1.25)
    if not duplicated:
        assert (idx == np.arange(K)).all()
        Cb = jmoe.group_capacity(48, jcfg)
        assert (slot != E * Cb).sum() == 2 * K * min(Cb, 48)
    else:
        # tied pairs are adjacent, the even (lower) expert first
        even = idx[..., :-1] % 2 == 0
        assert ((idx[..., 1:] == idx[..., :-1] + 1) | ~even).all()


def test_top_k_orders_ties_like_jax():
    """``torch.topk`` may put any of equal values first; ``top_k``
    keeps ``jax.lax.top_k``'s lower index first."""
    probs = np.random.default_rng(3).integers(0, 4, (64, 128)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 8)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cf", [1.25, 0.01])
@pytest.mark.parametrize("E,K,dense", [(4, 2, False), (8, 3, True)])
def test_plain_version_equals_moe_ffn(E, K, dense, cf):
    """The per-expert loop (``moe_ffn_plain``, what the card's runs are
    held against) against the slot formulation, drops included."""
    _, tcfg = _cfgs(E, K, dense)
    _, tp = _layer(_cfgs(E, K, dense)[0], seed=K)
    x = torch.from_numpy(_hidden(K, 3, 33))
    out, aux = moe.moe_ffn(tp, x, tcfg, cf)
    p_out, p_aux = moe.moe_ffn_plain(tp, x, tcfg, cf)
    torch.testing.assert_close(p_out, out, atol=ATOL, rtol=0)
    assert abs(float(p_aux) - float(aux)) <= AUX_TOL


@pytest.mark.parametrize("arch", MOE)
def test_group_capacity_matches_reference(arch):
    jcfg = jconfigs.get_arch(arch).moe
    tcfg = configs.get_arch(arch).moe
    for S in list(range(1, 300)) + [1024, 4096, 32_768, 524_288]:
        for cf in (0.01, 1.0, 1.25, 2.0, 16.0):
            assert moe.group_capacity(S, tcfg, cf) == \
                jmoe.group_capacity(S, jcfg, cf)


def test_group_capacity_of_qwen3_moe():
    cfg = configs.get_arch("qwen3-moe-235b-a22b").moe
    assert [moe.group_capacity(S, cfg) for S in (1, 16, 128, 1024, 4096)] \
        == [8, 8, 16, 80, 320]


def _spec_rows(tree, is_leaf):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): (tuple(s.shape), tuple(s.axes), s.init,
                                      s.scale) for p, s in leaves}


@pytest.mark.parametrize("arch", MOE)
def test_moe_specs_match_reference_at_full_width(arch):
    j, t = jconfigs.get_arch(arch), configs.get_arch(arch)
    assert _spec_rows(moe.moe_specs(t.d_model, t.d_ff, t.moe),
                      lambda x: isinstance(x, param.ParamSpec)) == \
        _spec_rows(jmoe.moe_specs(j.d_model, j.d_ff, j.moe), jparam.is_spec)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced ``arch``, 2 layers at d_model 64."""
    if arch not in _MODELS:
        kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  vocab_size=128)
        jcfg = jconfigs.get_arch(arch).reduced(**kw)
        tcfg = configs.get_arch(arch).reduced(**kw)
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        _MODELS[arch] = (jcfg, tcfg, jp, param.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return _MODELS[arch]


def _batch(seed, B, S, vocab=128):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": labels}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grad_match_reference(arch, remat):
    """``loss_fn`` (cross-entropy plus both layers' aux) and its
    gradient, plain autograd, against ``jax.value_and_grad`` of the
    reference's; B=2, S=16."""
    jcfg, tcfg, jp, tp = _model(arch)
    b = _batch(1, 2, 16)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, b, jcfg, remat=remat)))(jp)
    tl, tg = steps.value_and_grad(
        lambda p: transformer.loss_fn(p, pt.tmap(torch.from_numpy, b), tcfg,
                                      remat=remat), tp)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jg),
                            pt.leaves(tg)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= GRAD_REL * np.abs(j).max(), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", MOE)
def test_aux_is_the_reference_aux(arch):
    """The loss's aux term alone: the reference's ``forward_hidden``
    aux, summed over the layers."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _batch(2, 2, 24)["tokens"]
    _, want, _ = jax.jit(lambda p: jtf.forward_hidden(
        p, {"tokens": jnp.asarray(toks)}, jcfg))(jp)
    _, got = transformer._forward_hidden_aux(
        tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert abs(float(got) - float(want)) <= AUX_TOL
    assert float(got) > 0


def test_dense_archs_have_no_aux():
    cfg = configs.get_arch("qwen1.5-0.5b").reduced(num_layers=1, d_model=64,
                                                   vocab_size=64)
    p = param.init_params(transformer.model_specs(cfg),
                          torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.int32)
    assert transformer._forward_hidden_aux(p, {"tokens": toks}, cfg)[1] is None


def test_qwen3_moe_parameter_count():
    """qwen3-moe-235b-a22b in full, from the specs alone: 94 layers of
    2.4 B expert weights, and the embedding and head."""
    specs = transformer.model_specs(configs.get_arch("qwen3-moe-235b-a22b"))
    assert param.param_count(specs) == 231_742_361_600
    two = dataclasses.replace(configs.get_arch("qwen3-moe-235b-a22b"),
                              num_layers=2)
    assert param.param_count(transformer.model_specs(two)) == 6_148_870_144


def test_serve_main_runs_qwen3_moe_on_the_cpu(capsys):
    res = serve.main(["--device", "cpu", "--tokens", "3", "--prompt-len",
                      "4", "--arch", "qwen3-moe-235b-a22b"])
    assert res.tokens.shape == (2, 3)
    assert "decoded 3 tokens x batch 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", MOE)
def test_train_side_takes_moe(arch):
    """Every train entry point takes the MoE archs: the specs, the step
    builders, the trainer's loss and ``train.main`` (one round on the
    CPU), and podfed."""
    cfg = configs.get_arch(arch).reduced()
    shape = configs.get_shape("train_4k")
    moe_leaf = "['params']['stack']['pos_0']['moe']['w_gate']"
    rows = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(
                steps.abstract_train_state(cfg),
                is_leaf=lambda x: isinstance(x, steps.ShapeDtype))}
    assert rows[moe_leaf] == (2, 4, 256, 512)
    assert set(steps.train_state_specs(cfg)) == {"params", "anchor", "g_t"}
    assert steps.train_batch_specs(cfg, shape)["tokens"].shape == (256, 4096)
    for build in steps.STEP_BUILDERS.values():
        assert callable(build(cfg))
    assert callable(train.make_lm_loss(cfg))
    res = train.main(["--arch", arch, "--device", "cpu", "--rounds", "1",
                      "--num-devices", "4", "--devices-per-round", "2",
                      "--local-epochs", "1", "--samples-per-device", "8",
                      "--seq-len", "16", "--d-model", "64", "--layers", "1",
                      "--vocab", "128"])
    assert res.cfg.moe.num_experts == 4 and res.cfg.moe.top_k == 2
    assert np.isfinite(res.losses).all() and res.state.round == 1
    fn, info = podfed.make_podfed_round_step(cfg)
    assert callable(fn) and info["mesh_devices"] == 1
    state, batch = podfed.abstract_podfed_args(cfg, shape, 2)
    assert state["params"]["stack"]["pos_0"]["moe"]["w_gate"].shape == \
        (2, 2, 4, 256, 512)
    assert batch["tokens"].shape[0] == 2
