"""The port's wire codecs against the JAX package's, on the CPU.

The reference draws its codec randomness from ``jax.random`` keyed by
``round_key(cfg, t)``; the port from numpy generators behind one
function, ``codecs.round_draws``.  Two kinds of check follow:

- **parity with injected draws**: the port's ``round_draws`` is replaced
  by the reference's own draws (the same ``fold_in`` constants: 0x5167
  for int8's signs, the cohort slot for its uniforms, 0x0D99 for the DP
  noise), so both packages run the same lossy protocol.  Lossy codecs
  are held to the reference's own cross-path bar for them, atol 1e-4
  over 3 rounds (tests/test_codecs.py, ``test_lossy_codec_paths_agree``):
  a one-ulp difference of a rotated delta can move an int8 code across
  a ``floor`` boundary.  ``none`` keeps the engine-parity bar, 1e-5;
- **the port's own draws**: the statistical gates of
  tests/test_codecs.py (int8 unbiasedness, the DP chi-square, error
  feedback telescoping, no noise on an empty cohort) and the byte
  formulas.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import codecs as jcodecs
from repro.data import make_synthetic as j_make_synthetic
from repro.models.param import init_params as j_init_params
from repro.models.small import logreg_loss as j_logreg_loss
from repro.models.small import logreg_specs as j_logreg_specs
from repro_torch.configs.base import FederatedConfig, one_shot_config
from repro_torch.core import FederatedTrainer
from repro_torch.core import codecs as tcodecs
from repro_torch.core import pytree as pt
from repro_torch.core.strategies import algorithm_spec
from repro_torch.data import make_synthetic
from repro_torch.kernels.flatpack import LANES
from repro_torch.models.param import params_from_numpy, params_to_numpy
from repro_torch.models.small import logreg_loss

N, K = 12, 4
N_ELEMS = 61 * 10              # logreg(60, 10) with bias
KW = dict(num_devices=N, devices_per_round=K, local_epochs=2,
          learning_rate=0.05, mu=0.01, seed=5, correction_decay=0.9)
HOSTILE = dict(scenario="hostile", avail_prob=0.6, dropout_rate=0.3,
               straggler_deadline=1.2, straggler_sigma=0.8,
               partial_min_work=0.3)


@pytest.fixture(scope="module")
def data():
    jds = j_make_synthetic(0.5, 0.5, num_devices=N, seed=4, batch_size=10)
    tds = make_synthetic(0.5, 0.5, num_devices=N, seed=4, batch_size=10,
                         device="cpu")
    p0 = j_init_params(j_logreg_specs(60, 10), jax.random.PRNGKey(0))
    return jds, tds, jax.tree_util.tree_map(np.asarray, p0)


def _sel(rounds, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.choice(N, K, replace=False)
                               for _ in range(2)]) for _ in range(rounds)])


def reference_draws(spec, cfg, t, k, rows, device="cpu", idx0=0):
    """The reference's codec draws of round ``t`` for slots ``idx0 ..
    idx0+k-1`` (its ``round_key`` and ``fold_in`` constants) in the
    port's ``CodecDraws`` form."""
    if not spec.uses_rng:
        return None
    key = jcodecs.round_key(cfg, t)
    signs = jax.random.rademacher(jax.random.fold_in(key, 0x5167), (LANES,),
                                  dtype=jnp.float32)
    u = jnp.stack([jax.random.uniform(jax.random.fold_in(key, idx0 + i),
                                      (rows, LANES)) for i in range(k)])
    noise = jax.random.normal(jax.random.fold_in(key, 0x0D99),
                              (rows, LANES))
    return tcodecs.CodecDraws(*(torch.from_numpy(np.array(a)).to(device)
                                for a in (signs, u, noise)))


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(tcodecs, "round_draws", reference_draws)


_REF = {}


def _reference(data, algo, codec, engine="loop", rounds=3, **extra):
    key = (algo, codec, engine, rounds, tuple(sorted(extra.items())))
    if key not in _REF:
        jds, _, p0 = data
        tr = JTrainer(j_logreg_loss, jds,
                      JConfig(algorithm=algo, engine=engine, codec=codec,
                              **dict(KW, **extra)))
        hist, _ = tr.run(jax.tree_util.tree_map(jnp.asarray, p0), rounds,
                         selections=_sel(rounds))
        _REF[key] = (hist, tr)
    return _REF[key]


_REF_FINAL = {}


def _reference_final(data, algo, codec, engine="loop", **extra):
    """Reference state after 3 rounds (params and error feedback)."""
    key = (algo, codec, engine, tuple(sorted(extra.items())))
    if key not in _REF_FINAL:
        jds, _, p0 = data
        tr = JTrainer(j_logreg_loss, jds,
                      JConfig(algorithm=algo, engine=engine, codec=codec,
                              **dict(KW, **extra)))
        for row in _sel(3):
            tr._sample_queue.extend([row[0], row[1]] if
                                    tr.spec.num_selections == 2
                                    else [row[0]])
        st = tr.init(jax.tree_util.tree_map(jnp.asarray, p0))
        for _ in range(3):
            st = tr.round(st)
        _REF_FINAL[key] = st
    return _REF_FINAL[key]


def _port_final(data, algo, codec, engine, **extra):
    _, tds, p0 = data
    tr = FederatedTrainer(logreg_loss, tds,
                          FederatedConfig(algorithm=algo, engine=engine,
                                          codec=codec, **dict(KW, **extra)),
                          device="cpu")
    for row in _sel(3):
        tr._sample_queue.extend([row[0], row[1]] if
                                tr.spec.num_selections == 2 else [row[0]])
    st = tr.init(params_from_numpy(p0, device="cpu"))
    for _ in range(3):
        st = tr.round(st)
    return st, tr


def _close(got, want, atol):
    g, w = pt.leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def _ef_close(got, want, atol):
    if want is None:
        assert got is None
        return
    for k in range(N):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol)


# -- parity with the reference's draws injected -----------------------------

@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", ["feddane", "fedavg"])
@pytest.mark.parametrize("codec", ["int8", "topk", "dp_gauss"])
def test_lossy_codec_matches_reference(data, injected, codec, algo, engine):
    """3 rounds under the ideal scenario with injected selections: both
    engines against the reference's looped path (every client is active,
    so both paths number the cohort slots alike): params, error feedback
    and loss at 1e-4, wire bytes exactly."""
    ref = _reference_final(data, algo, codec)
    got, _ = _port_final(data, algo, codec, engine)
    _close(got.params, ref.params, 1e-4)
    _ef_close(got.ef, ref.ef, 1e-4)
    jh, _ = _reference(data, algo, codec)
    _, tds, p0 = data
    th, _ = FederatedTrainer(
        logreg_loss, tds, FederatedConfig(algorithm=algo, engine=engine,
                                          codec=codec, **KW),
        device="cpu").run(params_from_numpy(p0, device="cpu"), 3,
                          selections=_sel(3))
    np.testing.assert_allclose(th["loss"], jh["loss"], atol=1e-4)
    for k in ("bytes_up", "bytes_down", "effective_k"):
        assert th[k] == jh[k], k


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("algo", ["feddane", "fedavg"])
def test_none_codec_matches_reference(data, algo, engine):
    ref = _reference_final(data, algo, "none")
    got, tr = _port_final(data, algo, "none", engine)
    _close(got.params, ref.params, 1e-5)
    assert got.ef is None and tr._codec_trivial


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_lossy_codec_under_scenario_matches_reference(data, injected, codec,
                                                      engine):
    """Under hostile the two engines number the cohort slots differently
    (batched: all K slots, masked; loop: the active updates in slots
    0..k-1), so each engine is held to the reference's same engine."""
    ref = _reference_final(data, "feddane", codec, engine=engine, **HOSTILE)
    got, tr = _port_final(data, "feddane", codec, engine, **HOSTILE)
    _close(got.params, ref.params, 1e-4)
    _ef_close(got.ef, ref.ef, 1e-4)


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_seeded_error_feedback_matches_reference(data, engine):
    """topk from non-zero error feedback: the same numpy (rows, 128) slab
    per client goes into both packages' stores, then one round."""
    jds, tds, p0 = data
    rng = np.random.default_rng(21)
    slabs = {k: (0.01 * rng.standard_normal((8, LANES))).astype(np.float32)
             for k in range(0, N, 2)}
    jtr = JTrainer(j_logreg_loss, jds, JConfig(algorithm="fedavg",
                                               engine="loop", codec="topk",
                                               **KW))
    ttr = FederatedTrainer(logreg_loss, tds,
                           FederatedConfig(algorithm="fedavg", engine=engine,
                                           codec="topk", **KW),
                           device="cpu")
    sel = _sel(1)[0, 0]
    jst = jtr.init(jax.tree_util.tree_map(jnp.asarray, p0))
    tst = ttr.init(params_from_numpy(p0, device="cpu"))
    for k, slab in slabs.items():
        jst.ef[k] = jnp.asarray(slab)
        tst.ef[k] = torch.from_numpy(slab)
    jtr._sample_queue.append(sel)
    ttr._sample_queue.append(sel)
    jst, tst = jtr.round(jst), ttr.round(tst)
    _close(tst.params, jst.params, 1e-5)
    _ef_close(tst.ef, jst.ef, 1e-5)
    for k in set(range(N)) - set(sel.tolist()):
        assert torch.equal(tst.ef[k], torch.from_numpy(
            slabs.get(k, np.zeros((8, LANES), np.float32))))


def _int8_both(seed, bits, idx, t):
    rng = np.random.default_rng(seed)
    rows = 8
    flat = (0.05 * rng.standard_normal((rows, LANES))).astype(np.float32)
    jcfg = JConfig(codec="int8", bits=bits, seed=seed)
    tcfg = FederatedConfig(codec="int8", bits=bits, seed=seed)
    key = jcodecs.round_key(jcfg, t)
    jv, js, _ = jcodecs.codec_spec("int8").encode(jcfg, key, idx,
                                                  jnp.asarray(flat), None)
    draws = reference_draws(tcodecs.codec_spec("int8"), tcfg, t, idx + 1,
                            rows)
    tv, ts, _ = tcodecs.codec_spec("int8").encode(tcfg, draws, idx,
                                                  torch.from_numpy(flat),
                                                  None)
    # distance of the reference's pre-floor value to the nearest integer
    y = np.asarray(jnp.asarray(flat) * draws.signs.numpy()
                   @ jnp.asarray(jcodecs.builtin._H128))
    z = y / np.asarray(js) + draws.u[idx].numpy()
    return np.asarray(jv), tv.numpy(), float(js), float(ts), \
        np.abs(z - np.round(z))


def test_int8_codes_match_reference_off_the_boundaries():
    """Fed the same draws, the port's int8 codes equal the reference's
    except where the pre-floor value lies within 1e-5 of an integer
    (there one ulp of the rotated delta decides); the scales agree."""
    diff = near = total = 0
    for seed in range(6):
        for bits in (2, 4, 8):
            for idx, t in ((0, 0), (3, 5)):
                jv, tv, js, ts, dist = _int8_both(seed, bits, idx, t)
                assert abs(js - ts) <= 1e-6 * abs(js)
                bad = jv != tv
                diff += int(bad.sum())
                near += int((dist < 1e-5).sum())
                total += jv.size
                assert (dist[bad] < 1e-5).all(), \
                    f"codes differ off a boundary: {dist[bad]}"
    print(f"int8 codes: {diff} of {total} differ, all among the {near} "
          f"values within 1e-5 of a floor boundary")
    assert diff <= near


# -- the port's own draws ----------------------------------------------------

def test_round_draws_are_seeded_and_keyed():
    cfg = FederatedConfig(codec="int8", seed=3)
    spec = tcodecs.codec_spec("int8")
    a = tcodecs.round_draws(spec, cfg, 4, 3, 8)
    b = tcodecs.round_draws(spec, cfg, 4, 5, 8)
    c = tcodecs.round_draws(spec, cfg, 5, 3, 8)
    assert a.signs.shape == (LANES,) and a.u.shape == (3, 8, LANES)
    assert a.noise.shape == (8, LANES)
    assert set(a.signs.tolist()) == {-1.0, 1.0}
    assert a.u.dtype == a.noise.dtype == torch.float32
    # slots are independent of the cohort size; rounds differ
    assert torch.equal(a.u, b.u[:3]) and torch.equal(a.signs, b.signs)
    assert not torch.equal(a.u[0], a.u[1])
    assert not torch.equal(a.u, c.u) and not torch.equal(a.noise, c.noise)
    assert tcodecs.round_draws(tcodecs.codec_spec("topk"), cfg, 0, 3,
                               8) is None


def test_int8_quantizer_is_unbiased():
    cfg = FederatedConfig(codec="int8")
    spec = tcodecs.codec_spec("int8")
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.standard_normal((4, LANES)).astype(
        np.float32))
    acc = torch.zeros_like(flat)
    reps = 300
    for t in range(reps):
        draws = tcodecs.round_draws(spec, cfg, t, 1, 4)
        vals, scale, _ = spec.encode(cfg, draws, 0, flat, None)
        acc = acc + spec.post_decode(cfg, draws, vals * scale)
    _, scale, _ = spec.encode(cfg, tcodecs.round_draws(spec, cfg, 0, 1, 4),
                              0, flat, None)
    tol = 5.0 * float(scale) / np.sqrt(reps)
    np.testing.assert_allclose((acc / reps).numpy(), flat.numpy(), atol=tol)


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_int8_roundtrip_l2_bound(bits):
    cfg = FederatedConfig(codec="int8", bits=bits)
    spec = tcodecs.codec_spec("int8")
    for seed in range(5):
        rng = np.random.default_rng(seed)
        flat = torch.from_numpy((rng.standard_normal((seed + 1, LANES))
                                 * 10.0 ** (seed - 2)).astype(np.float32))
        draws = tcodecs.round_draws(spec, cfg, seed, 1, seed + 1)
        vals, scale, ef = spec.encode(cfg, draws, 0, flat, None)
        assert ef is None
        dec = spec.post_decode(cfg, draws, vals * scale)
        err = float(torch.sqrt(((dec - flat) ** 2).sum()))
        assert err <= float(scale) * np.sqrt(flat.numel()) + 1e-4
        assert float(vals.abs().max()) <= 2 ** (bits - 1) - 1
        assert torch.equal(vals, torch.round(vals))


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5, 1.0])
def test_topk_transmitted_plus_residual_is_exact(frac):
    cfg = FederatedConfig(codec="topk", topk_frac=frac)
    spec = tcodecs.codec_spec("topk")
    rng = np.random.default_rng(int(frac * 100))
    flat = torch.from_numpy((rng.standard_normal((6, LANES)) * 3).astype(
        np.float32))
    vals, scale, ef_new = spec.encode(cfg, None, 0, flat,
                                      torch.zeros_like(flat))
    assert float(scale) == 1.0
    assert torch.equal(vals + ef_new, flat)
    assert int((vals != 0).sum()) <= tcodecs.topk_keep(cfg, flat.numel()) \
        + LANES


def test_error_feedback_telescopes_across_rounds():
    cfg = FederatedConfig(codec="topk", topk_frac=0.1)
    spec = tcodecs.codec_spec("topk")
    rng = np.random.default_rng(7)
    ef = torch.zeros(3, LANES)
    sent = torch.zeros_like(ef)
    total = torch.zeros_like(ef)
    for _ in range(6):
        x = torch.from_numpy(rng.standard_normal((3, LANES)).astype(
            np.float32))
        vals, _, ef = spec.encode(cfg, None, 0, x, ef)
        sent, total = sent + vals, total + x
    np.testing.assert_allclose((sent + ef).numpy(), total.numpy(),
                               atol=1e-4)
    assert float(ef.abs().max()) > 0


def test_dp_gauss_clips_to_ball():
    spec = tcodecs.codec_spec("dp_gauss")
    for clip in (0.1, 1.0, 10.0):
        cfg = FederatedConfig(codec="dp_gauss", clip_norm=clip)
        for seed in range(4):
            rng = np.random.default_rng(seed)
            flat = torch.from_numpy((rng.standard_normal((2, LANES))
                                     * 0.3 * seed).astype(np.float32))
            vals, _, _ = spec.encode(cfg, None, 0, flat, None)
            assert float(vals.norm()) <= clip * (1 + 1e-5)
            if float(flat.norm()) <= clip:
                assert torch.equal(vals, flat)


def test_dp_noise_scale_chi_square():
    """The port's noise at sigma = noise_mult * clip_norm / count passes
    the reference's two-sided 99.9% chi-square band (fixed seed)."""
    cfg = FederatedConfig(codec="dp_gauss", clip_norm=2.0, noise_mult=1.5)
    spec = tcodecs.codec_spec("dp_gauss")
    count = 4.0
    sigma = cfg.noise_mult * cfg.clip_norm / count
    draws = tcodecs.round_draws(spec, cfg, 0, 1, 64)
    noise = spec.post_aggregate(cfg, draws, torch.zeros(64, LANES),
                                torch.tensor(count))
    n = noise.numel()
    stat = n * float((noise.double() ** 2).sum() / n) / sigma ** 2
    half = 3.29 * np.sqrt(2.0 * n)
    assert n - half < stat < n + half, (stat, n)
    assert abs(float(noise.mean())) < 5 * sigma / np.sqrt(n)


def test_empty_cohort_gets_no_noise():
    cfg = FederatedConfig(codec="dp_gauss")
    spec = tcodecs.codec_spec("dp_gauss")
    draws = tcodecs.round_draws(spec, cfg, 0, 1, 4)
    out = tcodecs.decode_aggregate(spec, cfg, draws, torch.zeros(4, LANES),
                                   torch.tensor(0.0))
    assert torch.equal(out, torch.zeros(4, LANES))


# -- byte telemetry (tests/test_codecs.py) ----------------------------------

def _run(data, algo, engine, codec, num_rounds=3, sel=None, **over):
    _, tds, p0 = data
    kw = dict(KW, algorithm=algo, engine=engine, codec=codec)
    kw.update(over)
    tr = FederatedTrainer(logreg_loss, tds, FederatedConfig(**kw),
                          device="cpu")
    return tr.run(params_from_numpy(p0, device="cpu"), num_rounds,
                  selections=sel)


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_bytes_formula_fedavg_ideal(data, engine):
    dense = 4.0 * N_ELEMS
    for codec, enc in [("none", dense), ("int8", N_ELEMS + 4.0),
                       ("topk", np.ceil(0.1 * N_ELEMS) * 4.0 + 4.0),
                       ("dp_gauss", dense)]:
        hist, _ = _run(data, "fedavg", engine, codec)
        assert hist["bytes_up"] == [K * enc] * 3, codec
        assert hist["bytes_down"] == [K * dense] * 3, codec


def test_bytes_formula_feddane_ideal(data):
    dense = 4.0 * N_ELEMS
    hist, _ = _run(data, "feddane", "loop", "int8")
    assert hist["bytes_up"] == [K * dense + K * (N_ELEMS + 4.0)] * 3
    assert hist["bytes_down"] == [K * dense + K * 2 * dense] * 3


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_thinned_gather_bytes_match_reference(data, engine):
    """Under bernoulli the phase-A gather counts responders, not
    selections: fewer bytes than ideal, and exactly the reference's
    python driver's (the host-sampled selections and environment pin
    the port to its python driver too)."""
    ideal, _ = _run(data, "feddane", engine, "none", num_rounds=6,
                    round_driver="python")
    thin, _ = _run(data, "feddane", engine, "none", num_rounds=6,
                   scenario="bernoulli", avail_prob=0.4,
                   round_driver="python")
    assert sum(thin["bytes_up"]) < sum(ideal["bytes_up"])
    assert min(thin["bytes_up"]) < min(ideal["bytes_up"])
    jds, _, p0 = data
    jh, _ = JTrainer(j_logreg_loss, jds, JConfig(
        algorithm="feddane", engine="loop", scenario="bernoulli",
        avail_prob=0.4, **KW)).run(
        jax.tree_util.tree_map(jnp.asarray, p0), 6)
    for k in ("bytes_up", "bytes_down", "intended_k", "effective_k",
              "dropped"):
        assert thin[k] == jh[k], k


def test_compression_ratio_gates(data):
    base, _ = _run(data, "fedavg", "loop", "none")
    i8, _ = _run(data, "fedavg", "loop", "int8")
    tk, _ = _run(data, "fedavg", "loop", "topk")
    assert sum(base["bytes_up"]) / sum(i8["bytes_up"]) >= 3.0
    assert sum(base["bytes_up"]) / sum(tk["bytes_up"]) >= 8.0


def test_round_bytes_matches_reference_for_every_algorithm():
    from repro.core.strategies import algorithm_spec as j_algorithm_spec
    from repro_torch.core.strategies import available_algorithms
    for algo in available_algorithms():
        for codec in tcodecs.available_codecs():
            for args in ((1000, 0.0, 3.0), (610, 4.0, 2.0)):
                tcfg = FederatedConfig(codec=codec)
                jcfg = JConfig(codec=codec)
                assert tcodecs.round_bytes(
                    algorithm_spec(algo), tcodecs.codec_spec(codec), tcfg,
                    *args) == jcodecs.round_bytes(
                    j_algorithm_spec(algo), jcodecs.codec_spec(codec), jcfg,
                    *args), (algo, codec, args)


# -- registry, extensibility, full population --------------------------------

def test_registry_mechanics():
    assert tcodecs.available_codecs() == jcodecs.available_codecs()
    for name in tcodecs.available_codecs():
        t, j = tcodecs.codec_spec(name), jcodecs.codec_spec(name)
        assert (t.error_feedback, t.uses_rng, tcodecs.is_trivial(t)) == \
            (j.error_feedback, j.uses_rng, jcodecs.is_trivial(j))
    spec = tcodecs.CodecSpec(name="unit_codec", summary="test-only")
    try:
        assert tcodecs.register_codec(spec) is spec
        with pytest.raises(ValueError, match="already registered"):
            tcodecs.register_codec(spec)
        tcodecs.register_codec(spec, override=True)
    finally:
        tcodecs.unregister_codec("unit_codec")
    with pytest.raises(ValueError, match="meaningless without encode"):
        tcodecs.register_codec(tcodecs.CodecSpec(
            name="bad", summary="", uplink_bytes=lambda c, n: 1.0))
    with pytest.raises(ValueError, match="meaningless without encode"):
        tcodecs.register_codec(tcodecs.CodecSpec(
            name="bad", summary="", error_feedback=True))
    with pytest.raises(ValueError, match="registered: dp_gauss, int8"):
        tcodecs.codec_spec("nope")
    with pytest.raises(ValueError, match="unknown codec"):
        FederatedConfig(codec="nope")


def test_registered_codec_runs_on_both_engines(data):
    spec = tcodecs.CodecSpec(
        name="unit_double", summary="scale-2 identity (test-only)",
        encode=lambda cfg, draws, idx, flat, ef: (flat * 0.5,
                                                  flat.new_tensor(2.0),
                                                  None),
        uplink_bytes=lambda cfg, n: 2.0 * n)
    tcodecs.register_codec(spec)
    try:
        sel = _sel(2)
        losses = []
        for engine in ("loop", "batched"):
            hist, _ = _run(data, "fedavg", engine, "unit_double",
                           num_rounds=2, sel=sel)
            assert hist["bytes_up"] == [K * 2.0 * N_ELEMS] * 2
            losses.append(hist["loss"])
        dense, _ = _run(data, "fedavg", "loop", "none", num_rounds=2,
                        sel=sel)
        np.testing.assert_allclose(losses[0], losses[1], atol=1e-5)
        np.testing.assert_allclose(losses[0], dense["loss"], atol=1e-5)
    finally:
        tcodecs.unregister_codec("unit_double")


@pytest.mark.parametrize("engine", ["loop", "batched"])
def test_one_shot_error_feedback_covers_the_population(data, engine):
    """one_shot solves on every device, so topk's error feedback holds a
    slab for each of the N clients after a round."""
    _, tds, p0 = data
    cfg = one_shot_config(N, local_epochs=2, local_batch_size=10,
                          learning_rate=0.05, seed=5, codec="topk",
                          engine=engine)
    tr = FederatedTrainer(logreg_loss, tds, cfg, device="cpu")
    st = tr.init(params_from_numpy(p0, device="cpu"))
    st = tr.round(st)
    assert len(st.ef) == N
    assert all(float(st.ef[k].abs().max()) > 0 for k in range(N))
    hist, _ = tr.run(params_from_numpy(p0, device="cpu"), 1)
    assert np.isfinite(hist["loss"]).all()
    assert hist["bytes_up"] == [N * (np.ceil(0.1 * N_ELEMS) * 4.0 + 4.0)]
