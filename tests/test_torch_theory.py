"""The port's theory instrumentation against the JAX package's (§IV).

B-local dissimilarity (Definition 2), the sufficient-decrease constants
of Theorems 3, 5 and 7 and Corollary 4, γ-inexactness (Definition 1) with
the near-exact subproblem solver, and the trainer's
``measure_dissimilarity``: the same inputs through both packages, on the
CPU, within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.core import client as jclient
from repro.core import pytree as jpt
from repro.core import theory as jtheory
from repro.data import make_sent140_like as j_make_sent140_like
from repro.data import make_synthetic as j_make_synthetic
from repro.models import small as jsmall
from repro.models.param import init_params as j_init_params
from repro_torch import core
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core import theory
from repro_torch.data import make_sent140_like, make_synthetic
from repro_torch.models import small
from repro_torch.models.param import params_from_numpy, params_to_numpy

TOL = 1e-5


def _grads(n, seed=0):
    """``n`` numpy gradient trees with a nested dict, as the LSTMs have."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(6, 3)).astype(np.float32),
             "cell": {"b": rng.normal(size=5).astype(np.float32),
                      "wx": rng.normal(size=(2, 5)).astype(np.float32)}}
            for _ in range(n)]


def _both(trees):
    return ([params_from_numpy(t, device="cpu") for t in trees],
            [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])


@pytest.mark.parametrize("p", [None, [0.5, 0.2, 0.2, 0.1], [3, 1, 1, 5]])
def test_b_dissimilarity_matches_reference(p):
    tg, jg = _both(_grads(4))
    got = theory.b_dissimilarity(tg, p)
    want = jtheory.b_dissimilarity(jg, p)
    assert isinstance(got, float) and got >= 1.0
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


def test_b_dissimilarity_is_one_for_identical_gradients():
    tg, _ = _both(_grads(1) * 5)
    assert theory.b_dissimilarity(tg) == pytest.approx(1.0, abs=TOL)
    assert theory.b_dissimilarity(tg, [1, 2, 3, 4, 5]) == \
        pytest.approx(1.0, abs=TOL)


def test_b_dissimilarity_is_inf_for_a_zero_mean():
    g = params_from_numpy(_grads(1)[0], device="cpu")
    assert theory.b_dissimilarity([g, pt.scale(g, -1.0)]) == float("inf")


def test_weighted_mean_matches_reference():
    tg, jg = _both(_grads(3, seed=5))
    w = [0.2, 0.5, 0.3]
    got = pt.weighted_mean(tg, w)
    want = jpt.weighted_mean(jg, w)
    for a, b in zip(pt.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("rho_convex", (10.0, 0.0, 1.0, 1.0)),
    ("rho_convex", (0.5, 0.3, 2.0, 3.0)),
    ("rho_nonconvex", (20.0, 0.1, 1.0, 1.5, 1.0)),
    ("rho_nonconvex", (3.0, 0.0, 0.5, 2.0, 0.5)),
    ("rho_device_specific", ([10.0, 5.0, 8.0], [0.1, 0.0, 0.3],
                             [1.0, 2.0, 0.5], 1.5)),
    ("corollary4_mu", (2.0, 10.0)),
])
def test_theory_constants_match_reference(name, args):
    got = getattr(theory, name)(*args)
    want = getattr(jtheory, name)(*args)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    # exported lazily from the package, as the reference exports them
    assert getattr(core, name) is getattr(theory, name)


def test_rho_nonconvex_requires_mu_gt_lambda():
    with pytest.raises(AssertionError):
        theory.rho_nonconvex(mu=1.0, gamma=0.0, L=1.0, B=1.0, lam=2.0)


def test_gamma_inexactness_matches_reference():
    tw, jw = _both(_grads(3, seed=2))
    got = core.gamma_inexactness(*tw)
    want = jclient.gamma_inexactness(*jw)
    assert got.ndim == 0
    assert float(got) == pytest.approx(float(want), rel=TOL)
    # an exact solve is 0-inexact; w_exact == w0 leaves the floor 1e-12
    assert float(core.gamma_inexactness(tw[1], tw[1], tw[0])) == 0.0
    assert float(core.gamma_inexactness(tw[0], tw[1], tw[1])) > 1e6


@pytest.fixture(scope="module")
def synthetic():
    jds = j_make_synthetic(0.5, 0.5, num_devices=6, seed=2)
    tds = make_synthetic(0.5, 0.5, num_devices=6, seed=2, device="cpu")
    p0 = j_init_params(jsmall.logreg_specs(60, 10), jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(
        lambda x: np.asarray(x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(1), x.shape)), p0)
    return jds, tds, p0


def test_exact_solver_matches_reference(synthetic):
    """The near-exact solve of device 1's subproblem, and how inexact one
    epoch of the practical solver is against it."""
    jds, tds, p0 = synthetic
    rng = np.random.default_rng(3)
    corr = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in p0.items()}
    kw = dict(learning_rate=0.05, num_iters=300)
    got = core.make_exact_solver(small.logreg_loss, **kw)(
        params_from_numpy(p0, device="cpu"),
        params_from_numpy(corr, device="cpu"), 0.1, tds.device_batches(1))
    jp, jc = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p0, corr))
    want = jclient.make_exact_solver(jsmall.logreg_loss, **kw)(
        jp, jc, 0.1, jds.device_batches(1))
    for a, b in zip(pt.leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)

    from repro.core.client import make_local_solver as j_local
    from repro_torch.core.client import make_local_solver
    inexact = make_local_solver(small.logreg_loss, learning_rate=0.05,
                                num_epochs=1)(
        params_from_numpy(p0, device="cpu"),
        params_from_numpy(corr, device="cpu"), 0.1,
        tds.device_batches(1)).params
    j_inexact = j_local(jsmall.logreg_loss, learning_rate=0.05,
                        num_epochs=1)(jp, jc, 0.1,
                                      jds.device_batches(1)).params
    gamma = float(core.gamma_inexactness(
        inexact, got, params_from_numpy(p0, device="cpu")))
    j_gamma = float(jclient.gamma_inexactness(j_inexact, want, jp))
    assert 0 < gamma < 1
    assert gamma == pytest.approx(j_gamma, rel=1e-4, abs=TOL)


def test_measure_dissimilarity_matches_reference(synthetic):
    jds, tds, p0 = synthetic
    got = FederatedTrainer(small.logreg_loss, tds, FederatedConfig(
        num_devices=6, devices_per_round=3), device="cpu") \
        .measure_dissimilarity(params_from_numpy(p0, device="cpu"))
    want = JTrainer(jsmall.logreg_loss, jds, JConfig(
        num_devices=6, devices_per_round=3)).measure_dissimilarity(
        jax.tree_util.tree_map(jnp.asarray, p0))
    assert got > 1.0
    assert got == pytest.approx(want, rel=TOL)


def test_measure_dissimilarity_on_the_lstm_matches_reference():
    """Sent140-like through the LSTM: a nested parameter tree."""
    jds = j_make_sent140_like(num_devices=5, seed=1)
    tds = make_sent140_like(num_devices=5, seed=1, device="cpu")
    p0 = jax.tree_util.tree_map(np.asarray, j_init_params(
        jsmall.sentlstm_specs(400, 25, 16), jax.random.PRNGKey(2)))
    cfg = dict(num_devices=5, devices_per_round=2)
    got = FederatedTrainer(small.sentlstm_loss, tds, FederatedConfig(**cfg),
                           device="cpu").measure_dissimilarity(
        params_from_numpy(p0, device="cpu"))
    want = JTrainer(jsmall.sentlstm_loss, jds, JConfig(**cfg)) \
        .measure_dissimilarity(jax.tree_util.tree_map(jnp.asarray, p0))
    assert got == pytest.approx(want, rel=TOL)


def test_measure_dissimilarity_separates_iid_from_heterogeneous():
    """Definition 2 on the port alone: IID data is near 1, synthetic(1,1)
    well above it (the reference's own test of the claim)."""
    p = {"w": torch.from_numpy(np.random.default_rng(5).normal(
        size=(60, 10)).astype(np.float32) * 0.1), "b": torch.zeros(10)}
    bs = []
    for a, b, iid in [(0, 0, True), (1, 1, False)]:
        ds = make_synthetic(a, b, iid=iid, seed=1, device="cpu")
        bs.append(FederatedTrainer(small.logreg_loss, ds, FederatedConfig(),
                                   device="cpu").measure_dissimilarity(p))
    assert bs[0] >= 1.0 - 1e-6 and bs[1] > 1.5 * bs[0], bs
