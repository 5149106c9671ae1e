"""The scanned driver's sampler against numpy's, on the CPU generator.

Ports tests/test_sampling_stats.py to ``repro_torch.core.server``:
``sample_devices`` (the python driver's numpy draw) and
``sample_devices_onchip`` (the scanned driver's draw from a
``torch.Generator``) must realize the same distribution through
different bit streams.  Frequency checks over large fixed-seed sample
batches, with the reference suite's seeds and bounds (deterministic, so
the thresholds never flake):

- two-sample chi-square on per-device inclusion marginals under
  weighted sampling without replacement (the Plackett-Luce case the
  Gumbel construction exists for), and for uniform sampling;
- with replacement against the exact expectation K * p_k;
- Bernoulli availability composing with both samplers' marginals;
- the Gumbel top-k at N=1e6 against equal-mass buckets;
- the population-scale guard: overflow and underflow weights give valid
  selections, and in-range weights keep their exact bits.

The same checks run on the card's generator in tests/test_torch_cuda.py.
"""
import numpy as np
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import server
from repro_torch.core.scenarios import (env_channels, realize_env_staged,
                                        scenario_spec, staged_availability,
                                        staged_work)

N, K = 8, 3
ROUNDS = 4000
# skewed weights resembling the lognormal device sizes
WEIGHTS = np.array([1, 1, 2, 3, 5, 8, 13, 21], np.float64)
WEIGHTS = WEIGHTS / WEIGHTS.sum()
# chi-square 99.9% critical value for df = N - 1 = 7
CHI2_BOUND = 24.3


def host_counts(rounds=ROUNDS, p=None, replace=False, seed=0, avail=None):
    """Per-device (inclusion, effective-inclusion) counts, numpy rng."""
    rng = np.random.default_rng(seed)
    inc = np.zeros(N)
    eff = np.zeros(N)
    for _ in range(rounds):
        sel = server.sample_devices(rng, N, K, p=p, replace=replace)
        np.add.at(inc, sel, 1.0)
        if avail is not None:
            active = rng.random(len(sel)) < avail
            np.add.at(eff, sel[active], 1.0)
    return inc, eff


def onchip_counts(rounds=ROUNDS, p=None, replace=False, seed=0, avail=None,
                  device="cpu"):
    """The same counts from the scanned driver's sampler."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pt_ = None if p is None else torch.as_tensor(p, dtype=torch.float32,
                                                 device=device)
    inc = torch.zeros(N, device=device)
    eff = torch.zeros(N, device=device)
    for _ in range(rounds):
        sel = server.sample_devices_onchip(gen, N, K, p=pt_,
                                           replace=replace)
        inc.index_add_(0, sel, torch.ones(sel.shape[0], device=device))
        if avail is not None:
            active = torch.rand(sel.shape[0], generator=gen,
                                device=device) < avail
            eff.index_add_(0, sel, active.float())
    return inc.cpu().numpy(), eff.cpu().numpy()


def chi2_two_sample(a, b):
    """Two-sample chi-square statistic over matched count vectors."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tot = a + b
    return float((((a - b) ** 2) / np.maximum(tot, 1e-12)).sum())


def test_weighted_without_replacement_marginals_match():
    inc_h, _ = host_counts(p=WEIGHTS)
    inc_d, _ = onchip_counts(p=WEIGHTS)
    assert inc_h.sum() == inc_d.sum() == ROUNDS * K
    assert chi2_two_sample(inc_h, inc_d) < CHI2_BOUND


def test_with_replacement_marginals_match_exact_expectation():
    expected = ROUNDS * K * WEIGHTS
    sd = np.sqrt(ROUNDS * K * WEIGHTS * (1 - WEIGHTS))
    for counts, _ in (host_counts(p=WEIGHTS, replace=True),
                      onchip_counts(p=WEIGHTS, replace=True)):
        assert np.all(np.abs(counts - expected) < 4.5 * sd + 1.0)


def test_uniform_marginals_match():
    inc_h, _ = host_counts()
    inc_d, _ = onchip_counts()
    expected = ROUNDS * K / N
    for counts in (inc_h, inc_d):
        assert np.all(np.abs(counts - expected) < 5.0 * np.sqrt(expected))
    assert chi2_two_sample(inc_h, inc_d) < CHI2_BOUND


def test_uniform_with_replacement_marginals():
    """``randint`` with replacement: every device at K/N a round."""
    counts, _ = onchip_counts(replace=True)
    expected = ROUNDS * K / N
    assert np.all(np.abs(counts - expected) < 5.0 * np.sqrt(expected))


def test_bernoulli_availability_composes_with_both_samplers():
    q = 0.6
    inc_h, eff_h = host_counts(p=WEIGHTS, avail=q)
    inc_d, eff_d = onchip_counts(p=WEIGHTS, avail=q)
    assert chi2_two_sample(eff_h, eff_d) < CHI2_BOUND
    for inc, eff in ((inc_h, eff_h), (inc_d, eff_d)):
        sd = np.sqrt(np.maximum(inc * q * (1 - q), 1.0))
        assert np.all(np.abs(eff - inc * q) < 5.0 * sd)


def test_population_scale_gumbel_chi_square():
    """Gumbel top-k at N=1e6, K<<N: inclusion counts over equal-mass
    device buckets follow the weights (chi-square crit. value at df=15,
    99.9%, is 37.7; the reference's bound is 40)."""
    n, k, rounds, buckets = 1_000_000, 16, 256, 16
    rng = np.random.default_rng(0)
    w = rng.lognormal(0.0, 1.5, n)
    p = w / w.sum()
    cum = np.cumsum(p)
    edges = np.searchsorted(cum, np.arange(1, buckets) / buckets)
    bucket_of = torch.from_numpy(np.digitize(np.arange(n), edges))
    mass = np.diff(np.concatenate([[0.0], cum[edges - 1], [1.0]]))
    pt_ = torch.as_tensor(p, dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    counts = torch.zeros(buckets, dtype=torch.float64)
    for _ in range(rounds):
        sel = server.sample_devices_onchip(gen, n, k, p=pt_)
        assert len(torch.unique(sel)) == k
        counts.index_add_(0, bucket_of[sel],
                          torch.ones(k, dtype=torch.float64))
    counts = counts.numpy()
    assert counts.sum() == rounds * k
    expected = rounds * k * mass
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, (chi2, counts, expected)


def _assert_valid_selection(sel, n, k, replace):
    sel = sel.numpy()
    assert sel.shape == (k,)
    assert ((0 <= sel) & (sel < n)).all(), sel
    if not replace:
        assert len(np.unique(sel)) == k, sel


def test_sampler_guard_overflow_weights():
    """Raw weights whose float32 sum overflows still give valid,
    weight-respecting selections (the max-rescale kicks in)."""
    n, k = 1024, 8
    w = torch.from_numpy(np.geomspace(1e30, 3e38, n).astype(np.float32))
    with np.errstate(over="ignore"):
        assert np.float32(w.numpy().astype(np.float64).sum()) == np.inf
    for replace in (False, True):
        sel = server.sample_devices_onchip(
            torch.Generator().manual_seed(3), n, k, p=w, replace=replace)
        _assert_valid_selection(sel, n, k, replace)
    sel = server.sample_devices_onchip(torch.Generator().manual_seed(3), n,
                                       k, p=w)
    assert int(sel.min()) > n // 2, sel


def test_sampler_guard_underflow_weights():
    """Denormal-regime weights (the float32 sum underflows): the guard
    rescales by the max, so normalization stays finite."""
    n, k = 1024, 8
    w = torch.from_numpy(np.geomspace(1e-38, 1e-32, n).astype(np.float32))
    for replace in (False, True):
        sel = server.sample_devices_onchip(
            torch.Generator().manual_seed(5), n, k, p=w, replace=replace)
        _assert_valid_selection(sel, n, k, replace)


def test_sampler_guard_preserves_normal_regime_bits():
    """In the normal regime the guard divides by exactly 1.0, so the
    selections equal the unguarded normalize's bit for bit."""
    n, k = 64, 8
    p32 = torch.from_numpy(WEIGHTS.repeat(8).astype(np.float32))

    def unguarded(gen, p):
        p = p / p.sum()
        u = torch.rand(n, generator=gen)
        g = -torch.log(-torch.log(torch.clamp(
            u, min=torch.finfo(torch.float32).tiny)))
        return torch.topk(g + torch.log(torch.clamp(p, min=1e-30)),
                          k).indices

    got = server.sample_devices_onchip(torch.Generator().manual_seed(11), n,
                                       k, p=p32)
    want = unguarded(torch.Generator().manual_seed(11), p32)
    assert torch.equal(got, want)


def test_realize_env_bernoulli_matches_direct_thinning():
    """The staged interpreter's availability gate (what the scanned
    driver runs on the card) is exactly the u < avail_prob thinning."""
    cfg = FederatedConfig(scenario="bernoulli", avail_prob=0.35)
    spec = scenario_spec("bernoulli")
    assert env_channels(spec) == ("avail",)
    p = staged_availability(spec, cfg, N, torch.tensor(0.0))
    frac = staged_work(spec, cfg, N)
    rng = np.random.default_rng(42)
    sel = torch.arange(K)
    hits, trials = 0, 2000
    for _ in range(trials):
        u = torch.from_numpy(rng.random(N).astype(np.float32))
        env = realize_env_staged(spec, cfg, sel, p, frac, {"avail": u})
        assert torch.equal(env.active, (u[:K] < 0.35).float())
        hits += int(env.active.sum())
    assert abs(hits / (trials * K) - 0.35) < 0.03
