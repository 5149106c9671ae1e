"""Training the port's Mamba mixer against the JAX package, on the CPU.

The scan's plain backward ``kernels/ref.selective_scan_bwd_ref`` (K8-bwd's
function: an explicit reverse walk over chunks recomputed from the saved
states ``H``) against torch autograd through the plain forward and
against ``jax.vjp`` of the reference's ``chunked_scan(_mamba_step(A))``
with the same cotangent; the autograd Function of ``kernels/
selective_scan.py`` on CPU tensors (its plain versions) under
``torch.func.vmap(torch.func.grad(...))`` with ``A`` mapped and unmapped;
``mamba_mixer``'s gradient against ``jax.grad`` of the reference's, with
a random ``a_log`` and ``b_dt``; and the train side's ``check_trainable``
taking jamba.  Inputs come from numpy; the reference runs under
``jax.jit``.

Tolerances: each gradient within 1e-5 x its own max |g| (f32 sums in
another order over a decaying recurrence); the vmap fold bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from torch.func import grad, vmap

from repro import configs as jconfigs
from repro.models import param as jparam
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ks
from repro_torch.launch import steps
from repro_torch.models import param, ssm

REL = 1e-5
ARCH = "jamba-v0.1-52b"
SMALL = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _scan_inputs(seed, B, S, di, N, groups=0):
    """numpy (xs, dt, Bc, Cc, A, dy) shaped as the mixer makes them: dt a
    softplus, A = -exp(a_log) with a random a_log, per group if
    ``groups``."""
    rng = np.random.default_rng(seed)
    xs, Bc, Cc, dy = (_normal(rng, B, S, n) for n in (di, N, N, di))
    dt = np.log1p(np.exp(_normal(rng, B, S, di) - 1.0)).astype(np.float32)
    a_shape = (groups, di, N) if groups else (di, N)
    A = -np.exp(_normal(rng, *a_shape, scale=0.5)).astype(np.float32)
    return xs, dt, Bc, Cc, A, dy


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: {err} > {REL} x {scale}"


# ---------------------------------------------------------------------------
# The plain backward
# ---------------------------------------------------------------------------

def _jax_scan_vjp(xs, dt, Bc, Cc, A, dy):
    """``jax.vjp`` of the reference's ``chunked_scan(_mamba_step(A))``
    from ``h = 0`` over (B, S, ...) inputs, at the cotangent ``dy``."""
    def scan(xs, dt, Bc, Cc, A):
        B, _, di = xs.shape
        swap = lambda a: a.swapaxes(0, 1)  # noqa: E731
        h0 = jnp.zeros((B, di, A.shape[-1]), jnp.float32)
        _, ys = jssm.chunked_scan(jssm._mamba_step(A), h0,
                                  (swap(xs), swap(dt), swap(Bc), swap(Cc)))
        return swap(ys)

    def vjp(xs, dt, Bc, Cc, A, dy):
        _, back = jax.vjp(scan, xs, dt, Bc, Cc, A)
        return back(dy)
    return jax.jit(vjp)(xs, dt, Bc, Cc, A, dy)


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("S", [16, 100, 128])
def test_scan_bwd_ref_matches_autograd_and_reference_vjp(S, N):
    """S=16 in one chunk, 100 (a chunk and a part: S % 64 != 0, which the
    reference scans unchunked) and 128 (two chunks, which it scans under
    its per-chunk checkpoint)."""
    arrays = _scan_inputs(S + N, 3, S, 24, N)
    xs, dt, Bc, Cc, A, dy = _t(arrays)
    y, H = ref.selective_scan_fwd_ref(xs, dt, Bc, Cc, A)
    assert H.shape == (3, -(-S // 64), 24, N)
    assert torch.equal(H[:, 0], torch.zeros_like(H[:, 0]))
    got = ref.selective_scan_bwd_ref(xs, dt, Bc, Cc, A, H, dy)
    leaves = [t.clone().requires_grad_(True) for t in (xs, dt, Bc, Cc, A)]
    y_ad = ref.selective_scan_ref(*leaves)
    assert torch.equal(y, y_ad.detach())
    want = torch.autograd.grad(y_ad, leaves, dy)
    jwant = _jax_scan_vjp(*arrays)
    for name, g, w, j in zip(("dxs", "ddt", "dBc", "dCc", "dA"), got, want,
                             jwant):
        _rel_close(g.numpy(), w.numpy(), f"{name} vs autograd")
        _rel_close(g.numpy(), j, f"{name} vs the reference's vjp")


def test_scan_bwd_ref_with_grouped_A_is_each_groups_own():
    """A (G, di, N): rows b take ``A[b // (B // G)]``; each group's
    outputs and dA are those of the group's rows scanned alone with its
    own A (within 1e-5 x max |g|)."""
    G, per = 3, 2
    xs, dt, Bc, Cc, A, dy = _t(_scan_inputs(7, G * per, 70, 16, 8,
                                            groups=G))
    y, H = ref.selective_scan_fwd_ref(xs, dt, Bc, Cc, A)
    got = ref.selective_scan_bwd_ref(xs, dt, Bc, Cc, A, H, dy)
    for g in range(G):
        rows = slice(g * per, (g + 1) * per)
        yg, Hg = ref.selective_scan_fwd_ref(xs[rows], dt[rows], Bc[rows],
                                            Cc[rows], A[g])
        _rel_close(y[rows].numpy(), yg.numpy(), "y")
        want = ref.selective_scan_bwd_ref(xs[rows], dt[rows], Bc[rows],
                                          Cc[rows], A[g], Hg, dy[rows])
        for a, b in zip(got[:4], want[:4]):
            _rel_close(a[rows].numpy(), b.numpy(), f"group {g}")
        _rel_close(got[4][g].numpy(), want[4].numpy(), f"group {g} dA")


# ---------------------------------------------------------------------------
# The autograd Function on its plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_mapped", [True, False])
def test_scan_function_vmap_grad_equals_per_client_grads(a_mapped):
    """Three clients' gradients of sum(w * y) (every input, ``a_log``
    mapped -- the trainer's per-client params -- or shared) under
    ``vmap(grad)`` against each client's own ``grad``, bit for bit; one
    forward and one backward call for the three clients."""
    K, B, S, di, N = 3, 2, 70, 8, 8
    rng = np.random.default_rng(3)
    xs, dt, Bc, Cc, _, w = _t(_scan_inputs(3, K * B, S, di, N))
    xs, dt, Bc, Cc = (t.reshape((K, B) + t.shape[1:])
                      for t in (xs, dt, Bc, Cc))
    w = w[:B]
    a_log = torch.from_numpy(_normal(rng, K, di, N, scale=0.5))
    if not a_mapped:
        a_log = a_log[0]
    calls = []

    def count(fn):
        def spy(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return spy

    def f(a_log, xs, dt, Bc, Cc):
        return (ks.selective_scan(xs, dt, Bc, Cc, -torch.exp(a_log))
                * w).sum()

    g_all = grad(f, argnums=(0, 1, 2, 3, 4))
    saved = ks.selective_scan_fwd, ks.selective_scan_bwd
    ks.selective_scan_fwd, ks.selective_scan_bwd = map(count, saved)
    try:
        got = vmap(g_all, in_dims=(0 if a_mapped else None, 0, 0, 0, 0))(
            a_log, xs, dt, Bc, Cc)
    finally:
        ks.selective_scan_fwd, ks.selective_scan_bwd = saved
    assert calls == ["selective_scan_fwd", "selective_scan_bwd"]
    for k in range(K):
        want = g_all(a_log[k] if a_mapped else a_log, xs[k], dt[k], Bc[k],
                     Cc[k])
        for a, b in zip(got, want):
            assert torch.equal(a[k], b)


def test_scan_function_keeps_states_only_under_grad():
    """The forward keeps ``H`` where a backward can follow (grad mode on
    and an input that requires grad); a second derivative raises."""
    xs, dt, Bc, Cc, A, _ = _t(_scan_inputs(5, 2, 20, 8, 8))
    kept = []
    saved = ks.selective_scan_fwd

    def spy(*a, with_states=False):
        kept.append(with_states)
        return saved(*a, with_states=with_states)

    ks.selective_scan_fwd = spy
    try:
        ks.selective_scan(xs, dt, Bc, Cc, A)
        with torch.no_grad():
            ks.selective_scan(xs, dt, Bc, Cc, A.requires_grad_(True))
        y = ks.selective_scan(xs, dt, Bc, Cc, A)
    finally:
        ks.selective_scan_fwd = saved
    assert kept == [False, False, True]
    (gA,) = torch.autograd.grad(y.sum(), A, create_graph=True)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(gA.sum(), A)


# ---------------------------------------------------------------------------
# The mixer and the train side
# ---------------------------------------------------------------------------

def test_mamba_mixer_grad_matches_reference():
    """d/d(x and every weight) of sum(w * mamba_mixer) at S=100 against
    ``jax.grad`` of the reference's mixer, a random ``a_log`` and
    ``b_dt`` (A is not -1 everywhere)."""
    jcfg = jconfigs.get_arch(ARCH).reduced(**SMALL)
    tcfg = configs.get_arch(ARCH).reduced(**SMALL)
    rng = np.random.default_rng(11)
    p = jparam.init_params(jssm.mamba_specs(jcfg), jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(np.asarray, p)
    p["a_log"] = _normal(rng, *p["a_log"].shape, scale=0.5)
    p["b_dt"] = _normal(rng, *p["b_dt"].shape, scale=0.5)
    x = _normal(rng, 2, 100, jcfg.d_model)
    w = _normal(rng, 2, 100, jcfg.d_model)

    def jloss(p, x):
        return jnp.sum(jssm.mamba_mixer(p, x, jcfg) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = param.params_from_numpy(p, device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = (ssm.mamba_mixer(leaves, tx, tcfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(out, [tx] + list(leaves.values()))
    _rel_close(grads[0].numpy(), jg[1], "x")
    for (k, _), g in zip(leaves.items(), grads[1:]):
        _rel_close(g.numpy(), jg[0][k], k)


def test_check_trainable_takes_jamba_and_refuses_the_rest():
    steps.check_trainable(configs.get_arch(ARCH))
    steps.check_trainable(configs.get_arch(ARCH).reduced(num_layers=1))
    for arch in ("internvl2-26b",):
        with pytest.raises(ValueError, match="not yet ported"):
            steps.check_trainable(configs.get_arch(arch))
