"""Training the port's xLSTM blocks (xlstm-350m) against the JAX
package, on the CPU.

The scans' plain backward (``kernels/ref.mlstm_scan_bwd_ref``, K9-bwd's
function: an explicit reverse walk over chunks recomputed from the saved
states; ``ref.slstm_scan_bwd_ref``, K10-bwd's: a walk over every step's
saved state) against torch autograd through the plain forward and
against ``jax.vjp`` of the reference's ``chunked_scan(_mlstm_step)`` /
``(_slstm_step)`` with the same cotangent, at S=16 (one chunk), 100
(unchunked in the reference) and 128 (two checkpointed chunks), grouped
recurrent matrices, and exact ties of the stabiliser ``m`` and of the
two clamps, where the reference splits ``jnp.maximum``'s gradient 0.5 /
0.5; the autograd Functions of ``kernels/xlstm_scan.py`` on CPU tensors
under ``torch.func.vmap(torch.func.grad(...))`` (the sLSTM's matrices
mapped and unmapped); both mixers' gradients against ``jax.grad`` of the
reference's; and xlstm-350m reduced to one repeat of its (sLSTM, mLSTM)
pattern (d_model 64, 4 heads: dk 32, dh 16; V=128): ``loss_fn`` under
every remat policy, the three round steps, ``loss_fn`` under
``vmap(grad)``, the federated trainer (flat and per_leaf bit for bit)
and one pod against the reference.  Inputs come from numpy; the
reference runs under ``jax.jit``.

Tolerances: scan and mixer gradients within 1e-5 x each output's max
|g| (f32 sums in another order over a stabilised recurrence); loss,
steps and trainer atol 1e-5; the pod round 2e-5 (the reference's own bar); the
vmap fold bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.core.client import make_batched_solver
from repro_torch.data.batching import stack_device_batches
from repro_torch.kernels import ref
from repro_torch.kernels import xlstm_scan as kx
from repro_torch.launch import podfed, steps, train
from repro_torch.models import param, transformer, xlstm

REL = 1e-5
ATOL = 1e-5
POD_ATOL = 2e-5
ARCH = "xlstm-350m"
SMALL = dict(num_layers=1, d_model=64, num_heads=4, vocab_size=128)
MLSTM_OUT = ("dq", "dk", "dv", "dlog_i", "dlog_f")
SLSTM_OUT = ("dzx", "dix", "dfx", "dox", "dr_z", "dr_i", "dr_f", "dr_o")


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: {err} > {REL} x {scale}"


def _close(got, want, atol=ATOL):
    g, w = pt.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The reference's scans and their vjp (jitted once a shape)
# ---------------------------------------------------------------------------

def _swap(a):
    return a.swapaxes(0, 1)


def _jax_mlstm(q, k, v, log_i, log_f):
    B, _, H, dk = q.shape
    carry = (jnp.zeros((B, H, dk, v.shape[-1]), jnp.float32),
             jnp.zeros((B, H, dk), jnp.float32),
             jnp.full((B, H), -1e30, jnp.float32))
    _, hs = jssm.chunked_scan(jxlstm._mlstm_step(dk), carry,
                              tuple(map(_swap, (q, k, v, log_i, log_f))))
    return _swap(hs)


def _jax_slstm(zx, ix, fx, ox, r_z, r_i, r_f, r_o):
    B, _, H, dh = zx.shape
    zeros = jnp.zeros((B, H, dh), jnp.float32)
    m = jnp.full((B, H, dh), -1e30, jnp.float32)
    params = {"r_z": r_z, "r_i": r_i, "r_f": r_f, "r_o": r_o}
    _, hs = jssm.chunked_scan(jxlstm._slstm_step(params, H),
                              (zeros, zeros, m, zeros),
                              tuple(map(_swap, (zx, ix, fx, ox))))
    return _swap(hs)


def _vjp_of(fn):
    return jax.jit(lambda args, dh: jax.vjp(fn, *args)[1](dh))


_MLSTM_VJP = _vjp_of(_jax_mlstm)
_SLSTM_VJP = _vjp_of(_jax_slstm)


def _mlstm_inputs(seed, B, S, H, dk):
    """numpy q, k, v, log_i (O(1)), log_f (a log-sigmoid of N(2, 1)) and
    a cotangent dh."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (_normal(rng, B, S, H, dk) for _ in range(4))
    log_i = _normal(rng, B, S, H)
    log_f = ref.logsigmoid(torch.from_numpy(
        _normal(rng, B, S, H) + 2.0)).numpy()
    return (q, k, v, log_i, log_f), dh


def _slstm_inputs(seed, B, S, H, dh, groups=0):
    """numpy zx, ix, fx, ox (O(1)), the recurrent matrices at 0.3 (larger
    than the model's 0.02, so that the recurrence shows), per group if
    ``groups``, and a cotangent."""
    rng = np.random.default_rng(seed)
    xs = [_normal(rng, B, S, H, dh) for _ in range(4)]
    shape = ((groups,) if groups else ()) + (H, dh, dh)
    rs = [_normal(rng, *shape, scale=0.3) for _ in range(4)]
    return tuple(xs + rs), _normal(rng, B, S, H, dh)


def _check_mlstm_bwd(args, dh):
    targs = _t(args)
    h, *states = ref.mlstm_scan_fwd_ref(*targs)
    assert torch.equal(h, ref.mlstm_scan_ref(*targs))
    got = ref.mlstm_scan_bwd_ref(*targs, h, *states, torch.from_numpy(dh))
    leaves = [a.clone().requires_grad_(True) for a in targs]
    want = torch.autograd.grad(ref.mlstm_scan_ref(*leaves), leaves,
                               torch.from_numpy(dh))
    jwant = _MLSTM_VJP(args, dh)
    for name, g, w, j in zip(MLSTM_OUT, got, want, jwant):
        _rel_close(g.numpy(), w.numpy(), f"{name} vs autograd")
        _rel_close(g.numpy(), np.asarray(j), f"{name} vs the reference")


def _check_slstm_bwd(args, dh):
    targs = _t(args)
    out = ref.slstm_scan_fwd_ref(*targs)
    assert torch.equal(out[0], ref.slstm_scan_ref(*targs))
    got = ref.slstm_scan_bwd_ref(*targs[4:], *out, torch.from_numpy(dh))
    leaves = [a.clone().requires_grad_(True) for a in targs]
    want = torch.autograd.grad(ref.slstm_scan_ref(*leaves), leaves,
                               torch.from_numpy(dh))
    jwant = _SLSTM_VJP(args, dh)
    for name, g, w, j in zip(SLSTM_OUT, got, want, jwant):
        _rel_close(g.numpy(), w.numpy(), f"{name} vs autograd")
        _rel_close(g.numpy(), np.asarray(j), f"{name} vs the reference")


# ---------------------------------------------------------------------------
# The plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", kx.SLSTM_DIMS)
def test_slstm_plan_splits_each_head_over_a_cluster(dh):
    """K10's and K10-bwd's launch plan at each head dim they take: a
    portable cluster (at most 8 blocks) of the fewest blocks that hold a
    head's four (dh, dh) f32 matrices at 128 KiB a block or less, which
    splits dh into whole warps of whole columns, each column's lanes
    holding its 4 dh entries evenly (64 a lane at most) and numbering at
    least the blocks they store its value into; a block's matrices and
    shared memory within 227 KiB, its shared memory within the 48 KiB a
    block has without the opt-in; tiles of 512 floats a gate."""
    p = kx.slstm_plan(dh)
    slab = 16 * dh * dh // p.cluster          # a block's matrix bytes
    assert 1 <= p.cluster <= 8 and dh % p.cluster == 0
    assert slab <= 128 * 1024
    assert p.cluster == 1 or 2 * slab > 128 * 1024
    assert p.cols == dh // p.cluster
    lanes = p.threads // p.cols
    assert p.threads == p.cols * lanes and p.threads % 32 == 0
    assert 32 % lanes == 0 and lanes >= p.cluster
    assert (4 * dh) % lanes == 0 and 4 * dh // lanes <= 64
    assert p.tile * p.cols == 512
    assert p.on_chip_bytes == slab + p.shared_bytes <= 227 * 1024
    assert p.shared_bytes <= 48 * 1024


@pytest.mark.parametrize("dk", kx.MLSTM_DIMS)
def test_mlstm_plan_keeps_the_backward_states_on_chip(dk):
    """K9-bwd's and K9's launch plan at each head dim they take: the walk's
    blocks of ``cols`` columns split dk into whole warps of whole rows; its
    sub-chunks divide a chunk of 64 steps and their states of the block's
    columns fill 128 KB; its cluster divides the head's column blocks, at
    most 8, each rank a whole number of float4 rows;
    both kernels' shared memory within a block's 232,448 bytes; and the
    scratch holds no recomputed state: at (x1) (B=1, S=4096, H=4) it is
    at most 7/64 of the B·H·64·dk² floats the states took before plus
    the partial sums of 16-column blocks, and it grows with S alone."""
    p = kx.mlstm_plan(dk)
    rows = dk // p.threads
    assert dk % p.cols == 0 and p.threads * rows == dk
    assert p.threads % 32 == 0 and rows in (1, 2)
    assert kx.CHUNK % p.sub == 0 and p.sub * dk * p.cols * 4 == 128 * 1024
    blocks = dk // p.cols
    assert blocks % p.cluster == 0 and 1 <= p.cluster <= 8
    assert (dk // p.cluster) % 4 == 0
    assert p.shared_bytes <= 232_448 and p.fwd_shared_bytes <= 232_448
    assert dk % p.fwd_cols == 0 and p.fwd_cols % 4 == 0
    assert p.fwd_threads == dk + 32                # 4 x 4 a thread, a warp
    assert dk * p.fwd_cols == 16 * (p.fwd_threads - 32)
    assert kx.CHUNK % p.fwd_tile == 0
    B, S, H = 1, 4096, 4
    before_states = B * H * kx.CHUNK * dk * dk
    before_partials = B * H * (dk // 16) * S * (2 * dk + 1)
    got = kx.mlstm_bwd_scratch_floats(B, S, H, dk)
    assert got <= 7 * before_states // 64 + before_partials
    assert got == 64 * kx.mlstm_bwd_scratch_floats(B, S // 64, H, dk)


@pytest.mark.parametrize("S", [16, 100, 128])
def test_mlstm_bwd_ref_matches_autograd_and_reference_vjp(S):
    """S=16 in one chunk, 100 (a chunk and a part: S % 64 != 0, which the
    reference scans unchunked) and 128 (two chunks, which it scans under
    its per-chunk checkpoint)."""
    args, dh = _mlstm_inputs(S, 2, S, 3, 8)
    _check_mlstm_bwd(args, dh)
    C = ref.mlstm_scan_fwd_ref(*_t(args))[1]
    assert C.shape == (2, -(-S // 64), 3, 8, 8)
    assert torch.equal(C[:, 0], torch.zeros_like(C[:, 0]))


@pytest.mark.parametrize("S", [16, 100, 128])
def test_slstm_bwd_ref_matches_autograd_and_reference_vjp(S):
    args, dh = _slstm_inputs(S + 1, 2, S, 3, 8)
    _check_slstm_bwd(args, dh)


def test_slstm_bwd_ref_with_grouped_r_is_each_groups_own():
    """r (G, H, dh, dh): rows b take ``r[b // (B // G)]``; each group's
    outputs and dr are those of the group's rows scanned alone with its
    own r's (within 1e-5 x max |g|), and autograd agrees."""
    G, per = 3, 2
    args, dh = _slstm_inputs(7, G * per, 70, 2, 8, groups=G)
    targs, tdh = _t(args), torch.from_numpy(dh)
    out = ref.slstm_scan_fwd_ref(*targs)
    got = ref.slstm_scan_bwd_ref(*targs[4:], *out, tdh)
    leaves = [a.clone().requires_grad_(True) for a in targs]
    want = torch.autograd.grad(ref.slstm_scan_ref(*leaves), leaves, tdh)
    for name, a, b in zip(SLSTM_OUT, got, want):
        _rel_close(a.numpy(), b.numpy(), f"{name} vs autograd")
    for g in range(G):
        rows = slice(g * per, (g + 1) * per)
        own = [x[rows] for x in targs[:4]] + [r[g] for r in targs[4:]]
        out_g = ref.slstm_scan_fwd_ref(*own)
        _rel_close(out[0][rows].numpy(), out_g[0].numpy(), "h")
        want_g = ref.slstm_scan_bwd_ref(*own[4:], *out_g, tdh[rows])
        for name, a, b in zip(SLSTM_OUT[:4], got[:4], want_g[:4]):
            _rel_close(a[rows].numpy(), b.numpy(), f"group {g} {name}")
        for name, a, b in zip(SLSTM_OUT[4:], got[4:], want_g[4:]):
            _rel_close(a[g].numpy(), b.numpy(), f"group {g} {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_stabiliser_ties_split_as_the_reference(kind):
    """Every step from the second on has log_f + m == log_i (the sLSTM:
    f_raw = 0, whose log-sigmoid -ln 2 both packages round alike, and
    r_i = r_f = 0, so that the gates' pre-activations are the inputs
    exactly): the reference splits the stabiliser's gradient 0.5 / 0.5
    there, and so do the plain backward and autograd."""
    S = 16
    if kind == "mlstm":
        args, dh = _mlstm_inputs(21, 2, S, 3, 8)
        log_i, log_f = args[3].copy(), args[4]
        for t in range(1, S):   # m_{t-1} = log_i[t-1] along the ties
            log_i[:, t] = log_f[:, t] + log_i[:, t - 1]
        args = args[:3] + (log_i, log_f)
        m_new = np.maximum(log_f[:, 1:] + log_i[:, :-1], log_i[:, 1:])
        assert np.array_equal(m_new, log_i[:, 1:])
        _check_mlstm_bwd(args, dh)
        return
    args, dh = _slstm_inputs(22, 2, S, 3, 8)
    zx, ix, fx, ox, r_z, r_i, r_f, r_o = args
    fx = np.zeros_like(fx)
    r_i, r_f = np.zeros_like(r_i), np.zeros_like(r_f)
    log_f = ref.logsigmoid(torch.zeros(())).numpy()
    assert log_f == np.asarray(jxlstm._logsigmoid(jnp.float32(0.0)))
    ix = ix.copy()
    for t in range(1, S):
        ix[:, t] = log_f + ix[:, t - 1]
    _check_slstm_bwd((zx, ix, fx, ox, r_z, r_i, r_f, r_o), dh)


# ---------------------------------------------------------------------------
# The derivatives at the ties of logsigmoid and the clamps
# ---------------------------------------------------------------------------

def test_logsigmoid_gradient_is_the_reference_s():
    """``ref.logsigmoid``'s gradient is ``sigmoid(-x)``: exactly 0.5 at x
    = 0, as ``jax.grad`` of the reference's ``-softplus(-x)`` gives, and
    within 1e-6 of the reference's elsewhere (a few f32 ulps of a value
    in [0, 1]: the reference forms it as exp(-x - softplus(-x))); its
    values within 4.8e-7 of the reference's on N(0, 8) draws (half an
    ulp at |x| in [8, 16], where the two formulas round apart), finite
    at -1e30."""
    x = np.concatenate([np.float32([0.0, 1e-8, -1e-8, 3.0, -3.0, 40.0,
                                    -40.0, -1e30]),
                        _normal(np.random.default_rng(0), 10 ** 4,
                                scale=8.0)])
    tx = torch.from_numpy(x).requires_grad_(True)
    val = ref.logsigmoid(tx)
    (got,) = torch.autograd.grad(val.sum(), tx)
    jval = np.asarray(jax.jit(jxlstm._logsigmoid)(x))
    want = np.asarray(jax.jit(jax.vmap(jax.grad(jxlstm._logsigmoid)))(x))
    assert float(got[0]) == 0.5 == float(want[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(val.detach().numpy(), jval, atol=4.8e-7,
                               rtol=0)
    assert np.isfinite(val.detach().numpy()).all()


def test_mlstm_den_clamp_tie_matches_reference():
    """One step from the initial state with |n . q s| == 1 exactly (n = k
    = (2, 0, 0, 0), q = (1, 0, 0, 0), s = 1/2): ``max(den, 1)``'s gradient
    goes half to den, as in the reference, through the step's autograd
    and the plain backward."""
    rng = np.random.default_rng(3)
    q, k, v, dh = (np.zeros((1, 1, 1, 4), np.float32) for _ in range(4))
    q[..., 0], k[..., 0] = 1.0, 2.0
    v[:] = _normal(rng, 1, 1, 1, 4)
    dh[:] = _normal(rng, 1, 1, 1, 4)
    log_i = np.full((1, 1, 1), 0.25, np.float32)
    log_f = np.full((1, 1, 1), -0.5, np.float32)
    _check_mlstm_bwd((q, k, v, log_i, log_f), dh)


def test_slstm_n_clamp_tie_matches_reference():
    """One step from a carried state whose n comes out at exactly 1e-6
    (f = 1: m_new = log_f + m; i = 0): ``max(n, 1e-6)``'s gradient goes
    half to n, in ``ref.slstm_step`` as in the reference's step."""
    rng = np.random.default_rng(4)
    H, dh = 2, 4
    rs = [_normal(rng, H, dh, dh, scale=0.3) for _ in range(4)]
    c, h, w = (_normal(rng, 1, H, dh) for _ in range(3))
    n = np.full((1, H, dh), np.float32(1e-6), np.float32)
    zx, ox = _normal(rng, 1, H, dh), _normal(rng, 1, H, dh)
    fx = np.zeros((1, H, dh), np.float32)
    ix = np.full((1, H, dh), -1e4, np.float32)
    # f_raw = fx + h r_f: choose fx so that f_raw = 0 exactly, and m so that
    # m_new = log_f + m
    fx = -np.einsum("bhi,hij->bhj", h, rs[2]).astype(np.float32)
    m = np.full((1, H, dh), 1.0, np.float32)

    def jstep(n, c, m):
        params = dict(zip(("r_z", "r_i", "r_f", "r_o"), rs))
        (_, n_new, _, _), out = jxlstm._slstm_step(params, H)(
            (c, n, m, h), (zx, ix, fx, ox))
        return jnp.sum(out * w), n_new

    (_, jn_new), jg = jax.value_and_grad(jstep, argnums=(0, 1, 2),
                                         has_aux=True)(n, c, m)
    tn, tc, tm = (torch.from_numpy(a).requires_grad_(True)
                  for a in (n, c, m))
    (_, n_new, _, _), out = ref.slstm_step(*_t(rs))(
        (tc, tn, tm, torch.from_numpy(h)),
        tuple(_t((zx, ix, fx, ox))))
    assert np.array_equal(np.asarray(jn_new), n)
    assert torch.equal(n_new, torch.from_numpy(n))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tn, tc, tm))
    for g, j in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-7,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# The autograd Functions on their plain versions
# ---------------------------------------------------------------------------

def _spy(calls, fn):
    def spy(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)
    return spy


@pytest.mark.parametrize("case", ["mlstm", "slstm r mapped",
                                  "slstm r unmapped"])
def test_scan_functions_vmap_grad_equal_per_client_grads(case,
                                                         monkeypatch):
    """Three clients' gradients of sum(w * h) under ``vmap(grad)`` against
    each client's own ``grad``, bit for bit; one forward and one backward
    call for the three clients (the sLSTM's r's a client, the trainer's
    per-client params, or shared)."""
    K, B, S, H, D = 3, 2, 70, 2, 8
    calls = []
    if case == "mlstm":
        args, w = _mlstm_inputs(5, K * B, S, H, D)
        args = [a.reshape((K, B) + a.shape[1:]) for a in _t(args)]
        w = torch.from_numpy(w[:B])

        def f(q, k, v, log_i, log_f):
            return (kx.mlstm_scan(q, k, v, log_i, log_f) * w).sum()
        dims = (0,) * 5
        names = ("mlstm_scan_fwd", "mlstm_scan_bwd")
    else:
        args, w = _slstm_inputs(6, K * B, S, H, D, groups=K)
        args = _t(args)
        xs = [a.reshape((K, B) + a.shape[1:]) for a in args[:4]]
        rs = list(args[4:]) if case == "slstm r mapped" else \
            [r[0] for r in args[4:]]
        args, w = xs + rs, torch.from_numpy(w[:B])

        def f(zx, ix, fx, ox, r_z, r_i, r_f, r_o):
            return (kx.slstm_scan(zx, ix, fx, ox, r_z, r_i, r_f, r_o)
                    * w).sum()
        dims = (0,) * 4 + ((0,) * 4 if case == "slstm r mapped"
                           else (None,) * 4)
        names = ("slstm_scan_fwd", "slstm_scan_bwd")
    for name in names:
        monkeypatch.setattr(kx, name, _spy(calls, getattr(kx, name)))
    g_all = grad(f, argnums=tuple(range(len(args))))
    got = vmap(g_all, in_dims=dims)(*args)
    assert calls == list(names)
    monkeypatch.undo()
    for k in range(K):
        want = g_all(*(a[k] if d == 0 else a for a, d in zip(args, dims)))
        for a, b in zip(got, want):
            assert torch.equal(a[k], b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_scan_functions_keep_states_only_under_grad(kind, monkeypatch):
    """The forward keeps its states where a backward can follow (grad mode
    on and an input that requires grad); the values are the same either
    way; a second derivative raises."""
    if kind == "mlstm":
        args = _t(_mlstm_inputs(8, 2, 20, 2, 8)[0])
        fwd, scan = "mlstm_scan_fwd", kx.mlstm_scan
    else:
        args = _t(_slstm_inputs(9, 2, 20, 2, 8)[0])
        fwd, scan = "slstm_scan_fwd", kx.slstm_scan
    kept, orig = [], getattr(kx, fwd)

    def spy(*a, with_states=False, **kw):
        kept.append(with_states)
        return orig(*a, with_states=with_states, **kw)

    monkeypatch.setattr(kx, fwd, spy)
    h0 = scan(*args)
    leaf = args[-1].clone().requires_grad_(True)
    with torch.no_grad():
        scan(*args[:-1], leaf)
    h1 = scan(*args[:-1], leaf)
    assert kept == [False, False, True]
    assert torch.equal(h0, h1.detach())
    (g,) = torch.autograd.grad(h1.sum(), leaf, create_graph=True)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(g.sum(), leaf)


# ---------------------------------------------------------------------------
# The mixers
# ---------------------------------------------------------------------------

def _cfgs():
    return (jconfigs.get_arch(ARCH).reduced(**SMALL),
            configs.get_arch(ARCH).reduced(**SMALL))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_grad_matches_reference(kind):
    """d/d(x and every weight) of sum(w * mixer) at S=128 (the reference's
    chunked branch) against ``jax.grad`` of the reference's mixer, with
    random gate biases and the sLSTM's recurrent matrices at 0.3: each
    leaf within 1e-5 x its max |g| (|g| reaches ~14 here), the bar of
    the Mamba mixer's gradient (tests/test_torch_ssm_train.py)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(11)
    jspecs = {"mlstm": jxlstm.mlstm_specs, "slstm": jxlstm.slstm_specs}
    p = jparam.init_params(jspecs[kind](jcfg), jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(np.asarray, p)
    bias = "b_if" if kind == "mlstm" else "b_x"
    p[bias] = _normal(rng, *p[bias].shape)
    if kind == "slstm":
        for key in ("r_z", "r_i", "r_f", "r_o"):
            p[key] = _normal(rng, *p[key].shape, scale=0.3)
    x = _normal(rng, 2, 128, jcfg.d_model)
    w = _normal(rng, 2, 128, jcfg.d_model)
    jmix = {"mlstm": jxlstm.mlstm_mixer, "slstm": jxlstm.slstm_mixer}[kind]
    tmix = {"mlstm": xlstm.mlstm_mixer, "slstm": xlstm.slstm_mixer}[kind]
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jmix(p, x, jcfg) * w),
                          argnums=(0, 1)))(p, x)
    tp = param.params_from_numpy(p, device="cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = (tmix(leaves, tx, tcfg) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(out, [tx] + list(leaves.values()))
    _rel_close(grads[0].numpy(), jg[1], "x")
    for (k, _), g in zip(leaves.items(), grads[1:]):
        _rel_close(g.numpy(), jg[0][k], k)


# ---------------------------------------------------------------------------
# The loss, the train steps, the trainer and pods
# ---------------------------------------------------------------------------

_CACHE = {}


def _model():
    """(reference cfg, port cfg, reference params, port params)."""
    if "model" not in _CACHE:
        jcfg, tcfg = _cfgs()
        jp = jparam.init_params(jtf.model_specs(jcfg), jax.random.PRNGKey(0))
        tp = param.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")
        _CACHE["model"] = (jcfg, tcfg, jp, tp)
    return _CACHE["model"]


def _batch(seed, shape, vocab=128):
    """numpy tokens and labels of ``shape``; the first 3 labels of the
    first row of every client are -1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., 0, :3] = -1
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": labels}


def _tt(tree):
    return pt.tmap(torch.from_numpy, tree)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grad_match_reference(remat):
    """``loss_fn`` and its gradient (plain autograd through the remat
    policy's checkpoints, the scans' Functions inside) against
    ``jax.value_and_grad`` of the reference's, (2, 16) with -1 labels."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(1, (2, 16))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, b, jcfg, remat=remat)))(jp)
    tl, tg = steps.value_and_grad(
        lambda p: transformer.loss_fn(p, _tt(b), tcfg, remat=remat), tp)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    _close(tg, jg)


def test_loss_vmap_grad_matches_reference():
    """``loss_fn`` (remat none, the trainer's) under ``vmap(grad)`` over 3
    clients' (2, 16) batches against ``jax.vmap(jax.grad(...))`` of the
    reference's: each scan launches once for the three clients."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(3, (3, 2, 16))
    want = jax.jit(jax.vmap(jax.grad(
        lambda p, b: jtf.loss_fn(p, b, jcfg, remat="none")),
        in_axes=(None, 0)))(jp, b)
    got = vmap(grad(lambda p, b: transformer.loss_fn(p, b, tcfg,
                                                     remat="none")),
               in_dims=(None, 0))(tp, _tt(b))
    _close(got, want)


def _step_state(jp, algo):
    g0 = jax.tree_util.tree_map(lambda x: 0.01 * jnp.ones_like(x), jp)
    return {"params": jp} if algo == "fedavg" else \
        {"params": jp, "anchor": jp, "g_t": g0}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("algo", sorted(jsteps.STEP_BUILDERS))
def test_round_steps_match_reference(algo, remat):
    """Each step builder over 3 steps on one (2, 16) batch (g_t starts at
    0.01 everywhere) against the reference's jitted step: the new state
    and the loss."""
    jcfg, tcfg, jp, _ = _model()
    kw = dict(eta=0.05, remat=remat)
    if algo != "fedavg":
        kw["mu"] = 0.1
    b = _batch(4, (2, 16))
    jstep = jax.jit(jsteps.STEP_BUILDERS[algo](jcfg, **kw))
    tstep = steps.STEP_BUILDERS[algo](tcfg, **kw)
    js = _step_state(jp, algo)
    ts = param.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for _ in range(3):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _tt(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=ATOL, rtol=0)
    assert sorted(ts) == sorted(js)
    _close(ts, js)


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
def test_lm_trainer_matches_reference(algo, engine):
    """2 rounds of ``launch/train.py``'s loss through ``FederatedTrainer``
    (4 devices of 8 samples, S=16, B=2, K=2) against the reference's
    python driver: the same selections, params and global losses within
    1e-5 (and the params moved by more)."""
    jcfg, tcfg, jp, tp = _model()
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
    got, tdrawn, tlosses = _rounds(ttr, tp)
    assert tdrawn == jdrawn
    _close(got.params, want.params)
    assert max(float((a - b).abs().max()) for a, b in zip(
        pt.leaves(got.params), pt.leaves(tp))) > 10 * ATOL
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL, rtol=0)


def test_lm_flat_bitwise_equals_per_leaf():
    """The batched solver over 2 devices' LM batches (one step masked):
    flat (K1's plain version) and per_leaf (K4's) bit for bit."""
    _, tcfg, _, w0 = _model()
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
    assert all(torch.equal(a, b) for a, b in zip(
        pt.leaves(out["flat"].params), pt.leaves(out["per_leaf"].params)))
    assert not torch.equal(pt.leaves(out["flat"].params)[1][0],
                           pt.leaves(w0)[1])


def test_podfed_one_pod_matches_reference():
    """One pod, 2 local steps (2, 16) a step, against the reference's
    round on its 1x1x1 mesh: the new state and the loss."""
    jcfg, tcfg, jp, _ = _model()
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
    tnew, tm = tfn(param.params_from_numpy(state, device="cpu"), _tt(batch))
    assert info["mesh_devices"] == 1
    _close(tnew, jnew, POD_ATOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=POD_ATOL, rtol=0)
