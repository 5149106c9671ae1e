"""The client mesh: D ranks of ``torch.distributed``, one process each.

Counterpart of ``repro/core/sharding.py``.  The reference shards the K
stacked clients of a round over a JAX mesh and runs the round body
under ``shard_map``; here the mesh is D processes in one process group,
and each rank runs the same round on its own rows:

- rank ``r`` owns rows ``[r*K/D, (r+1)*K/D)`` of every K-stacked round
  tensor -- the reference's ``stacked_spec`` layout over
  ``(edge, device)``, so ``r = e*(D/E) + d``;
- every rank does the same host work (sampling, scenario, codec draws,
  eval) from the same seed, so replicated state stays bit-identical;
- every cross-client reduction is an ``all_reduce(SUM)``.  With
  ``edge_shards=E > 1`` it runs through the aggregation tree: first
  within the rank's edge (the E groups of D/E leaves, the ``device``
  axis), then across edges (the D/E groups of E ranks, the ``edge``
  axis).  :func:`tree_pmean` divides by the group size at each level,
  as ``jax.lax.pmean`` does.

Only ``all_reduce`` is used: gloo runs it on CUDA tensors as well as on
CPU tensors, and NCCL runs it too.  :func:`gather_rows` is an
all-reduce of a zero-padded ``(K, ...)`` stack in which each rank fills
its own rows; :func:`gather_selected` and :func:`scatter_selected` move
a cohort's rows out of and back into ``(N, ...)`` stacks whose rows are
spread over the ranks, with one all-reduce each.

A captured round contains collectives: :class:`SegmentedGraph` captures
it on the card as CUDA-graph segments split at them (gloo's all-reduce
of a CUDA tensor passes through the host, so no graph can hold it) and
replays segments and all-reduces in capture order.

:func:`run_on_mesh` starts the ranks.  Rank ``r`` takes ``cuda:r`` when
there are at least D cards, over NCCL; more ranks than cards need
``backend="gloo"`` (NCCL refuses two ranks on one card); ``device="cpu"``
runs gloo on the CPU.  Nothing switches backend or device on its own.

``FederatedConfig.mesh_devices`` counts the LEAF ranks: ``1`` is no
mesh (every path keeps its single-process program), an int > 1 must
equal the process group's world size, ``"auto"`` is the world size.
"""
from __future__ import annotations

import gc
import os
import pickle
import shutil
import tempfile
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import pytree as pt

#: How long a rank waits in a collective (or for the others to join)
#: before it fails, and with it the whole mesh.
TIMEOUT = timedelta(seconds=900)

_LAUNCH_HINT = ("start the ranks with repro_torch.core.sharding."
                "run_on_mesh(fn, mesh_devices, edge_shards, ...) and pass "
                "the ClientMesh it hands each rank to the trainer")


@dataclass(frozen=True)
class ClientMesh:
    """One rank's view of the client mesh.

    ``world`` leaf ranks grouped under ``edge_shards`` edges of
    ``world // edge_shards`` leaves; ``rank`` is this process's linear
    index (``edge * leaves + leaf``) and ``device`` where its tensors
    live.  ``leaf_groups[e]`` holds the ranks of edge ``e`` and
    ``edge_groups[d]`` the leaf ``d`` of every edge; with one edge both
    lists are empty and reductions run over the whole world.
    """

    world: int
    edge_shards: int
    rank: int
    device: torch.device
    leaf_groups: Tuple[Any, ...] = ()
    edge_groups: Tuple[Any, ...] = ()
    #: the :class:`SegmentedGraph` capturing on this rank, if any (one
    #: slot): the collective helpers record into it instead of running
    capturing: List[Any] = field(default_factory=list, compare=False,
                                 repr=False)

    @property
    def leaves(self) -> int:
        return self.world // self.edge_shards

    @property
    def edge(self) -> int:
        return self.rank // self.leaves

    @property
    def leaf(self) -> int:
        return self.rank % self.leaves


def resolve_mesh_devices(mesh_devices) -> int:
    """A ``FederatedConfig.mesh_devices`` value as a rank count.

    ``"auto"`` is the process group's world size (1 without a group);
    ``1`` is no mesh; an int > 1 must equal the world size of an
    initialized group.
    """
    world = (dist.get_world_size() if dist.is_available()
             and dist.is_initialized() else None)
    if mesh_devices == "auto":
        return world or 1
    if isinstance(mesh_devices, bool) or not isinstance(mesh_devices, int):
        raise ValueError(
            f"mesh_devices must be a positive int or 'auto', got "
            f"{mesh_devices!r}")
    if mesh_devices < 1:
        raise ValueError(f"mesh_devices must be >= 1, got {mesh_devices}")
    if mesh_devices == 1:
        return 1
    if world is None:
        raise ValueError(
            f"mesh_devices={mesh_devices} needs a torch.distributed "
            f"process group of {mesh_devices} ranks and none is "
            f"initialized; {_LAUNCH_HINT}")
    if mesh_devices != world:
        raise ValueError(
            f"mesh_devices={mesh_devices} must equal the process group's "
            f"world size {world}")
    return mesh_devices


def mesh_for(cfg, mesh: Optional[ClientMesh] = None) -> Optional[ClientMesh]:
    """The mesh a ``FederatedConfig`` asks for, or ``None``.

    ``cfg.mesh_devices`` resolving to 1 gives ``None`` (the
    single-process programs, untouched); ``cfg.edge_shards > 1`` or a
    ``mesh`` then raise, as the config does not ask for the mesh.
    Otherwise ``mesh`` -- the rank's :class:`ClientMesh` from
    :func:`run_on_mesh` -- must be given and match the config.
    """
    n = resolve_mesh_devices(getattr(cfg, "mesh_devices", 1))
    edge = getattr(cfg, "edge_shards", 1)
    if n == 1:
        if edge > 1:
            raise ValueError(
                f"edge_shards={edge} needs a real client mesh; "
                f"mesh_devices resolved to 1 (set mesh_devices>1 or "
                f"'auto' inside a process group; {_LAUNCH_HINT})")
        if mesh is not None:
            raise ValueError(
                f"a ClientMesh of {mesh.world} ranks was given but "
                f"mesh_devices resolves to 1; set mesh_devices="
                f"{mesh.world} or 'auto' to run the client mesh")
        return None
    if mesh is None:
        raise ValueError(f"mesh_devices={n} needs this rank's ClientMesh; "
                         f"{_LAUNCH_HINT}")
    if n % edge != 0:
        raise ValueError(
            f"edge_shards={edge} must divide the resolved mesh_devices={n} "
            f"(each edge aggregates an equal leaf group)")
    if (mesh.world, mesh.edge_shards) != (n, edge):
        raise ValueError(
            f"the config asks for mesh_devices={n}, edge_shards={edge}; "
            f"the ranks were started as {mesh.world} ranks under "
            f"{mesh.edge_shards} edge(s)")
    return mesh


def num_shards(mesh: Optional[ClientMesh]) -> int:
    """Leaf shards of the client axis; 1 without a mesh."""
    return 1 if mesh is None else mesh.world


def shard_rows(k: int, mesh: Optional[ClientMesh]) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of a K-stacked tensor this rank owns."""
    kl = k // num_shards(mesh)
    lo = (0 if mesh is None else mesh.rank) * kl
    return lo, lo + kl


def check_divisible(k: int, mesh: Optional[ClientMesh], what: str) -> None:
    """Raise unless a stacked axis of size ``k`` shards evenly: every
    rank (leaf of the aggregation tree) holds the same client count."""
    d = num_shards(mesh)
    if k % d != 0:
        raise ValueError(
            f"{what}={k} is not divisible by mesh_devices={d}; the "
            f"sharded round gives each rank k/D clients -- pick a "
            f"selection size (or mesh size) with k % D == 0")


def _levels(mesh: ClientMesh):
    """(group, size) of each reduction level, innermost first."""
    if mesh.edge_shards == 1:
        return ((None, mesh.world),)
    return ((mesh.leaf_groups[mesh.edge], mesh.leaves),
            (mesh.edge_groups[mesh.leaf], mesh.edge_shards))


def _world(mesh: ClientMesh):
    """The one level of a reduction over every rank at once."""
    return ((None, mesh.world),)


def _all_reduce(tensors: Sequence[torch.Tensor], mesh: ClientMesh,
                levels) -> None:
    """Sum each of ``tensors`` over the ranks in place, level by level
    (every tensor at a level, then the next level).  Inside a
    :class:`SegmentedGraph` capture the all-reduces are recorded as one
    step between two segments instead."""
    ops = tuple((t, group) for group, _ in levels for t in tensors)
    if mesh.capturing:
        mesh.capturing[0].record(ops)
        return
    _run(ops)


def _run(ops) -> None:
    for t, group in ops:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def tree_psum(x, mesh: Optional[ClientMesh]):
    """Sum of ``x`` (a tensor or a tree of them) over every rank, through
    the aggregation tree (leaf ranks within their edge, then edge
    partials), every leaf in one collective step; ``x`` itself is left
    untouched.  Without a mesh, ``x``."""
    if mesh is None:
        return x
    leaves, treedef = pt.flatten(x)
    out = [t.clone() for t in leaves]
    _all_reduce(out, mesh, _levels(mesh))
    return pt.unflatten(treedef, out)


def tree_pmean(x, mesh: Optional[ClientMesh]):
    """Mean of ``x`` (a tensor or a tree) over every rank: at each level
    of the tree the sum divided by that level's group size (mean of edge
    means).  Exact to float association, every rank holding the same
    client count."""
    if mesh is None:
        return x
    leaves, treedef = pt.flatten(x)
    out = [t.clone() for t in leaves]
    for level in _levels(mesh):
        _all_reduce(out, mesh, (level,))
        out = [t / level[1] for t in out]
    return pt.unflatten(treedef, out)


def gather_rows(x, mesh: Optional[ClientMesh]):
    """Every rank's ``(K/D, ...)`` rows as the whole ``(K, ...)`` stack,
    on every rank, for a tensor or every leaf of a tree at once: an
    all-reduce of a zero-padded stack in which each rank fills its own
    rows (adding zeros changes no value)."""
    if mesh is None:
        return x
    leaves, treedef = pt.flatten(x)
    full = []
    for t in leaves:
        kl = t.shape[0]
        f = t.new_zeros((kl * mesh.world,) + tuple(t.shape[1:]))
        f[mesh.rank * kl:(mesh.rank + 1) * kl] = t
        full.append(f)
    _all_reduce(full, mesh, _world(mesh))
    return pt.unflatten(treedef, full)


def _owned(sel: torch.Tensor, n: int, mesh: ClientMesh):
    """Which ids of ``sel`` this rank's ``n`` rows hold (rank r holds ids
    ``[r n, (r+1) n)``), and their local rows (clamped where not)."""
    lo = mesh.rank * n
    return (sel >= lo) & (sel < lo + n), (sel - lo).clamp(0, n - 1)


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def gather_selected(requests, mesh: ClientMesh) -> List[Any]:
    """This rank's K/D rows of ``x[sel]`` for every ``(stacks, sel)`` of
    ``requests`` and every leaf ``x`` of ``stacks``: ``(N/D, ...)``
    stacks whose rows are spread over the ranks (rank r holds ids
    ``[r N/D, (r+1) N/D)``), ``sel`` a cohort's K global ids, equal on
    every rank.  One exchange for all of them: each rank fills the rows
    it holds into zero ``(K, ...)`` stacks, one all-reduce step sums the
    stacks (adding zeros changes no value), and the rank keeps its rows
    of each cohort.  Returns one tree per request."""
    full, parts = [], []
    for stacks, sel in requests:
        leaves, treedef = pt.flatten(stacks)
        owned, idx = _owned(sel, leaves[0].shape[0], mesh)
        full += [torch.where(_bcast(owned, x), x.index_select(0, idx),
                             torch.zeros((), dtype=x.dtype,
                                         device=x.device))
                 for x in leaves]
        parts.append((treedef, len(leaves), shard_rows(sel.shape[0], mesh)))
    _all_reduce(full, mesh, _world(mesh))
    out, at = [], 0
    for treedef, count, (lo, hi) in parts:
        out.append(pt.unflatten(treedef,
                                [f[lo:hi] for f in full[at:at + count]]))
        at += count
    return out


def scatter_selected(stacks, sel: torch.Tensor, rows,
                     mesh: ClientMesh) -> None:
    """The inverse of :func:`gather_selected`, in place: ``rows`` (this
    rank's K/D rows of the cohort ``sel``) reach every rank
    (:func:`gather_rows`), and each rank writes the rows whose ids it
    holds into its leaves of ``stacks``.  An id selected twice keeps its
    last row, as ``index_copy_`` on the CPU keeps it."""
    full = pt.leaves(gather_rows(rows, mesh))
    leaves = pt.leaves(stacks)
    n = leaves[0].shape[0]
    owned, idx = _owned(sel, n, mesh)
    order = torch.arange(sel.shape[0], device=sel.device)
    pos = torch.full((n,), -1, dtype=order.dtype, device=sel.device)
    pos.scatter_reduce_(0, idx, torch.where(owned, order, -1), "amax")
    hit, src = pos >= 0, pos.clamp(min=0)
    for x, f in zip(leaves, full):
        x.copy_(torch.where(_bcast(hit, x), f.index_select(0, src), x))


class SegmentedGraph:
    """A program captured on the card as CUDA-graph segments split at its
    collectives.

    While :meth:`capture` is active, each collective helper of this
    module ends the open segment, records its all-reduces (in place, on
    the tensors it reduces, every level of the tree in turn) and begins
    the next segment in the same memory pool, so the static tensors of
    one segment stay valid in the next.  :meth:`replay` runs segments and
    recorded all-reduces in capture order on the current stream.  Without
    a mesh the program is one segment, one CUDA graph.  Nothing in a
    segment may read a tensor back to the host.
    """

    def __init__(self, mesh: Optional[ClientMesh], generators=()):
        self.mesh = mesh
        self._gens = tuple(generators)
        self._pool = torch.cuda.graph_pool_handle()
        self._steps: List[Any] = []       # CUDAGraph or all-reduce ops
        self._open = None

    @property
    def segments(self) -> int:
        """CUDA graphs in the program."""
        return sum(1 for s in self._steps if not isinstance(s, tuple))

    @property
    def collectives(self) -> int:
        """All-reduces a replay makes (every level and tensor)."""
        return sum(len(s) for s in self._steps if isinstance(s, tuple))

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self._gens:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self._pool)
        self._open = graph

    def _end(self) -> None:
        graph, self._open = self._open, None
        graph.capture_end()
        self._steps.append(graph)

    def record(self, ops) -> None:
        """End the open segment, keep ``ops`` ((tensor, group) pairs),
        begin the next segment."""
        self._end()
        self._steps.append(ops)
        self._begin()

    @contextmanager
    def capture(self, device):
        """Capture what runs inside the block, on a side stream of
        ``device``."""
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        slot = self.mesh.capturing if self.mesh is not None else []
        with torch.cuda.stream(stream):
            self._begin()
            slot.append(self)
            try:
                yield self
            finally:
                slot.remove(self)
                if self._open is not None:
                    self._end()
        torch.cuda.current_stream(device).wait_stream(stream)

    def replay_steps(self) -> Iterator[Tuple[str, int]]:
        """Replay step by step: after each step, its kind
        (``"segment"``, a CUDA graph, or ``"all_reduce"``, the
        all-reduces recorded between two segments) and the bytes it
        all-reduces (0 for a segment)."""
        for step in self._steps:
            if isinstance(step, tuple):
                _run(step)
                yield "all_reduce", sum(t.numel() * t.element_size()
                                        for t, _ in step)
            else:
                step.replay()
                yield "segment", 0

    def replay(self) -> None:
        for _ in self.replay_steps():
            pass


# -- the launcher ------------------------------------------------------------

def _placement(mesh_devices: int, device, backend: Optional[str]
               ) -> Tuple[List[str], str]:
    """Each rank's device and the backend; raises where the ranks cannot
    be placed as asked."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'gloo' or "
                         f"'nccl'")
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev is not None and dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs on CUDA devices; CPU ranks use "
                             "backend='gloo'")
        return ["cpu"] * mesh_devices, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "run_on_mesh places ranks on CUDA devices by default and none "
            "is available; pass device='cpu' to run gloo ranks on the CPU")
    cards = torch.cuda.device_count()
    if dev is not None and dev.index is not None:
        if mesh_devices > 1 and backend != "gloo":
            raise ValueError(
                f"{mesh_devices} ranks on the one device {dev}: NCCL "
                f"refuses two ranks on one device; pass backend='gloo'")
        return [str(dev)] * mesh_devices, backend or "nccl"
    if cards >= mesh_devices:
        return [f"cuda:{r}" for r in range(mesh_devices)], backend or "nccl"
    if backend != "gloo":
        raise ValueError(
            f"{mesh_devices} ranks but {cards} CUDA device(s): NCCL refuses "
            f"two ranks on one device; pass backend='gloo' to share the "
            f"cards, or start at most {cards} ranks")
    return [f"cuda:{r % cards}" for r in range(mesh_devices)], "gloo"


def _build_mesh(world: int, edge_shards: int, rank: int,
                device: str) -> ClientMesh:
    """The rank's :class:`ClientMesh`; every rank creates every subgroup
    in the same order, as ``torch.distributed.new_group`` requires."""
    leaf_groups: Tuple[Any, ...] = ()
    edge_groups: Tuple[Any, ...] = ()
    if edge_shards > 1:
        leaves = world // edge_shards
        leaf_groups = tuple(
            dist.new_group([e * leaves + d for d in range(leaves)])
            for e in range(edge_shards))
        edge_groups = tuple(
            dist.new_group([e * leaves + d for e in range(edge_shards)])
            for d in range(leaves))
    return ClientMesh(world=world, edge_shards=edge_shards, rank=rank,
                      device=torch.device(device), leaf_groups=leaf_groups,
                      edge_groups=edge_groups)


def _rank_main(rank: int, world: int, edge_shards: int, devices: List[str],
               backend: str, store_dir: str, fn: Callable,
               args: tuple) -> None:
    """Body of one spawned rank: join the group, build the mesh, run
    ``fn(mesh, *args)`` and write its pickled result (or, before raising,
    its traceback) to ``store_dir``."""
    try:
        torch.set_num_threads(1)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
            world_size=world, rank=rank, timeout=TIMEOUT)
        try:
            mesh = _build_mesh(world, edge_shards, rank, devices[rank])
            out = fn(mesh, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(os.path.join(store_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:                                  # noqa: B902
        with open(os.path.join(store_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_on_mesh(fn: Callable, mesh_devices: int, edge_shards: int = 1, *,
                args: Sequence = (), device=None,
                backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``mesh_devices`` spawned ranks and
    return the results in rank order.

    ``fn`` must be importable by name (the ranks are spawned, not
    forked) and its result picklable.  Placement: ``device="cpu"`` runs
    gloo ranks on the CPU; otherwise rank ``r`` takes ``cuda:r`` over
    NCCL when there are at least ``mesh_devices`` cards, an explicit
    ``device="cuda:i"`` puts every rank on that card, and more ranks
    than cards need ``backend="gloo"``.  The ranks meet through a
    ``file://`` store in a fresh temporary directory (under ``TMPDIR``),
    removed afterwards.  If any rank fails, the others are stopped and
    the failure is raised here with the traceback of every rank that
    wrote one; a rank that waits :data:`TIMEOUT` in a collective fails.
    """
    if isinstance(mesh_devices, bool) or not isinstance(mesh_devices, int) \
            or mesh_devices < 1:
        raise ValueError(f"mesh_devices must be a positive int, got "
                         f"{mesh_devices!r}")
    if not (isinstance(edge_shards, int) and edge_shards >= 1
            and mesh_devices % edge_shards == 0):
        raise ValueError(f"edge_shards={edge_shards} must divide "
                         f"mesh_devices={mesh_devices}")
    devices, backend = _placement(mesh_devices, device, backend)
    store_dir = tempfile.mkdtemp(prefix="mesh-")
    try:
        try:
            mp.start_processes(
                _rank_main, nprocs=mesh_devices, join=True,
                start_method="spawn",
                args=(mesh_devices, edge_shards, devices, backend,
                      store_dir, fn, tuple(args)))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errors = []
            for r in range(mesh_devices):
                path = os.path.join(store_dir, f"error-{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"mesh rank {r} failed:\n{f.read()}")
            raise RuntimeError("\n".join(errors) or f"mesh {e}") from e
        out = []
        for r in range(mesh_devices):
            with open(os.path.join(store_dir, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
