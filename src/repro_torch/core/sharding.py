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
its own rows.

:func:`run_on_mesh` starts the ranks.  Rank ``r`` takes ``cuda:r`` when
there are at least D cards, over NCCL; more ranks than cards need
``backend="gloo"`` (NCCL refuses two ranks on one card); ``device="cpu"``
runs gloo on the CPU.  Nothing switches backend or device on its own.

``FederatedConfig.mesh_devices`` counts the LEAF ranks: ``1`` is no
mesh (every path keeps its single-process program), an int > 1 must
equal the process group's world size, ``"auto"`` is the world size.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

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


def tree_psum(x: torch.Tensor, mesh: Optional[ClientMesh]) -> torch.Tensor:
    """Sum of ``x`` over every rank, through the aggregation tree (leaf
    ranks within their edge, then edge partials); ``x`` itself is left
    untouched.  Without a mesh, ``x``."""
    if mesh is None:
        return x
    out = x.clone()
    for group, _ in _levels(mesh):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def tree_pmean(x: torch.Tensor, mesh: Optional[ClientMesh]) -> torch.Tensor:
    """Mean of ``x`` over every rank: at each level of the tree the sum
    divided by that level's group size (mean of edge means).  Exact to
    float association, every rank holding the same client count."""
    if mesh is None:
        return x
    out = x.clone()
    for group, size in _levels(mesh):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        out = out / size
    return out


def gather_rows(x: torch.Tensor, mesh: Optional[ClientMesh]) -> torch.Tensor:
    """Every rank's ``(K/D, ...)`` rows as the whole ``(K, ...)`` stack,
    on every rank: an all-reduce of a zero-padded stack in which each
    rank fills its own rows (adding zeros changes no value)."""
    if mesh is None:
        return x
    kl = x.shape[0]
    full = x.new_zeros((kl * mesh.world,) + tuple(x.shape[1:]))
    full[mesh.rank * kl:(mesh.rank + 1) * kl] = x
    dist.all_reduce(full, op=dist.ReduceOp.SUM)
    return full


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
