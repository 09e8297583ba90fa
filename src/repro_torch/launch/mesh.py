"""Meshes of ranks: the counterpart of ``repro.launch.mesh`` and of the
reference's ``MeshCtx`` (``repro/models/layers.py``).

A mesh is dp x tp ranks on the axes "data" and "model"; rank ``r`` sits at
(``r // tp``, ``r % tp``), the order in which ``jax.make_mesh`` lays its
devices out.  Where the reference writes one SPMD program that XLA
partitions, the port runs the model code once per rank, on that rank's
slice of the weights and activations, and the rank code calls the
collectives of its ``MeshCtx`` where the reference's ``shard_map`` bodies
call ``psum`` / ``pmax`` / ``all_gather`` / ``all_to_all``.

Two ways to run ranks stand behind the one interface, and the same rank
code runs on both; the caller picks one, and nothing switches from one to
the other:

* one process per card (``make_process_mesh``): ``torch.distributed``
  groups for "data" and "model" over the default process group, NCCL on
  the card and gloo on the CPU, started by ``torchrun`` or
  ``torch.multiprocessing``.  This is the production path.
* ranks as threads of one process on one device (``make_host_mesh``), the
  counterpart of the reference's virtual host devices
  (``--xla_force_host_platform_device_count``): at each collective the
  ranks of a group meet at a barrier and each combines the group's
  tensors, in rank order, on the device they live on.

Every collective over a group of more than one rank reports itself to
``analysis.cost.collective`` (result bytes; all-reduce counted twice), as
the reference's per-device HLO holds it.  Over a group of one rank a
collective returns its input and calls nothing, as XLA drops it: an NCCL
call on a world of one costs host time and moves nothing (a full-width
decode step makes 322 of them).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from repro_torch.analysis import cost as _cost

_ITEM_12 = ("ROADMAP Queue 1 item 12, its training half (several cards: "
            "the production mesh, ZeRO-1 / FSDP, training on a mesh)")


def _group_ranks(dp: int, tp: int, rank: int, axis) -> tuple:
    """The ranks of ``rank``'s group along ``axis`` ("data", "model" or
    both), in order."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    d, m = divmod(rank, tp)
    ds = range(dp) if "data" in axes else (d,)
    ms = range(tp) if "model" in axes else (m,)
    return tuple(di * tp + mi for di in ds for mi in ms)


# ---------------------------------------------------------------------------
# ranks as threads
# ---------------------------------------------------------------------------
WAIT_S = 900.0   # the longest a thread rank waits at a collective: past it
                 # the ranks did not meet (one returned early, or called
                 # another collective), and every rank of the group raises


class _ThreadGroup:
    """One group of thread ranks: a barrier and a slot per rank."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=WAIT_S)
        self.slots = [None] * n

    def exchange(self, pos: int, what, x, combine):
        self.slots[pos] = (what, x)
        self.barrier.wait()
        kinds = {w for w, _ in self.slots}
        if len(kinds) != 1:
            raise RuntimeError(f"ranks meet at different collectives: {kinds}")
        out = combine([t for _, t in self.slots])
        self.barrier.wait()        # every rank has read the slots
        return out


class _ThreadComm:
    """The collectives of thread ranks.  Each rank combines the group's
    tensors itself, in rank order, so every rank of a group computes the
    same result from the same inputs."""

    def __init__(self, dp: int, tp: int):
        self.dp, self.tp = dp, tp
        self.groups: dict = {}
        self._lock = threading.Lock()

    def _group(self, ranks: tuple) -> _ThreadGroup:
        with self._lock:
            if ranks not in self.groups:
                self.groups[ranks] = _ThreadGroup(len(ranks))
            return self.groups[ranks]

    def abort(self) -> None:
        with self._lock:
            for g in self.groups.values():
                g.barrier.abort()

    def all_reduce(self, x, ranks, pos, op):
        def combine(xs):
            out = xs[0].clone()
            for t in xs[1:]:
                out = out + t if op == "sum" else torch.maximum(out, t)
            return out
        return self._group(ranks).exchange(pos, ("all_reduce", op), x,
                                           combine)

    def all_gather(self, x, ranks, pos, dim):
        return self._group(ranks).exchange(
            pos, ("all_gather", dim), x, lambda xs: torch.cat(xs, dim))

    def all_to_all(self, x, ranks, pos):
        return self._group(ranks).exchange(
            pos, ("all_to_all",), x,
            lambda xs: torch.stack([t[pos] for t in xs]))


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------
class _ProcessComm:
    """The collectives of one process per rank, over ``torch.distributed``
    groups made for every "data" and "model" group of the mesh (every
    process makes every group, in one order, as ``new_group`` asks)."""

    def __init__(self, dp: int, tp: int):
        import torch.distributed as dist
        self.dist = dist
        self.groups = {}
        for axis in ("model", "data"):
            seen = set()
            for r in range(dp * tp):
                ranks = _group_ranks(dp, tp, r, axis)
                if ranks not in seen:
                    seen.add(ranks)
                    self.groups[ranks] = dist.new_group(list(ranks))
        self.groups[tuple(range(dp * tp))] = dist.group.WORLD

    def all_reduce(self, x, ranks, pos, op):
        out = x.clone()
        self.dist.all_reduce(out, op=(self.dist.ReduceOp.SUM if op == "sum"
                                      else self.dist.ReduceOp.MAX),
                             group=self.groups[ranks])
        return out

    def all_gather(self, x, ranks, pos, dim):
        n, x = len(ranks), x.contiguous()
        out = x.new_empty((n * x.shape[0],) + x.shape[1:])
        # ``all_gather_single`` where torch has it (``all_gather_into_tensor``
        # is its older, now deprecated name)
        gather = getattr(self.dist, "all_gather_single", None) or \
            self.dist.all_gather_into_tensor
        gather(out, x, group=self.groups[ranks])
        if dim == 0:
            return out
        parts = out.view((n,) + x.shape).unbind(0)
        return torch.cat(parts, dim)

    def all_to_all(self, x, ranks, pos):
        x = x.contiguous()
        out = torch.empty_like(x)
        self.dist.all_to_all_single(out, x, group=self.groups[ranks])
        return out


# ---------------------------------------------------------------------------
# the rank's view
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshCtx:
    """One rank of a dp x tp mesh: its coordinates, ``bspec``'s rule and
    the collectives on either axis.  ``batch_split`` says whether the
    activations the rank holds are its own rows of the batch (set by the
    model for each batch, ``for_batch``)."""

    dp_size: int
    tp_size: int
    data_index: int
    model_index: int
    comm: object
    batch_split: bool = True

    @property
    def rank(self) -> int:
        return self.data_index * self.tp_size + self.model_index

    @property
    def size(self) -> int:
        return self.dp_size * self.tp_size

    def axis_size(self, axis) -> int:
        axes = axis if isinstance(axis, tuple) else (axis,)
        return (self.dp_size if "data" in axes else 1) * \
            (self.tp_size if "model" in axes else 1)

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (for both axes, data major)."""
        pos = _group_ranks(self.dp_size, self.tp_size, self.rank, axis)
        return pos.index(self.rank)

    def bspec(self, n: int):
        """"data" where a batch-like dim of size ``n`` is split over the
        data axis, None where it is not (``n`` indivisible, e.g. one long
        sequence): the reference's rule."""
        return "data" if n % self.dp_size == 0 else None

    def for_batch(self, n: int) -> "MeshCtx":
        """This context for a batch of ``n`` rows."""
        return replace(self, batch_split=self.bspec(n) is not None)

    def batch_rows(self, n: int) -> slice:
        """The rows of a batch of ``n`` that this rank holds."""
        if self.bspec(n) is None:
            return slice(0, n)
        k = n // self.dp_size
        return slice(self.data_index * k, (self.data_index + 1) * k)

    # -- collectives ---------------------------------------------------------
    def all_reduce(self, x, axis="model", op: str = "sum"):
        """The sum (or ``op="max"``) of ``x`` over the ranks of ``axis``."""
        ranks = _group_ranks(self.dp_size, self.tp_size, self.rank, axis)
        if len(ranks) == 1:
            return x
        _cost.collective("all-reduce", x.numel() * x.element_size())
        return self.comm.all_reduce(x, ranks, ranks.index(self.rank), op)

    def all_gather(self, x, dim: int, axis="model"):
        """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in rank
        order."""
        ranks = _group_ranks(self.dp_size, self.tp_size, self.rank, axis)
        if len(ranks) == 1:
            return x
        _cost.collective("all-gather",
                         len(ranks) * x.numel() * x.element_size())
        return self.comm.all_gather(x, ranks, ranks.index(self.rank),
                                    dim % x.dim())

    def all_to_all(self, x, axis="model"):
        """x (n, ...), n the size of ``axis``: row j goes to the group's
        rank j, and row i of the result came from rank i (the reference's
        tiled ``all_to_all`` with split and concat axis 0)."""
        ranks = _group_ranks(self.dp_size, self.tp_size, self.rank, axis)
        if x.shape[0] != len(ranks):
            raise ValueError(f"all_to_all of {tuple(x.shape)} over "
                             f"{len(ranks)} ranks")
        if len(ranks) == 1:
            return x
        _cost.collective("all-to-all", x.numel() * x.element_size())
        return self.comm.all_to_all(x, ranks, ranks.index(self.rank))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
class HostMesh:
    """dp x tp ranks as threads of this process on one device (the
    counterpart of ``make_host_mesh`` over virtual host devices).
    ``run(fn, *args)`` calls ``fn(ctx, *args)`` on a thread per rank and
    returns the results in rank order; if one rank raises, the others are
    released from their barriers and the first error is raised, and ranks
    that wait ``WAIT_S`` at a collective raise."""

    def __init__(self, dp: int = 1, tp: int = 1):
        self.shape = (dp, tp)
        self.comm = _ThreadComm(dp, tp)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def run(self, fn: Callable, *args) -> list:
        dp, tp = self.shape
        self.comm = comm = _ThreadComm(dp, tp)
        out, errors = [None] * self.size, []

        def rank_main(r):
            try:
                out[r] = fn(make_mesh_ctx(self, r), *args)
            except BaseException as e:       # noqa: BLE001 - re-raised below
                errors.append(e)
                comm.abort()

        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        if first:
            raise first[0]
        if errors:
            raise RuntimeError(f"thread ranks did not meet at a collective "
                               f"within {WAIT_S:.0f} s") from errors[0]
        return out


class ProcessMesh:
    """dp x tp ranks, one per process of the default process group
    (``torch.distributed.init_process_group``, made by the caller); the
    groups of both axes are made here, by every process."""

    def __init__(self, dp: int, tp: int):
        import torch.distributed as dist
        if dp * tp != dist.get_world_size():
            raise ValueError(f"a {dp} x {tp} mesh over "
                             f"{dist.get_world_size()} processes")
        self.shape = (dp, tp)
        self.rank = dist.get_rank()
        self.comm = _ProcessComm(dp, tp)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_host_mesh(dp: int = 1, tp: int = 1) -> HostMesh:
    """A small mesh of thread ranks (tests, and several ranks on one
    card)."""
    return HostMesh(dp, tp)


def make_data_mesh(ndev: Optional[int] = None) -> HostMesh:
    """A pure data-parallel mesh of ``ndev`` thread ranks (default: one
    per card, at least one)."""
    n = ndev if ndev is not None else max(torch.cuda.device_count(), 1)
    return HostMesh(n, 1)


def make_process_mesh(dp: Optional[int] = None,
                      tp: Optional[int] = None) -> ProcessMesh:
    """The mesh of the default process group: by default every process a
    tensor-parallel rank (dp = 1, tp = world size), as the reference's
    serving launcher lays its devices out."""
    import torch.distributed as dist
    world = dist.get_world_size()
    dp = dp or (1 if tp is None else world // tp)
    tp = tp or world // dp
    return ProcessMesh(dp, tp)


def make_mesh_ctx(mesh, rank: Optional[int] = None) -> MeshCtx:
    """Rank ``rank``'s context on ``mesh`` (a ``ProcessMesh``'s own rank
    by default)."""
    if rank is None:
        rank = mesh.rank
    dp, tp = mesh.shape
    return MeshCtx(dp_size=dp, tp_size=tp, data_index=rank // tp,
                   model_index=rank % tp, comm=mesh.comm)


def axis_size(mesh, axis) -> int:
    """The rank count along one axis name or a tuple of them."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    dp, tp = (mesh.dp_size, mesh.tp_size) if isinstance(mesh, MeshCtx) \
        else mesh.shape
    return (dp if "data" in axes else 1) * (tp if "model" in axes else 1)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (or 2 x 16 x 16) TPU mesh; only
    ``--simulate-pod`` and the dry run use it."""
    raise NotImplementedError(f"the production mesh is {_ITEM_12}")


def init_process_group(backend: Optional[str] = None,
                       device: Optional[torch.device] = None) -> None:
    """The default process group from ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): NCCL for
    a card, gloo for the CPU.  On a card, each process takes the card of
    its ``LOCAL_RANK``."""
    import os

    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if device is None or device.type == "cuda" \
            else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend)
