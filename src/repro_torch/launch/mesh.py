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
  ``torch.multiprocessing``.  This is the production path.  A caller
  may give ``ProcessMesh`` its own collectives (``comm=``), as processes
  sharing one card do.
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

Under autograd the collectives are Megatron's conjugate pairs, the
transposes of the reference's ``shard_map`` collectives.  The loss is
replicated over "model" and each rank differentiates it on its own part,
so the all-reduce of a row-parallel output passes its gradient unchanged,
and ``fan_out`` (the identity in front of a computation each rank does a
part of) sums its gradient over "model"; an all-gather's gradient is the
rank's slice, an all-to-all's the all-to-all back.  Over "data" the loss
is the sum of the ranks' losses: a sum over "data" also passes its
gradient unchanged (each rank's loss holds a global term, the MoE aux,
once), and an all-gather over "data" (FSDP's weights) reduce-scatters its
gradient.

Thread ranks cannot run a backward that holds a collective on a card:
autograd runs every node of every thread's backward on one worker thread
per device, so a rank waiting there for another blocks the thread that
would run the other's node.  On a CUDA tensor a thread rank's collective
inside a backward raises at once (``THREAD_BACKWARD``); several ranks on
one card train at tp > 1 as processes sharing it instead (NCCL refuses
two ranks on one card).  Data-parallel training
(tp = 1) puts no collective inside the backward unless its weights are
FSDP shards, so thread ranks run it on a card.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from repro_torch.analysis import cost as _cost

_ITEM_12 = ("ROADMAP Queue 1 item 12, its last part (the 256/512-device "
            "production mesh)")
THREAD_BACKWARD = ("thread ranks cannot run a collective inside a backward on "
                   "a CUDA device (autograd runs every thread's device nodes "
                   "on one worker thread): run the ranks as processes "
                   "(make_process_mesh over gloo, several on one card)")


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


def _in_backward() -> bool:
    """Whether this thread is running an autograd backward (a node, or a
    checkpointed region's recompute)."""
    return torch._C._current_graph_task_id() != -1


class _ThreadComm:
    """The collectives of thread ranks.  Each rank combines the group's
    tensors itself, in rank order, so every rank of a group computes the
    same result from the same inputs."""

    def __init__(self, dp: int, tp: int):
        self.dp, self.tp = dp, tp
        self.groups: dict = {}
        self._lock = threading.Lock()

    def _group(self, ranks: tuple, x) -> _ThreadGroup:
        if x.is_cuda and _in_backward():
            raise RuntimeError(THREAD_BACKWARD)
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
        return self._group(ranks, x).exchange(pos, ("all_reduce", op), x,
                                              combine)

    def all_gather(self, x, ranks, pos, dim):
        return self._group(ranks, x).exchange(
            pos, ("all_gather", dim), x, lambda xs: torch.cat(xs, dim))

    def all_to_all(self, x, ranks, pos):
        return self._group(ranks, x).exchange(
            pos, ("all_to_all",), x,
            lambda xs: torch.stack([t[pos] for t in xs]))

    def reduce_scatter(self, x, ranks, pos, dim):
        def combine(xs):
            n = xs[0].shape[dim] // len(xs)
            parts = [t.narrow(dim, pos * n, n) for t in xs]
            out = parts[0].clone()
            for t in parts[1:]:
                out = out + t
            return out
        return self._group(ranks, x).exchange(
            pos, ("reduce_scatter", dim), x, combine)


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------
class _ProcessComm:
    """The collectives of one process per rank, over ``torch.distributed``
    groups made for every "data" and "model" group of the mesh (every
    process makes every group, in one order, as ``new_group`` asks)."""

    def __init__(self, dp: int, tp: int, procs: tuple):
        import torch.distributed as dist
        self.dist = dist
        self.groups = {}
        for axis in ("model", "data"):
            seen = set()
            for r in range(dp * tp):
                ranks = _group_ranks(dp, tp, r, axis)
                if ranks not in seen:
                    seen.add(ranks)
                    self.groups[ranks] = dist.new_group(
                        [procs[q] for q in ranks])
        self.groups[tuple(range(dp * tp))] = dist.group.WORLD \
            if len(procs) == dist.get_world_size() \
            else dist.new_group(list(procs))

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

    def reduce_scatter(self, x, ranks, pos, dim):
        n = len(ranks)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
        self.dist.reduce_scatter_tensor(out, xt, group=self.groups[ranks])
        return out.movedim(0, dim).contiguous()   # as thread ranks give it


# ---------------------------------------------------------------------------
# the collectives under autograd
# ---------------------------------------------------------------------------
def _recording(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumReduce(torch.autograd.Function):
    """The all-reduce (sum) of a partial result: its gradient passes
    unchanged (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mcx, axis):
        ctx.mcx, ctx.axis = mcx, axis
        return mcx._collective("all_reduce", x, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    """The identity in front of a computation each rank of ``axis`` does a
    part of: its gradient is summed over ``axis`` (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mcx, axis):
        ctx.mcx, ctx.axis = mcx, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mcx._collective("all_reduce", g, ctx.axis, "sum"), \
            None, None


class _Gather(torch.autograd.Function):
    """The all-gather along ``dim``: the gradient is reduce-scattered over
    the "data" part of ``axis`` and the rank keeps its slice."""

    @staticmethod
    def forward(ctx, x, mcx, dim, axis):
        ctx.mcx, ctx.dim, ctx.axis, ctx.n = mcx, dim, axis, x.shape[dim]
        return mcx._collective("all_gather", x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mcx, axes = ctx.mcx, ctx.axis
        axes = axes if isinstance(axes, tuple) else (axes,)
        if "data" in axes:       # the rank's data block (ranks data major)
            g = mcx.reduce_scatter(g, ctx.dim, "data")
        i = mcx.model_index if "model" in axes else 0
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


class _AllToAll(torch.autograd.Function):
    """The all-to-all over axis 0: its gradient goes back by the same
    all-to-all."""

    @staticmethod
    def forward(ctx, x, mcx, axis):
        ctx.mcx, ctx.axis = mcx, axis
        return mcx._collective("all_to_all", x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mcx._collective("all_to_all", g.contiguous(),
                                   ctx.axis), None, None


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
    def _collective(self, kind: str, x, axis, *args):
        """``kind`` over the ranks of ``axis``, reported to the cost walk;
        no autograd (the ``Function``s above call it)."""
        ranks = _group_ranks(self.dp_size, self.tp_size, self.rank, axis)
        n = len(ranks)
        size = x.numel() * x.element_size()
        _cost.collective({"all_reduce": "all-reduce",
                          "all_gather": "all-gather",
                          "all_to_all": "all-to-all",
                          "reduce_scatter": "reduce-scatter"}[kind],
                         n * size if kind == "all_gather" else size)
        return getattr(self.comm, kind)(x, ranks, ranks.index(self.rank),
                                        *args)

    def all_reduce(self, x, axis="model", op: str = "sum"):
        """The sum (or ``op="max"``) of ``x`` over the ranks of ``axis``.
        Under autograd a sum passes its gradient unchanged; a max carries
        none."""
        if self.axis_size(axis) == 1:
            return x
        if op == "sum" and _recording(x):
            return _SumReduce.apply(x, self, axis)
        return self._collective("all_reduce", x.detach(), axis, op)

    def fan_out(self, x, axis="model"):
        """``x``, the same on every rank of ``axis``, as it enters a
        computation each rank does a part of: the identity, whose gradient
        is summed over ``axis``."""
        if self.axis_size(axis) == 1 or not _recording(x):
            return x
        return _FanOut.apply(x, self, axis)

    def all_gather(self, x, dim: int, axis="model"):
        """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in rank
        order."""
        if self.axis_size(axis) == 1:
            return x
        dim = dim % x.dim()
        if _recording(x):
            return _Gather.apply(x, self, dim, axis)
        return self._collective("all_gather", x, axis, dim)

    def all_to_all(self, x, axis="model"):
        """x (n, ...), n the size of ``axis``: row j goes to the group's
        rank j, and row i of the result came from rank i (the reference's
        tiled ``all_to_all`` with split and concat axis 0)."""
        n = self.axis_size(axis)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all of {tuple(x.shape)} over "
                             f"{n} ranks")
        if n == 1:
            return x
        if _recording(x):
            return _AllToAll.apply(x, self, axis)
        return self._collective("all_to_all", x, axis)

    def reduce_scatter(self, x, dim: int, axis="data"):
        """The sum of ``x`` over the ranks of ``axis``, of which the rank
        keeps its slice along ``dim`` (no autograd)."""
        if self.axis_size(axis) == 1:
            return x
        return self._collective("reduce_scatter", x.detach(), axis,
                                dim % x.dim())


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
    (``torch.distributed.init_process_group``, made by the caller), or of
    the processes ``procs`` of it (mesh rank i is process ``procs[i]``);
    the groups of both axes are made here, by every process of the group
    (``new_group``'s rule), and ``rank`` is None on a process outside the
    mesh.  ``comm`` makes the collectives from ``(dp, tp, procs)``; by
    default they are ``torch.distributed``'s over the groups' backend."""

    def __init__(self, dp: int, tp: int, procs=None, comm=None):
        import torch.distributed as dist
        procs = tuple(range(dist.get_world_size()) if procs is None
                      else procs)
        if dp * tp != len(procs):
            raise ValueError(f"a {dp} x {tp} mesh over {len(procs)} "
                             f"processes")
        self.shape = (dp, tp)
        me = dist.get_rank()
        self.rank = procs.index(me) if me in procs else None
        self.comm = (comm or _ProcessComm)(dp, tp, procs)

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
