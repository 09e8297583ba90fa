"""Cost walk of a torch program (the counterpart of
``repro.analysis.hlo_analysis``).

The port emits no HLO, so nothing is parsed: the program is counted as it
runs, op by op, by a ``TorchDispatchMode``, and returns the record that
``analyze_text`` returns, ``{"flops", "bytes", "coll", "coll_bytes",
"coll_count"}``, plus ``dot_flops``, ``sorts``, ``kernels`` and, where
asked for, ``memory``.

Conventions (the reference's):

* FLOPs are exact for matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``einsum`` through them, any convolution): 2 x result
  elements x contracted size, from ``torch.utils.flop_counter``'s shape
  formulas.  ``dot_flops`` holds these alone.  Every other computing op
  counts one FLOP per output element; ops that only move data (copies,
  concatenations, fills) count none.
* Bytes are operands plus results of every materializing op; an operand
  that the op updates in place is counted once.  A tensor counts the
  elements it reaches (a view its own, an expanded one its distinct
  ones).  Views, reshapes, ``empty``, ``arange`` and other free ops count
  nothing (the reference's ``_FREE_OPS``).
* Collectives are counted by kind, all-reduce weighted 2x (ring =
  reduce-scatter + all-gather), by whoever performs them
  (``collective``): the sharded executor's lockstep reports each
  exchange site once, at one shard's bytes, as the reference's per-device
  program holds it.

Trip counts: a host loop is counted by running it.  A captured CUDA graph
holds the count of its capture (``kernels.ops.uncounted``) and adds it
once per replay, as the launch counts do (``kernels.ops.add_launches``);
the device loop adds its iteration's count times its iterations.  A graph
captured while no recorder was active has no count: its replays under a
recorder are tallied in ``unrecorded``.

The hand kernels count the work their algorithm defines, not their
implementation: each wrapper reports its formula (``sort_call_cost``,
``unique_mask_cost``, ``probe_cost``) and suspends op counting while it
runs, so that one call counts the same on the card as on the CPU, where
the wrapper runs the kernel's plain version.  One count rests on data: a
probe's haystack sectors.  Inside a CUDA graph capture there are no keys
to read yet, so a captured probe counts its upper bound, as under fake
tensors; a count of a run whose rounds are captured (the fused executor
on the card) holds the probe's bound where the CPU's holds its sectors.

A dry mode (``dry``) runs the program under ``FakeTensorMode``: tensors
carry shapes and dtypes and no memory, so a step of a 671B model can be
counted on the CPU.

Memory (``Recorder(memory=True)``): ``temp`` is the peak of the bytes of
storages that ops made while the recorder ran (added when made, taken off
when freed), less those of the outputs; ``arguments`` / ``outputs`` /
``alias`` are filled in by ``walk``.

When no recorder is active nothing here runs: the kernel wrappers test one
global (``ACTIVE``) and go on.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

# the innermost active Recorder, or None; the kernel wrappers test this
ACTIVE = None

_STACK: list = []            # active recorders, innermost last
# live bytes of tracked storages, and the thread whose kernel wrappers
# report (the ops of autograd's threads reach the dispatch mode, which
# follows its caller; another thread's never do)
_STATE = {"live": 0, "thread": None}
# suspension depth, per thread: a wrapper on one thread does not stop
# another thread's count
_LOCAL = threading.local()
_MEM_LIVE: dict = {}         # id(storage) -> bytes, storages made under a
                             # memory recorder and still alive


class Cost:
    """A counted program: FLOPs, bytes, collectives, sort calls, hand
    kernel calls and, for a memory recorder, the peak of live storage."""

    def __init__(self):
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in COLL_KINDS}
        self.coll_count = 0
        self.sorts = 0
        self.ops = 0
        self.kernels: dict = {}
        self.unrecorded = 0
        self.memory: dict | None = None

    def add(self, other: "Cost", times: int = 1) -> None:
        self.flops += times * other.flops
        self.dot_flops += times * other.dot_flops
        self.bytes += times * other.bytes
        for k, v in other.coll.items():
            self.coll[k] += times * v
        self.coll_count += times * other.coll_count
        self.sorts += times * other.sorts
        self.ops += times * other.ops
        self.unrecorded += times * other.unrecorded
        for name, k in other.kernels.items():
            mine = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0,
                                                  "flops": 0.0})
            for f in mine:
                mine[f] += times * k[f]

    def as_dict(self) -> dict:
        """The reference's record (``analyze_text``) and this walk's own
        fields."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "coll": dict(self.coll),
               "coll_bytes": sum(self.coll.values()),
               "coll_count": self.coll_count,
               "dot_flops": self.dot_flops, "sorts": self.sorts,
               "ops": self.ops,
               "kernels": {k: dict(v) for k, v in self.kernels.items()}}
        if self.unrecorded:
            out["unrecorded"] = self.unrecorded
        if self.memory is not None:
            out["memory"] = dict(self.memory)
        return out


# ---------------------------------------------------------------------------
# op classes
# ---------------------------------------------------------------------------
_aten = torch.ops.aten


def _packets(names: str) -> set:
    return {getattr(_aten, n) for n in names.split() if hasattr(_aten, n)}


_FREE = _packets("""
    empty empty_like empty_strided new_empty new_empty_strided arange
    scalar_tensor lift_fresh lift_fresh_copy detach alias _local_scalar_dense
    sym_size sym_stride sym_numel sym_storage_offset is_same_size set_
    resize_ record_stream""")
# materializing ops that compute nothing (bytes only)
_MOVES = _packets("""
    copy_ _to_copy clone cat stack fill_ zero_ full full_like zeros
    zeros_like ones ones_like new_zeros new_ones new_full _unsafe_view
    constant_pad_nd index_select repeat flip roll""")
_SORTS = {_aten.sort}


def _mv_flops(a, b, *_, **__):
    return 2 * a.shape[0] * a.shape[1]


def _dot_flops(a, b, *_, **__):
    return 2 * a.shape[0]


_EXTRA_DOTS = {_aten.mv: _mv_flops, _aten.dot: _dot_flops,
               _aten.vdot: _dot_flops,
               _aten.addmv: lambda s, a, b, *r, **k: _mv_flops(a, b)}

def _reached_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor reaches: a broadcast (stride-0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _flat(x, out) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _tensors(tree) -> list:
    return _flat(tree, [])


_KINDS: dict = {}     # op overload -> how it is counted


def _kind(func):
    """How an op counts: "composite" (count its decomposition), "free",
    "dot", "move", "sort" or "compute"."""
    k = _KINDS.get(func)
    if k is not None:
        return k
    from torch.utils.flop_counter import flop_registry
    packet = func._overloadpacket
    if func.namespace == "aten" and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
        k = "composite"
    elif packet in _FREE or func.is_view or func.namespace == "prim":
        k = "free"
    elif packet in flop_registry or packet in _EXTRA_DOTS:
        k = "dot"
    elif packet in _MOVES:
        k = "move"
    elif packet in _SORTS:
        k = "sort"
    else:
        k = "compute"
    _KINDS[func] = k
    return k


def _dot_count(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    packet = func._overloadpacket
    fn = flop_registry.get(packet)
    if fn is not None:
        return float(fn(*args, **kwargs, out_val=out))
    return float(_EXTRA_DOTS[packet](*args, **kwargs))


class _CostMode(TorchDispatchMode):
    """Counts every op into the innermost recorder."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind == "composite" and not _suspended():
            # a composite op reaches the mode whole where autograd is off
            # (inference mode): count the ops it is made of instead, as
            # autograd would have dispatched them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _suspended() or not _STACK:
            return out
        rec = _STACK[-1]
        outs = _flat(out, [])
        ins = _flat(kwargs, _flat(args, []))
        if rec.track_memory:
            _track(outs, ins)
        if kind == "free" or kind == "composite":
            return out
        c = rec.cost
        c.ops += 1
        ins = [t for t in ins if not any(t is o for o in outs)]
        c.bytes += (sum(_reached_bytes(t) for t in ins)
                    + sum(_reached_bytes(t) for t in outs))
        if kind == "dot":
            dot = _dot_count(func, args, kwargs, out)
            c.dot_flops += dot
            c.flops += dot
        elif kind != "move":
            c.flops += sum(t.numel() for t in outs)
            if kind == "sort":
                c.sorts += 1
        return out


def _track(outs, ins) -> None:
    """Add the storages an op made (not one of its inputs') to the live
    bytes of every memory recorder; a finalizer takes them off."""
    in_st = None
    for t in outs:
        s = t.untyped_storage()
        key = id(s)
        if key in _MEM_LIVE:
            continue
        if in_st is None:
            in_st = [i.untyped_storage() for i in ins]
        if any(s is i for i in in_st):
            continue
        nb = s.nbytes()
        _MEM_LIVE[key] = nb
        _STATE["live"] += nb
        weakref.finalize(s, _freed, key)
        for r in _STACK:
            if r.track_memory:
                r.peak = max(r.peak, _STATE["live"] - r.base)


def _freed(key) -> None:
    nb = _MEM_LIVE.pop(key, 0)
    _STATE["live"] -= nb


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------
class Recorder:
    """Counts what runs inside the block: ``with Recorder() as r: ...``,
    then ``r.cost`` (a ``Cost``) and ``r.as_dict()``.  Recorders nest; an
    inner one's count is added to the outer one's when it ends, unless it
    was made with ``propagate=False`` (a capture: the count is added per
    replay instead)."""

    def __init__(self, memory: bool = False, propagate: bool = True):
        self.cost = Cost()
        self.track_memory = memory
        self.propagate = propagate
        self.peak = 0
        self.base = 0
        self._mode = None

    def __enter__(self):
        global ACTIVE
        if not _STACK:
            _STATE["thread"] = threading.get_ident()
            self._mode = _CostMode()
            self._mode.__enter__()
        self.base = _STATE["live"]
        _STACK.append(self)
        ACTIVE = self
        return self

    def __exit__(self, *exc):
        global ACTIVE
        _STACK.pop()
        ACTIVE = _STACK[-1] if _STACK else None
        if self._mode is not None:
            self._mode.__exit__(*exc)
            self._mode = None
        if self.track_memory:
            self.cost.memory = {"temp_bytes": self.peak}
        if self.propagate and _STACK:
            _STACK[-1].cost.add(self.cost)
        return False

    def as_dict(self) -> dict:
        return self.cost.as_dict()


def _suspended() -> int:
    return getattr(_LOCAL, "depth", 0)


def counting() -> bool:
    """Whether this thread's work is being counted now (a recorder is
    active, on this thread, and not suspended)."""
    return (bool(_STACK) and not _suspended()
            and threading.get_ident() == _STATE["thread"])


@contextlib.contextmanager
def suspended():
    """Nothing this thread does inside the block is counted: ops, kernel
    reports and collectives (a kernel's plain version, a warm-up run)."""
    _LOCAL.depth = _suspended() + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def add(cost: "Cost | None", times: int = 1) -> None:
    """Add ``times`` replays of a captured count to the active recorder
    (a capture made while no recorder was active has ``None``)."""
    if not counting() or times == 0:
        return
    if cost is None:
        _STACK[-1].cost.unrecorded += times
    else:
        _STACK[-1].cost.add(cost, times)


def collective(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose result is ``nbytes`` (the
    operand for reduce-scatter), all-reduce 2x."""
    if not counting():
        return
    if kind not in COLL_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    c = _STACK[-1].cost
    c.coll[kind] += 2 * nbytes if kind == "all-reduce" else nbytes
    c.coll_count += 1


# ---------------------------------------------------------------------------
# the hand kernels: formulas of the work each call must do
# ---------------------------------------------------------------------------
def sort_call_cost(keys: torch.Tensor) -> tuple:
    """One tile-sort or merge call over n keys with int32 payloads: every
    key and payload read once and written once.  (bytes, flops)."""
    n = keys.numel()
    return 2 * n * (keys.element_size() + 4), 2 * n


def unique_mask_cost(data: torch.Tensor) -> tuple:
    """(N, C) rows read once, one int32 flag written per row."""
    n = data.shape[0]
    return data.numel() * data.element_size() + 4 * n, n


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def probe_cost(queries: torch.Tensor, hay: torch.Tensor) -> tuple:
    """The queries read and the flags written once, and of the haystack
    the 32-byte sectors that hold the queries' lower bounds (an answer
    rests on the key there; no search needs to read the rest).  Fake
    tensors hold no keys, and a call inside a CUDA graph capture has not
    got its replays' keys yet (nor may it read any: that is a host sync):
    then every query counts a sector of its own, up to the haystack's,
    the most a call can need."""
    n, h = queries.numel(), hay.numel()
    sector = max(32 // hay.element_size(), 1)
    if _is_fake(queries) or _is_fake(hay) or _capturing(hay):
        sectors = min(n, -(-h // sector))
    else:
        pos = torch.searchsorted(hay, queries).clamp_(max=h - 1)
        sectors = torch.unique(pos // sector).numel()
    return n * (queries.element_size() + 4) + sectors * 32, n


def kernel(name: str, cost, fn, *args, sorts: int = 0):
    """Run one hand-kernel call ``fn(*args)`` with its count: ``cost`` is
    (bytes, flops) per call, or a dict name -> (calls, bytes, flops) for a
    call that stands for several kernels' calls.  The ops inside are not
    counted; the storages of its outputs are, as made."""
    if not counting():
        return fn(*args)
    c = _STACK[-1].cost
    parts = cost if isinstance(cost, dict) else {name: (1, *cost)}
    for kname, (n, nb, fl) in parts.items():
        k = c.kernels.setdefault(kname, {"calls": 0, "bytes": 0.0,
                                         "flops": 0.0})
        k["calls"] += n
        k["bytes"] += n * nb
        k["flops"] += n * fl
        c.bytes += n * nb
        c.flops += n * fl
    c.sorts += sorts
    with suspended():
        out = fn(*args)
    if _STACK[-1].track_memory:
        _track(_tensors(out), _tensors(args))
    return out


def counted(name: str, cost_fn):
    """Decorator of a kernel wrapper whose every call is one launch of
    ``name``: ``cost_fn(*args)`` gives its (bytes, flops).  With no
    recorder active the wrapper runs as it is."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args):
            if ACTIVE is None or not counting():
                return fn(*args)
            with suspended():
                c = cost_fn(*args)
            return kernel(name, c, fn, *args)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# walking a program
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def dry():
    """Fake tensors: whatever is made inside holds shapes and dtypes and
    no memory (``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


def _storages(tree) -> dict:
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[id(s)] = (s, s.nbytes())
    return out


def walk(fn, arguments=None):
    """Run ``fn()`` under a memory recorder.  ``arguments`` is the tree of
    tensors the step reads as its inputs (weights, optimizer state, batch,
    caches); the returned tree is its outputs.  Returns (fn's result, the
    record, with ``memory``: ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``alias_bytes`` (outputs that are arguments, updated
    in place) and ``per_device_total`` = argument + output + temp -
    alias, as the reference sums ``memory_analysis()``)."""
    args = _storages(arguments)
    with Recorder(memory=True) as r:
        out = fn()
    rec = r.as_dict()
    outs = _storages(out)
    alias = sum(nb for k, (_, nb) in outs.items() if k in args)
    made_out = sum(nb for k, (_, nb) in outs.items()
                   if k in _MEM_LIVE and k not in args)
    mem = {"argument_bytes": sum(nb for _, nb in args.values()),
           "output_bytes": sum(nb for _, nb in outs.values()),
           "temp_bytes": max(r.peak - made_out, 0),
           "alias_bytes": alias}
    mem["per_device_total"] = (mem["argument_bytes"] + mem["output_bytes"]
                               + mem["temp_bytes"] - mem["alias_bytes"])
    rec["memory"] = mem
    return out, rec
