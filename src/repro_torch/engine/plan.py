"""Rule-plan IR and capacity planner of the compiled executors (the port of
``repro.engine.plan``): *what* a materialization round computes.

A :class:`RulePlan` is the static description of one Datalog rule —
per-atom filters, the Def. 23 antijoin pre-restriction slot, the left-deep
join chain, and the head projection — with a pure-python ``key``
fingerprint.  ``compile_rule_plan`` builds one (or ``None`` for rules
outside the plannable fragment: existentials, disconnected bodies).

The plan describes what a round computes; two executors stitch plans
into static-shape programs, captured as CUDA graphs on the card: the fused
round executor (``repro_torch.engine.fused``) on one block per predicate,
and the sharded executor (``repro_torch.engine.distributed``) on
hash-partitioned shards, with bucket exchanges before the Def. 23
pre-restriction and before both sides of every join.

This module also owns the capacity + overflow contract:

* :class:`_Caps` pre-sizes every planned buffer (store / delta / tail /
  join / exchange bucket) before a program is built, and memoizes
  successful sizes per :func:`program_fingerprint` in the module-level
  ``_CAP_MEMO`` so warmed-up programs plan right first try.
* Every planned capacity gets an in-program overflow flag (``needed >
  planned``).  When any flag fires, the executor discards the round's
  outputs, doubles exactly the overflowed capacities under a
  :class:`RetryBudget`, and retries the same round from inputs it still
  holds.  Labels are ``(kind, name)`` pairs; an executor emits its flags
  in exactly the order it enumerates its labels.
* :func:`_cached_program` is the bounded FIFO cache of built programs
  (captured graphs on the card), keyed by each program's full static
  signature.

``_walk_rule`` / ``_absorb_traced`` are the round pieces built from the
``repro_torch.engine.ops`` cores; nothing in them synchronizes the host.
``_walk_rule`` is a generator: with a ``route`` it yields at every
exchange (the sharded executor's collectives), without one it never
yields, and ``_exec_rule_traced`` runs it to its end.
:func:`_linear_tail` decides when the remaining fixpoint is linear (every
still-reachable rule has exactly one body atom over a still-changing
predicate) so a whole phase can run in one device loop, and
:func:`_select_state` is the loop-carry select that keeps the last GOOD
state when an overflow flag fires mid-loop.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.terms import is_var
from repro_torch.engine import faultinject, ops
from repro_torch.engine.relation import next_pow2, pad_of


def max_retries() -> int:
    """Attempt ceiling of one overflow double-and-retry ladder
    (``REPRO_MAX_RETRIES``): consecutive zero-progress retries past this
    raise :class:`CapacityError` instead of doubling toward OOM."""
    return int(os.environ.get("REPRO_MAX_RETRIES", "8"))


def max_resident_bytes() -> int:
    """Resident-footprint ceiling for the planner's padded buffers
    (``REPRO_MAX_RESIDENT_MB``, default 8192): doubling past it raises
    :class:`CapacityError` — the executor degrades to the two-phase spill
    path instead of allocating buffers that cannot fit."""
    return int(os.environ.get("REPRO_MAX_RESIDENT_MB", "8192")) << 20


class CapacityError(RuntimeError):
    """A capacity ladder ran out of budget.  Names the bucket label being
    grown and the bytes the next plan would have resided at, so the
    operator (or the spill path) knows which buffer diverged."""

    def __init__(self, label, requested_bytes: int, attempts: int,
                 reason: str):
        self.label = label
        self.requested_bytes = int(requested_bytes)
        self.attempts = attempts
        self.reason = reason
        super().__init__(
            f"capacity bucket {label!r} exhausted its retry budget after "
            f"{attempts} attempts ({reason}); the plan would reside at "
            f"~{self.requested_bytes >> 20} MiB "
            f"({self.requested_bytes} bytes). Raise REPRO_MAX_RETRIES / "
            "REPRO_MAX_RESIDENT_MB, or let the driver spill to the "
            "two-phase executor.")


class RetryBudget:
    """Bounded double-and-retry ladder.

    One budget guards one driver invocation.  ``overflow(labels)`` records
    a failed attempt and grows exactly the overflowed capacities; ``ok()``
    marks progress (a committed round / a fixpoint exit that advanced) and
    resets the ladder.  Growth escalates: the first two consecutive
    overflows of a label double it once each, then up to four doublings
    (x16) per attempt.

    Two ceilings end the ladder with a diagnostic :class:`CapacityError`:
    ``REPRO_MAX_RETRIES`` consecutive zero-progress attempts, or a planned
    resident footprint past ``REPRO_MAX_RESIDENT_MB``."""

    def __init__(self, caps: "_Caps", row_bytes: int = 8,
                 attempts: int | None = None,
                 resident_bytes: int | None = None):
        self.caps = caps
        self.row_bytes = max(int(row_bytes), 1)
        self.max_attempts = max_retries() if attempts is None else attempts
        self.max_bytes = (max_resident_bytes() if resident_bytes is None
                          else resident_bytes)
        self._attempts = 0
        self._streak: dict = {}

    def ok(self) -> None:
        self._attempts = 0
        self._streak.clear()

    def resident_bytes(self) -> int:
        return self.caps.planned_rows() * self.row_bytes

    def overflow(self, labels) -> None:
        """Record one failed attempt; double every overflowed label (with
        escalation); raise :class:`CapacityError` when the budget is
        spent."""
        labels = list(labels)
        self._attempts += 1
        worst = labels[0] if labels else ("unknown", "?")
        if self._attempts > self.max_attempts:
            raise CapacityError(worst, self.resident_bytes(),
                                self._attempts - 1,
                                f"REPRO_MAX_RETRIES={self.max_attempts} "
                                "zero-progress retries")
        for label in set(self._streak) - set(labels):
            del self._streak[label]
        for label in labels:
            streak = self._streak.get(label, 0) + 1
            self._streak[label] = streak
            doubles = 1 if streak <= 2 else min(1 << (streak - 2), 4)
            for _ in range(doubles):
                self.caps.double(label)
        resident = self.resident_bytes()
        if resident > self.max_bytes:
            raise CapacityError(worst, resident, self._attempts,
                                "planned buffers exceed "
                                "REPRO_MAX_RESIDENT_MB")


# successful planner capacities keyed by (program fingerprint, kind, name) —
# reused across EngineKB instances so a warmed-up program never re-learns
# its buckets
_CAP_MEMO: dict = {}
_CAP_MEMO_LIMIT = 8192

# built round / fixpoint programs keyed by their full static signature;
# bounded FIFO so superseded capacity plans do not strand captured graphs
# (and their memory pools) in long-lived processes
_COMPILE_CACHE: dict = {}
_COMPILE_CACHE_LIMIT = 128


def _cached_program(sig, build):
    prog = _COMPILE_CACHE.get(sig)
    if prog is None:
        while len(_COMPILE_CACHE) >= _COMPILE_CACHE_LIMIT:
            _drop_program(next(iter(_COMPILE_CACHE)))
        prog = _COMPILE_CACHE[sig] = build()
    return prog


def _drop_program(sig) -> None:
    """Forget one built program; a captured one frees its graphs (tensors
    still held elsewhere keep their memory until they are released)."""
    prog = _COMPILE_CACHE.pop(sig, None)
    close = getattr(prog, "close", None)
    if close is not None:
        close()


def clear_programs() -> None:
    """Drop every built program (and the graphs captured for them)."""
    for sig in list(_COMPILE_CACHE):
        _drop_program(sig)


def program_fingerprint(plan_keys, total_count):
    """Capacity-memo key for one (program, instance scale): the rule plan
    keys plus the pow-2 bucket of the instance size, so converged capacities
    transfer across runs of the same program at the same scale."""
    return (tuple(plan_keys), next_pow2(max(int(total_count), 1)))


# ---------------------------------------------------------------------------
# static rule plans
# ---------------------------------------------------------------------------
class RulePlan:
    """Static description of one Datalog rule: per-atom filters, the Def. 23
    pre-restriction slot, the left-deep join chain, and the head
    projection.  ``key`` is a pure-python fingerprint used for program
    cache and capacity-memo keys."""

    def __init__(self, rule, dic):
        from repro_torch.engine.materialize import _atom_filters
        self.head_pred = rule.head.pred
        self.body_preds = tuple(a.pred for a in rule.body)
        self.atoms = []            # (eq_pairs, const_pairs) per body atom
        self.joins = []            # (lkey in cur, rkey in atom, eq2) per join
        var_col: dict = {}
        width = 0
        self.ok = not rule.existentials
        for j, atom in enumerate(rule.body):
            eq, consts, vc = _atom_filters(atom, dic)
            self.atoms.append((eq, consts))
            if j == 0:
                var_col = dict(vc)
                width = atom.arity
                continue
            shared = [v for v in vc if v in var_col]
            if not shared:
                self.ok = False    # disconnected body -> cross join, not fused
                break
            v0 = shared[0]
            eq2 = tuple((var_col[v], width + vc[v]) for v in shared[1:])
            self.joins.append((var_col[v0], vc[v0], eq2))
            for v, c in vc.items():
                var_col.setdefault(v, width + c)
            width += atom.arity
        # Def. 23 pre-restriction: first body atom whose own columns
        # determine the full head tuple (same choice as execute_rule)
        self.pre = None
        if self.ok:
            for j, a in enumerate(rule.body):
                _, _, vc = _atom_filters(a, dic)
                if rule.head.args and all(is_var(t) and t in vc
                                          for t in rule.head.args):
                    self.pre = (j, tuple(vc[t] for t in rule.head.args))
                    break
            self.head_spec = tuple(
                ("col", var_col[t]) if is_var(t) else ("const", dic.encode(t))
                for t in rule.head.args)
            self.key = (self.head_pred, self.body_preds, tuple(self.atoms),
                        tuple(self.joins), self.pre, self.head_spec)


def compile_rule_plan(rule, dic):
    """Build the static plan for one rule, or None if the rule is outside
    the plannable fragment (existentials / disconnected body)."""
    plan = RulePlan(rule, dic)
    return plan if plan.ok else None


# ---------------------------------------------------------------------------
# linear-tail fixpoint plumbing
# ---------------------------------------------------------------------------
def _linear_tail(intens_plans, live_preds):
    """If every rule still reachable from the live deltas has exactly one
    body atom over a still-changing predicate, the remaining fixpoint is
    linear: return (changing predicate set S, [(plan, delta_pos)]).  Else
    None, and the driver keeps stepping host-driven rounds."""
    S = set(live_preds)
    while True:
        add = {p.head_pred for p in intens_plans
               if any(bp in S for bp in p.body_preds)} - S
        if not add:
            break
        S |= add
    active = []
    for plan in intens_plans:
        hits = [j for j, bp in enumerate(plan.body_preds) if bp in S]
        if not hits:
            continue
        if len(hits) != 1:
            return None
        active.append((plan, hits[0]))
    return (tuple(sorted(S)), tuple(active)) if active else None


def _select_state(bad, old, new):
    """Loop-carry select: keep ``old`` (the last good state) wherever the
    0-d ``bad`` flag is set, else adopt ``new``.  ``old`` / ``new`` are
    matching tuples of tensors."""
    return tuple(torch.where(bad, o, n) for o, n in zip(old, new))


# ---------------------------------------------------------------------------
# round pieces (built from the ops cores; no host interaction)
# ---------------------------------------------------------------------------
def _project_head_core(data, spec):
    cols = []
    for kind, v in spec:
        if kind == "col":
            cols.append(data[:, v])
        else:
            cols.append(torch.full((data.shape[0],), v, dtype=data.dtype,
                                   device=data.device))
    valid = data[:, 0] != pad_of(data)
    return torch.where(valid[:, None], torch.stack(cols, dim=1),
                       pad_of(data))


def _walk_rule(plan, inputs, pre_data, join_caps, prefilter=None,
               route=None):
    """One rule body over pre-sized inputs, as a generator.  ``inputs`` are
    lexsorted padded blocks (stores / deltas — the sorted-store invariant is
    the compiled executors' precondition), so primary-column join keys need
    no sort.  The Def. 23 pre-restriction either antijoins against
    ``pre_data`` (one haystack) or calls the ``prefilter(rows, cols) ->
    keep_mask`` hook (the fixpoint loops probe store | tail).

    ``route`` (the sharded executor) re-partitions rows before the
    pre-restriction (by the projected head tuple, so the probe is local to
    the shard that owns the would-be head fact) and before both sides of
    each join (by the join key): ``rows', flags, sort_key = yield from
    route(rows, key_cols, tag)``, where ``sort_key`` is the known sort
    column of ``rows'`` (None: unknown, the chain sorts).  Without a route
    the walk never yields.  Returns (head_rows, triggers, overflow_flags);
    the flag order is pre / left / right exchange flags then the
    join-capacity flag, per join step."""
    ovfs = []
    cur = None
    cur_skey = None                # statically-known sort column of cur
    for j, (eq, consts) in enumerate(plan.atoms):
        data = inputs[j]
        data_skey = 0              # inputs arrive lexsorted (primary col 0)
        if eq or consts:
            mask = ops.filter_mask_core(data, eq, consts)
            data = ops.compact_core(data, mask, data.shape[0])
        if plan.pre is not None and plan.pre[0] == j and (
                pre_data is not None or prefilter is not None):
            if route is not None:
                data, flags, data_skey = yield from route(
                    data, plan.pre[1], ("pre", j))
                ovfs += flags
            if prefilter is not None:
                keep = prefilter(data, plan.pre[1])
            else:
                keep = ops.anti_keep_core(data, pre_data, plan.pre[1])
            data = ops.compact_core(data, keep, data.shape[0])
        if cur is None:
            cur, cur_skey = data, data_skey
            continue
        lk, rk, eq2 = plan.joins[j - 1]
        if route is not None:
            cur, flags, cur_skey = yield from route(cur, (lk,), ("jl", j))
            ovfs += flags
            data, flags, data_skey = yield from route(data, (rk,),
                                                      ("jr", j))
            ovfs += flags
        ls = cur if cur_skey == lk else ops.keysort_core(cur, lk)
        rs = data if data_skey == rk else ops.keysort_core(data, rk)
        total, per, cum, lo = ops.join_count_core(ls, rs, lk, rk)
        cap = join_caps[j - 1]
        ovfs.append(total > cap)
        cur = ops.join_gather_core(ls, rs, per, cum, lo, total, cap)
        cur_skey = lk              # output rows follow ls's key order
        if eq2:
            mask = ops.filter_mask_core(cur, eq2, ())
            cur = ops.compact_core(cur, mask, cap)
    triggers = (cur[:, 0] != pad_of(cur)).sum()
    return _project_head_core(cur, plan.head_spec), triggers, ovfs


def _exec_rule_traced(plan, inputs, pre_data, join_caps, prefilter=None):
    """``_walk_rule`` without a route, run to its end (the fused
    executor's rule body).  Returns (head_rows, triggers, overflow_flags):
    one join-capacity flag per join step."""
    walk = _walk_rule(plan, inputs, pre_data, join_caps, prefilter)
    try:
        next(walk)
    except StopIteration as done:
        return done.value
    raise RuntimeError("a rule walk without a route yielded")


def _absorb_traced(heads, fresh_mask_fn, into_data, into_count, delta_cap,
                   presorted: bool = False):
    """Round-level redundancy filtering + merge for one predicate: concat
    rule outputs, lexsort + first-occurrence dedup, keep rows passing
    ``fresh_mask_fn`` (non-membership in the store — or in store | tail
    inside the fixpoint loops), compact the fresh rows to the delta
    bucket, and fold them into ``into_data`` (the store, or the loop's tail
    buffer) with the incremental sorted merge.  ``presorted`` lets a caller
    that already holds ONE lexsorted head block (the sharded fixpoint's
    sorted absorb exchange) skip the sort.  Returns (merged, new_count,
    delta, n_fresh, (delta_overflow, merge_overflow))."""
    cat = heads[0] if len(heads) == 1 else torch.cat(heads, dim=0)
    s = cat if presorted and len(heads) == 1 else ops.lexsort_core(cat)
    uniq = ops.dedup_mask_core(s)
    fresh_mask = uniq & fresh_mask_fn(s)
    n_fresh = fresh_mask.sum()
    delta = ops.compact_core(s, fresh_mask, delta_cap)
    new_count = into_count + n_fresh
    merged = ops.merge_core(into_data, delta, into_count, n_fresh)
    return (merged, new_count, delta, n_fresh,
            (n_fresh > delta_cap, new_count > into_data.shape[0]))


# ---------------------------------------------------------------------------
# capacity planner
# ---------------------------------------------------------------------------
class _Caps:
    """Pre-sizes every planned buffer; doubles on overflow; memoizes
    successful sizes per program fingerprint.

    Capacity kinds: per-predicate ``store`` / ``delta`` / ``tail`` buckets,
    per-join-step ``join`` output buckets, and per-exchange-site ``bucket``
    capacities (the sharded executor: the per-destination bucket of one
    exchange; the received block is ``ndev * bucket`` rows).  For the
    sharded executor every count, and so every capacity, is per shard."""

    def __init__(self, fp, stores, ndev: int = 1, lean: bool = False):
        """``lean`` starts the delta-family guesses at the floor instead of
        ~2x the store scale: incremental-maintenance calls enter with deltas
        of a few rows.  Overflow doubling still grows them when a cascade
        turns out deep; memoized capacities dominate either guess.  The
        ``storm`` fault (``REPRO_FAULT_SPEC``) forces the same floor."""
        self.fp = fp
        base = max([c for _, c in stores.values()] + [1])
        if lean or faultinject.get_faults().tiny_caps():
            # forced-overflow storm: start the delta-family guesses at the
            # floor so every cold phase pays the full double-and-retry ladder
            base = 1
        self.store = {}
        self.delta = {}
        self.tail = {}
        self.join = {}
        self.bucket = {}
        for pred, (_, count) in stores.items():
            # converged capacities from a previous run of this program
            # dominate the cold-start guess
            memo = _CAP_MEMO.get((fp, "store", pred), 0)
            guess = memo or next_pow2(max(32, 4 * max(count, 1)))
            self.store[pred] = max(guess, next_pow2(max(count, 1)))
        self._delta_guess = next_pow2(max(64, 2 * base))
        self._bucket_guess = next_pow2(max(32, 2 * base // max(ndev, 1)))

    def delta_cap(self, pred):
        if pred not in self.delta:
            self.delta[pred] = (_CAP_MEMO.get((self.fp, "delta", pred), 0)
                                or self._delta_guess)
        return self.delta[pred]

    def join_cap(self, plan, idx):
        key = (plan.key, idx)
        if key not in self.join:
            self.join[key] = (_CAP_MEMO.get((self.fp, "join", key), 0)
                              or next_pow2(max(64, 2 * self._delta_guess)))
        return self.join[key]

    def tail_cap(self, pred):
        """Sorted-tail bucket for the fused fixpoint loop: new facts
        accumulate here (O(tail) merges per iteration instead of O(store))
        until it fills and the host folds it into the store."""
        if pred not in self.tail:
            self.tail[pred] = (_CAP_MEMO.get((self.fp, "tail", pred), 0)
                               or 4 * self.delta_cap(pred))
        return self.tail[pred]

    def bucket_cap(self, key):
        """Per-destination bucket of one sharded exchange site."""
        if key not in self.bucket:
            self.bucket[key] = (_CAP_MEMO.get((self.fp, "bucket", key), 0)
                                or self._bucket_guess)
        return self.bucket[key]

    def seed_delta(self, pred, count):
        """Widen ``pred``'s delta bucket to hold an externally-seeded delta
        (incremental materialization enters the round loop with insertions
        as the FIRST delta, so the seed must fit a priori)."""
        self.delta[pred] = max(self.delta_cap(pred),
                               next_pow2(max(int(count), 1)))
        return self.delta[pred]

    def double(self, label):
        kind, name = label
        getattr(self, kind)[name] *= 2

    def planned_rows(self) -> int:
        """Total planned buffer rows across every capacity kind touched so
        far (the padded-buffer footprint is this times arity times the
        store dtype's itemsize)."""
        return sum(sum(getattr(self, k).values()) for k in _KINDS)

    def state(self) -> dict:
        """Checkpointable snapshot of every converged capacity (plain
        dicts of pow-2 sizes keyed by the planner's own label names)."""
        return {k: dict(getattr(self, k)) for k in _KINDS}

    def adopt(self, state: dict | None) -> None:
        """Overlay a checkpointed capacity plan: every saved size floors
        the current one (sizes only grow, so a resumed run plans at least
        as large as the crashed run had converged to)."""
        if not state:
            return
        for kind in _KINDS:
            mine = getattr(self, kind)
            for name, cap in state.get(kind, {}).items():
                mine[name] = max(mine.get(name, 0), int(cap))

    def memoize(self):
        while len(_CAP_MEMO) >= _CAP_MEMO_LIMIT:
            _CAP_MEMO.pop(next(iter(_CAP_MEMO)))
        for kind in _KINDS:
            for name, cap in getattr(self, kind).items():
                _CAP_MEMO[(self.fp, kind, name)] = cap


_KINDS = ("store", "delta", "tail", "join", "bucket")
