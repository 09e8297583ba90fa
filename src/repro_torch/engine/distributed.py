"""Sharded materialization (the port of ``repro.engine.distributed``): the
rule-plan IR of ``repro_torch.engine.plan`` run over hash-partitioned
shards, in lockstep, on one device.

Data model (:class:`ShardedKB`): every predicate's store is partitioned
into ``ndev`` shards by the full-tuple hash — the canonical home of a fact
is the shard its hash picks, so dedup and the antijoin against the store
are local to a shard — and each shard keeps its rows lexsorted.  All
shards live on the KB's device as one global ``(ndev * cap, ar)`` tensor
per predicate (the reference's layout), shard *d* in rows ``d * cap ..
(d + 1) * cap``.

The port's ``shard_map``: shard bodies in lockstep
-------------------------------------------------
The reference runs each round as SPMD code under ``shard_map``: every
shard runs the same body on its own block and meets the others at
``all_to_all`` (the bucket exchange) and ``psum`` (the convergence
scalars).  Here each body is a Python generator over one shard's tensors
that ``yield``s at every collective — a :class:`_Collective` carrying its
``(ndev, bucket_cap, ar)`` send buckets or its scalars — and
:func:`_lockstep` plays ``shard_map``: it steps the ``ndev`` generators to
their next ``yield``, checks that all of them reached the same site (and
raises if not), performs the collective on the device (the all-to-all is
the transpose ``(src, dst, cap, ar) -> (dst, src, cap, ar)`` of the
stacked buckets; ``psum`` is a sum over shards), sends each shard its part
and goes on.  The plans are static, so every shard reaches the same sites
in the same order, as under ``shard_map``.  The rule walk itself is
``plan._walk_rule``, whose ``route`` hook is a generator that exchanges
before the pre-restriction and before both sides of every join.

Why this design: it keeps the reference's per-shard code; it runs in one
thread on one stream, so a whole sharded round is captured as one CUDA
graph; and it needs no process group, so nothing can hang.  Threads behind
a barrier would break graph capture and have no fixed order; one process
per shard would need a process group (and NCCL takes one rank per card);
a batch axis over shards would mean rewriting every op core and kernel.
Shards on several cards (shard *d* on ``cuda:d``, the exchange as peer
copies) are a later item (ROADMAP.md).

Programs: each round is ONE program (cached by its static signature): the
rule walks with their exchanges, the canonical-home re-partition of every
derived predicate, the per-shard absorb (``plan._absorb_traced``), and the
summed fresh totals, trigger total and overflow vector.  On the card it is
captured as a CUDA graph once per signature and replayed (after one eager
run on copies, whose results are dropped); the host pulls one int64
bundle per round attempt (``HOST_SYNC_STATS.dist_pulls``).  Once the
remaining program is linear (``plan._linear_tail``), the whole phase runs
as one loop program: a prologue (the hoisted store-side exchanges and the
first delta exchange) and a loop whose iteration is a whole sharded round,
with the delta exchange for iteration k+1 produced at the end of iteration
k and carried through the loop state.  On the card the iteration is
captured once and runs under the conditional WHILE node of
``repro_torch.kernels.graph_loop``; on the CPU it is the host loop.  The
host pulls once per phase exit (``dist_fixpoint_pulls``);
``REPRO_DIST_FIXPOINT=0`` steps every round from the host.

Overflow follows ``repro_torch.engine.plan``: every planned capacity
(store / delta / tail / join / exchange bucket, all per shard) carries an
in-program flag; when any fires the outputs are discarded (or the loop
keeps its last good state), the host doubles exactly the overflowed
capacities and retries (``dist_retries`` for host-stepped rounds; extra
``dist_fixpoint_pulls`` inside fixpoint phases).  An exhausted
``RetryBudget`` spills the remaining rounds to the two-phase executor.

No kernel is the sharded executor's own: the op cores launch the hand
kernels on CUDA tensors wherever they reach them, and take their plain
versions on CPU tensors.  Entry points: ``materialize(kb, mode="tg",
backend="dist")`` (or ``REPRO_DIST=1``), :func:`materialize_distributed`
and :func:`run_distributed_tc`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis import cost as _cost
from repro_torch.engine import ops, recovery
from repro_torch.engine.fused import (_DeviceLoop, _Eager, _HostLoop,
                                      _Replay, _upload)
from repro_torch.engine.plan import (_absorb_traced, _cached_program, _Caps,
                                     _drop_program, _linear_tail,
                                     _select_state, _walk_rule,
                                     CapacityError, compile_rule_plan,
                                     program_fingerprint, RetryBudget)
from repro_torch.engine.relation import (Relation, host_order, lex_order,
                                         next_pow2, pad_of, pad_value)

# ---------------------------------------------------------------------------
# hashing: the device hash and its host mirror agree bit for bit (host
# placement of checkpointed rows partitions with the function the
# exchanges use on the device)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32), without overflowing
    int64: the constant is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """The reference's uint32 mix (Wang hash variant), on int64 tensors
    holding uint32 values."""
    x = x & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _cols_hash(rows, cols):
    """Combined uint32 hash of the given columns of each row (int64
    tensor)."""
    h = 0x9E3779B9
    for c in cols:
        h = _hash32(((rows[:, c].long() & _M32) + h) & _M32)
    if isinstance(h, int):
        h = torch.full((rows.shape[0],), h, dtype=torch.int64,
                       device=rows.device)
    return h


def _tuple_hash(rows):
    return _cols_hash(rows, range(rows.shape[1]))


def _shard_of(h, ndev: int):
    return h % ndev


def _np_hash32(x):
    x = x.astype(np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    return x ^ (x >> 16)


def np_tuple_hash(rows: np.ndarray) -> np.ndarray:
    """Host mirror of ``_tuple_hash``."""
    h = np.uint32(0x9E3779B9)
    out = np.full(rows.shape[0], h, np.uint32)
    for c in range(rows.shape[1]):
        out = _np_hash32(rows[:, c].astype(np.uint32) + out)
    return out


# ---------------------------------------------------------------------------
# the port's shard_map: shard bodies as generators, stepped in lockstep
# ---------------------------------------------------------------------------
class _Collective:
    """What a shard body yields at a collective: ``kind`` is "all_to_all"
    (``value``: its (ndev, bucket_cap, ar) send buckets) or "psum"
    (``value``: a tensor to sum over shards); ``site`` names the call."""

    __slots__ = ("kind", "site", "value")

    def __init__(self, kind, site, value):
        self.kind = kind
        self.site = site
        self.value = value


def _psum(site, value):
    """The yield of one ``psum``: ``total = yield _psum(site, value)``."""
    return _Collective("psum", site, value)


def _lockstep(bodies):
    """Run the ``ndev`` shard generators in lockstep, as ``shard_map``
    does: step all to their next collective, check they reached the same
    site, perform it, hand each shard its part.  Returns the bodies'
    return values in shard order."""
    ndev = len(bodies)
    sends = [None] * ndev
    while True:
        msgs, done = [], []
        for body, send in zip(bodies, sends):
            try:
                msgs.append(body.send(send))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != ndev:
                raise RuntimeError(
                    f"{len(done)} of {ndev} shards finished the program "
                    "while the others wait at a collective")
            return done
        kind, site = msgs[0].kind, msgs[0].site
        for d, m in enumerate(msgs):
            if (m.kind, m.site) != (kind, site):
                raise RuntimeError(
                    f"shard {d} reached {m.kind} {m.site!r} while shard 0 "
                    f"is at {kind} {site!r}")
        stacked = torch.stack([m.value for m in msgs])
        if _cost.ACTIVE is not None:
            # one collective of the SPMD program, at one shard's bytes
            _cost.collective("all-to-all" if kind == "all_to_all"
                             else "all-reduce", msgs[0].value.nbytes)
        if kind == "all_to_all":
            recv = stacked.transpose(0, 1)       # (dst, src, cap, ar)
            sends = [recv[d] for d in range(ndev)]
        elif kind == "psum":
            total = stacked.sum(0)
            sends = [total] * ndev
        else:
            raise ValueError(f"unknown collective {kind!r}")


# ---------------------------------------------------------------------------
# fixed-capacity bucket exchange
# ---------------------------------------------------------------------------
def _stable_order(keys):
    """Stable lexicographic order over ``keys`` (last key primary, as
    ``jnp.lexsort``)."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _route_to_buckets(rows, target, ndev, bucket_cap, sort_cols=None):
    """Scatter rows into per-destination buckets of ``bucket_cap`` rows,
    keeping input order within each bucket (a stable sort by destination).
    PAD rows are discarded; valid rows beyond a destination's capacity are
    counted.  With ``sort_cols`` the order within a bucket is
    lexicographic by those columns instead, so every receiver gets sorted
    runs (see ``_merge_runs``).  Returns ((ndev, bucket_cap, ar) buckets,
    overflow_count)."""
    cap, ar = rows.shape
    pad = pad_of(rows)
    valid = rows[:, 0] != pad
    target = torch.where(valid, target, ndev)       # invalid -> trash
    if sort_cols is None:
        order = torch.argsort(target, stable=True)
    else:
        order = _stable_order([rows[:, c] for c in reversed(sort_cols)]
                              + [target])
    t_sorted = target[order].contiguous()
    rows_sorted = rows[order]
    pos = (torch.arange(cap, device=rows.device)
           - torch.searchsorted(t_sorted, t_sorted, side="left"))
    live = t_sorted < ndev
    overflow = live & (pos >= bucket_cap)
    trash = ndev * bucket_cap
    slot = torch.where(live & ~overflow, t_sorted * bucket_cap + pos, trash)
    buckets = torch.full((trash + 1, ar), pad, dtype=rows.dtype,
                         device=rows.device)
    buckets[slot] = torch.where(live[:, None], rows_sorted, pad)
    return (buckets[:trash].view(ndev, bucket_cap, ar), overflow.sum())


def _exchange(rows, target, ndev, bucket_cap, site, sort_cols=None):
    """Fixed-capacity bucket exchange, as a generator: bucketize, yield the
    all-to-all, and return ((ndev * bucket_cap, ar) received rows,
    dropped_count).  With ``sort_cols`` the received block is ``ndev``
    front-packed sorted runs."""
    buckets, overflow = _route_to_buckets(rows, target, ndev, bucket_cap,
                                          sort_cols=sort_cols)
    recv = yield _Collective("all_to_all", site, buckets)
    return recv.reshape(ndev * bucket_cap, rows.shape[1]), overflow


_MERGE_MAX_WAYS = 4      # ndev**2 pairwise rank probes beat a sort up to here


def _merge_runs(blk, ndev, perm):
    """Merge the ``ndev`` per-source sorted runs of an exchanged block into
    one front-packed block lexsorted in ``perm`` column order.  A rank
    merge: each row's slot is its index within its run plus one
    ``searchsorted`` count against every other run (ties broken by source
    run, so slots are unique), landed with one scatter.  Past
    ``_MERGE_MAX_WAYS`` runs, or for rows too wide to pack, one full
    lexsort."""
    n, ar = blk.shape
    identity = tuple(perm) == tuple(range(ar))
    if ndev == 1:
        return blk
    cap = n // ndev
    pad = pad_of(blk)
    rot = blk if identity else ops.project_core(blk, perm)
    if ndev > _MERGE_MAX_WAYS or ar > 2 or (
            ar == 2 and not ops._pack_ok(blk.dtype)):
        out = ops.lexsort_core(rot)
    else:
        runs = [rot[i * cap:(i + 1) * cap] for i in range(ndev)]
        valids = [blk[i * cap:(i + 1) * cap, 0] != pad for i in range(ndev)]
        iota = torch.arange(cap, device=blk.device)
        keys = ([r[:, 0].contiguous() for r in runs] if ar == 1
                else [ops.pack_rows2(r) for r in runs])
        out = torch.full((n + 1, ar), pad, dtype=blk.dtype,
                         device=blk.device)
        for i, r in enumerate(runs):
            rank = iota
            for j in range(ndev):
                if j == i:
                    continue
                # right for earlier runs, left for later ones: equal rows
                # order by source run, so every slot is unique
                rank = rank + torch.searchsorted(
                    keys[j], keys[i], side="right" if j < i else "left")
            pos = torch.where(valids[i], rank, n)    # PAD rows -> trash
            out[pos] = torch.where(valids[i][:, None], r, pad)
        out = out[:n]
    if identity:
        return out
    inv = [0] * ar
    for i, c in enumerate(perm):
        inv[c] = i
    return ops.project_core(out, inv)


@dataclass(frozen=True)
class DistConfig:
    """Capacity floors for :func:`run_distributed_tc` (the executor plans
    its own per-shard capacities via ``plan._Caps``)."""
    shard_cap: int = 1 << 14         # per-shard store capacity
    delta_cap: int = 1 << 12         # per-shard delta capacity
    bucket_cap: int = 1 << 9         # per-destination exchange bucket
    max_rounds: int = 64


# ---------------------------------------------------------------------------
# overflow labels (the order in which the round emits its flags:
# _walk_rule appends pre / left / right exchange flags, then the
# join-capacity flag, per join step)
# ---------------------------------------------------------------------------
def _rule_ovf_labels(plan, use_pre):
    labels = []
    for j in range(len(plan.atoms)):
        if use_pre and plan.pre is not None and plan.pre[0] == j:
            labels.append(("bucket", (plan.key, "pre", j)))
        if j >= 1:
            labels.append(("bucket", (plan.key, "jl", j)))
            labels.append(("bucket", (plan.key, "jr", j)))
            labels.append(("join", (plan.key, j - 1)))
    return labels


def _round_ovf_labels(active, use_prefilter, derived):
    labels = []
    for plan, _ in active:
        labels += _rule_ovf_labels(plan, use_prefilter)
    for pred in derived:
        labels += [("bucket", ("absorb", pred)),
                   ("delta", pred), ("store", pred)]
    return labels


def _bucket_keys(labels):
    return tuple(name for kind, name in labels if kind == "bucket")


# ---------------------------------------------------------------------------
# sharded round program
# ---------------------------------------------------------------------------
def _dist_signature(ndev, preds, caps, active, delta_in, use_prefilter,
                    layout):
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    labels = _round_ovf_labels(active, use_prefilter, derived)
    return ("dist_round", ndev, preds,
            tuple(caps.store[p] for p in preds),
            tuple((plan.key, jd, tuple(caps.join_cap(plan, i)
                                       for i in range(len(plan.joins))))
                  for plan, jd in active),
            tuple((p, caps.delta_cap(p)) for p in delta_in),
            tuple((p, caps.delta_cap(p)) for p in derived),
            tuple((k, caps.bucket_cap(k)) for k in _bucket_keys(labels)),
            use_prefilter, layout)


def _shards(t, ndev):
    """Per-shard views of a global (ndev * cap, ar) block."""
    return t.view(ndev, -1, t.shape[1]).unbind(0)


def _vec(parts, device):
    """0-d / (k,) integer tensors -> one int64 vector."""
    flat = [p.reshape(-1).to(torch.int64) for p in parts]
    if not flat:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.cat(flat)


def _build_dist_round(ndev, preds, caps, active, delta_in, use_prefilter):
    """One sharded materialization round as a single program.

    Inputs (flat): the per-pred global store blocks (shard-partitioned,
    lexsorted per shard, at planner capacities), the (P * ndev,) int64
    per-shard store counts (pred-major), and the live global delta blocks.
    Outputs (flat): the new stores, the new per-derived-pred deltas, and
    one int64 bundle: new store counts (P * ndev), delta counts (K *
    ndev), the summed fresh totals (K), the trigger total and the summed
    overflow vector.  ``ovf_labels`` names each overflow slot."""
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    ovf_labels = _round_ovf_labels(active, use_prefilter, derived)
    join_caps = {id(plan): tuple(caps.join_cap(plan, i)
                                 for i in range(len(plan.joins)))
                 for plan, _ in active}
    delta_caps = {p: caps.delta_cap(p) for p in derived}
    bucket_caps = {k: caps.bucket_cap(k) for k in _bucket_keys(ovf_labels)}
    n = len(preds)

    def router(plan_key):
        def route(rows, cols, tag):
            key = (plan_key, *tag)
            tgt = _shard_of(_cols_hash(rows, cols), ndev)
            out, dropped = yield from _exchange(rows, tgt, ndev,
                                                bucket_caps[key], key)
            return out, [dropped > 0], None
        return route

    def body(stores, counts, deltas):
        stores, counts = dict(stores), dict(counts)
        dev = next(iter(stores.values())).device
        triggers = torch.zeros((), dtype=torch.int64, device=dev)
        ovfs = []
        heads = {}
        for plan, jd in active:
            inputs = [deltas[bp] if j == jd else stores[bp]
                      for j, bp in enumerate(plan.body_preds)]
            pre_data = stores[plan.head_pred] if use_prefilter else None
            head, trg, flags = yield from _walk_rule(
                plan, inputs, pre_data, join_caps[id(plan)],
                route=router(plan.key))
            triggers = triggers + trg
            ovfs += flags
            heads.setdefault(plan.head_pred, []).append(head)
        out_deltas, out_dcounts, fresh_tot = [], [], []
        for pred in derived:
            hs = heads[pred]
            cat = hs[0] if len(hs) == 1 else torch.cat(hs, dim=0)
            # canonical-home re-partition: duplicates of a tuple (across
            # rules and shards) land on one shard, so dedup and the
            # antijoin against the store are local
            tgt = _shard_of(_tuple_hash(cat), ndev)
            routed, dropped = yield from _exchange(
                cat, tgt, ndev, bucket_caps[("absorb", pred)],
                ("absorb", pred))
            ovfs.append(dropped > 0)
            ns, nc, delta, nf, (od, os_) = _absorb_traced(
                [routed],
                lambda rows, p=pred: ~ops.member_mask_core(rows, stores[p]),
                stores[pred], counts[pred], delta_caps[pred])
            stores[pred] = ns
            counts[pred] = nc
            out_deltas.append(delta)
            out_dcounts.append(nf)
            fresh_tot.append((yield _psum(("fresh", pred), nf)))
            ovfs += [od, os_]
        ovf = _vec(ovfs, dev)
        trg_tot = yield _psum("triggers", triggers)
        if ovfs:
            ovf = yield _psum("overflow", ovf)
        return ([stores[p] for p in preds], [counts[p] for p in preds],
                out_deltas, out_dcounts, fresh_tot, trg_tot, ovf)

    def fn(*xs):
        store_sh = [_shards(x, ndev) for x in xs[:n]]
        cnt = xs[n].view(n, ndev)
        delta_sh = [_shards(x, ndev) for x in xs[n + 1:]]
        outs = _lockstep([
            body(dict(zip(preds, (s[d] for s in store_sh))),
                 dict(zip(preds, cnt[:, d].unbind())),
                 dict(zip(delta_in, (s[d] for s in delta_sh))))
            for d in range(ndev)])
        new_stores = [torch.cat([o[0][i] for o in outs])
                      for i in range(n)]
        new_deltas = [torch.cat([o[2][k] for o in outs])
                      for k in range(len(derived))]
        first = outs[0]
        bundle = _vec([torch.stack([o[1][i] for o in outs])
                       for i in range(n)]
                      + [torch.stack([o[3][k] for o in outs])
                         for k in range(len(derived))]
                      + list(first[4]) + [first[5], first[6]], xs[n].device)
        return (*new_stores, *new_deltas, bundle)

    return fn, ovf_labels, derived


class _RoundProgram:
    """A built round program: ``run`` (torch ops on the CPU, a captured
    graph on the card), its overflow ``labels`` and ``derived`` preds."""

    def __init__(self, fn, labels, derived, device):
        self.run = (_Replay(fn, "dist_round")
                    if device.type == "cuda" else _Eager(fn))
        self.labels = labels
        self.derived = derived

    def close(self):
        close = getattr(self.run, "close", None)
        if close is not None:
            close()


# ---------------------------------------------------------------------------
# linear-tail fixpoint program (a loop over whole sharded rounds)
# ---------------------------------------------------------------------------
def _site_route_tag(plan, jd, use_pre):
    """The exchange tag through which one fixpoint site's DELTA first
    flows (the exchange carried through the loop state), or None when the
    site routes nothing delta-side (a single-atom rule without a usable
    pre-restriction: its heads move only in the absorb exchange)."""
    if use_pre and plan.pre is not None and plan.pre[0] == jd:
        return ("pre", jd)
    if len(plan.atoms) == 1:
        return None
    return ("jl", 1) if jd == 0 else ("jr", jd)


def _site_tags(plan, jd, use_pre):
    """Exchange tags of one fixpoint site (plan with the delta at body
    position ``jd``), in the order ``_walk_rule`` reaches them.  Returns
    ``(carried_tag, [(tag, kind, key_cols)])`` where kind is:

    * ``'carried'`` — the first delta-side exchange: produced at the END
      of the previous iteration from the fresh delta and carried through
      the loop state,
    * ``'static'`` — routes a loop-invariant store input: exchanged once
      per fixpoint attempt, in the prologue,
    * ``'live'`` — routes delta-derived rows mid-chain: stays in the
      iteration."""
    pre_j = plan.pre[0] if (use_pre and plan.pre is not None) else None
    carried = _site_route_tag(plan, jd, use_pre)
    tags = []
    for j in range(len(plan.atoms)):
        if pre_j == j:
            kind = "carried" if ("pre", j) == carried else "static"
            tags.append((("pre", j), kind, plan.pre[1]))
        if j >= 1:
            lk, rk, _ = plan.joins[j - 1]
            if ("jl", j) == carried:
                kind = "carried"
            elif j == 1 and jd >= 1 and pre_j != 0:
                kind = "static"        # left side of join 1 is a store
            else:
                kind = "live"
            tags.append((("jl", j), kind, (lk,)))
            if ("jr", j) == carried:
                kind = "carried"
            elif j != jd and pre_j != j:
                kind = "static"        # right side is an unfiltered store
            else:
                kind = "live"
            tags.append((("jr", j), kind, (rk,)))
    return carried, tags


def _fix_ovf_labels(active, use_pre, derived):
    """Overflow labels of the fixpoint program in its three emission
    groups: *body* (in-iteration flags in emission order: live exchanges
    and join caps per site, then absorb bucket / delta / tail per derived
    pred), *production* (the carried exchanges, one per site that has
    one) and *static* (the prologue's store-side exchanges).  The
    program's overflow vector is body ++ production ++ static."""
    body, production, static = [], [], []
    for plan, jd in active:
        _, tags = _site_tags(plan, jd, use_pre)
        for tag, kind, _cols in tags:
            label = ("bucket", (plan.key, *tag))
            {"live": body, "carried": production,
             "static": static}[kind].append(label)
            if tag[0] == "jr":
                body.append(("join", (plan.key, tag[1] - 1)))
    for pred in derived:
        body += [("bucket", ("absorb", pred)), ("delta", pred),
                 ("tail", pred)]
    return body, production, static


def _dist_fix_signature(ndev, s_preds, o_preds, caps, active,
                        use_prefilter, max_rounds, layout):
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    body, prod, static = _fix_ovf_labels(active, use_prefilter, derived)
    bkeys = tuple(name for kind, name in body + prod + static
                  if kind == "bucket")
    return ("dist_fix", ndev, s_preds, o_preds,
            tuple(caps.store[p] for p in s_preds + o_preds),
            tuple(caps.delta_cap(p) for p in s_preds),
            tuple(caps.tail_cap(p) for p in s_preds),
            tuple((plan.key, jd, tuple(caps.join_cap(plan, i)
                                       for i in range(len(plan.joins))))
                  for plan, jd in active),
            tuple((k, caps.bucket_cap(k)) for k in bkeys),
            use_prefilter, max_rounds, layout)


def _build_dist_fixpoint(ndev, s_preds, o_preds, caps, active,
                         use_prefilter, max_rounds):
    """The remaining (linear) fixpoint as a prologue and a loop.

    ``prologue(*s_datas, *d_datas, *o_datas, rounds0)`` runs once per
    fixpoint attempt: it exchanges the loop-invariant store-side inputs
    (sorted, so the chain skips its keysort) and the entry deltas' first
    exchange, and returns ``(*static_blocks, *carried_blocks, scal0)``.

    The loop: constants ``(*base stores, *other stores, *static_blocks)``;
    state ``(*tails, *deltas, *carried_blocks, scal)`` with ``scal`` =
    [tail counts (S * ndev), delta counts (S * ndev), rounds, triggers,
    derived, live, steps, overflow flags]; ``step(consts, state)`` is one
    iteration and ``cond(scal)`` the loop condition.  An iteration is a
    whole sharded round: the rule walks (carried and static routes come
    from the state and the constants, live routes exchange in place), the
    sorted absorb exchange, the absorb into the per-shard tails (probing
    phase-entry store | tail), and the carried exchange of the fresh delta
    for the next iteration.  An overflow keeps the last good state; an
    iteration entered while ``cond`` is false (on the card the loop body
    runs once before its condition is read) changes nothing but
    ``steps``."""
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    body_labels, prod_labels, static_labels = _fix_ovf_labels(
        active, use_prefilter, derived)
    ovf_labels = body_labels + prod_labels + static_labels
    n_body, n_static = len(body_labels), len(static_labels)
    sites = []
    carried_slot = {}                  # site index -> carried state slot
    site_cols = {}                     # site index -> carried key cols
    site_skey = {}                     # site index -> carried sort key
    for plan, jd in active:
        carried, tags = _site_tags(plan, jd, use_prefilter)
        si = len(sites)
        if carried is not None:
            carried_slot[si] = len(carried_slot)
            cols = next(c for t, _k, c in tags if t == carried)
            site_cols[si] = cols
            # join-side blocks are sorted by the join key as they are
            # produced; pre-restriction blocks are probed, not joined
            site_skey[si] = cols[0] if carried[0] != "pre" else None
        sites.append((plan, jd, carried, tags))
    static_keys = list(dict.fromkeys(
        (id(plan), tag) for plan, jd, _c, tags in sites
        for tag, kind, _cols in tags if kind == "static"))
    join_caps = {id(plan): tuple(caps.join_cap(plan, i)
                                 for i in range(len(plan.joins)))
                 for plan, _ in active}
    delta_caps = {p: caps.delta_cap(p) for p in s_preds}
    tail_caps = {p: caps.tail_cap(p) for p in s_preds}
    bucket_caps = {name: caps.bucket_cap(name)
                   for kind, name in ovf_labels if kind == "bucket"}
    S, n_o, n_c = len(s_preds), len(o_preds), len(carried_slot)
    R = 2 * S * ndev                   # scal: rounds, trg, drv, live, steps
    OV = R + 5                         # scal: overflow flags

    def exch(rows, cols, key, sort=False):
        tgt = _shard_of(_cols_hash(rows, cols), ndev)
        if not sort:
            out, dropped = yield from _exchange(rows, tgt, ndev,
                                                bucket_caps[key], key)
            return out, dropped > 0
        # sorted exchange: the sender sorts each bucket by (cols, rest),
        # the receiver merges the ndev runs, and the merged block is sorted
        # by cols[0] (the join's sort-key contract)
        perm = tuple(cols) + tuple(c for c in range(rows.shape[1])
                                   if c not in cols)
        out, dropped = yield from _exchange(rows, tgt, ndev,
                                            bucket_caps[key], key,
                                            sort_cols=perm)
        return _merge_runs(out, ndev, perm), dropped > 0

    def filt(plan, j, data):
        """Atom-j filters on a raw block (the carried and static routes
        must see the rows the chain would route)."""
        eq, consts = plan.atoms[j]
        if eq or consts:
            mask = ops.filter_mask_core(data, eq, consts)
            data = ops.compact_core(data, mask, data.shape[0])
        return data

    def produce_carried(si, plan, jd, carried, fresh_delta):
        return (yield from exch(filt(plan, jd, fresh_delta), site_cols[si],
                                (plan.key, *carried),
                                sort=site_skey[si] is not None))

    def prologue_shard(others, deltas0):
        static_routed, static_flags = {}, []
        for plan, jd, carried, tags in sites:
            for tag, kind, cols in tags:
                if kind != "static":
                    continue
                src_j = 0 if tag[0] == "jl" else tag[1]
                blk, flag = yield from exch(
                    filt(plan, src_j, others[plan.body_preds[src_j]]),
                    cols, (plan.key, *tag), sort=tag[0] != "pre")
                static_routed[(id(plan), tag)] = blk
                static_flags.append(flag)
        carried0, prod_flags = [], []
        for si, (plan, jd, carried, tags) in enumerate(sites):
            if carried is None:
                continue
            blk, flag = yield from produce_carried(
                si, plan, jd, carried, deltas0[plan.body_preds[jd]])
            carried0.append(blk)
            prod_flags.append(flag)
        init_flags = prod_flags + static_flags
        dev = next(iter(deltas0.values())).device
        ovf0 = _vec(init_flags, dev)
        if init_flags:
            ovf0 = yield _psum("init_overflow", ovf0)
        d_counts0 = [(deltas0[p][:, 0] != pad_of(deltas0[p])).sum()
                     for p in s_preds]
        live0 = yield _psum("live", sum(d_counts0))
        return ([static_routed[k] for k in static_keys], carried0, ovf0,
                d_counts0, live0)

    def prologue(*xs):
        s_sh = [_shards(x, ndev) for x in xs[:S]]
        d_sh = [_shards(x, ndev) for x in xs[S:2 * S]]
        o_sh = [_shards(x, ndev) for x in xs[2 * S:2 * S + n_o]]
        rounds0 = xs[-1]
        del s_sh        # the base stores enter the loop, not the prologue
        outs = _lockstep([
            prologue_shard(dict(zip(o_preds, (s[d] for s in o_sh))),
                           dict(zip(s_preds, (s[d] for s in d_sh))))
            for d in range(ndev)])
        statics = [torch.cat([o[0][k] for o in outs])
                   for k in range(len(static_keys))]
        carried = [torch.cat([o[1][k] for o in outs]) for k in range(n_c)]
        _, _, ovf0, _, live0 = outs[0]
        zero = torch.zeros(1, dtype=torch.int64, device=rounds0.device)
        scal0 = _vec([torch.zeros(S * ndev, dtype=torch.int64,
                                  device=rounds0.device)]
                     + [torch.stack([o[3][i] for o in outs])
                        for i in range(S)]
                     + [rounds0, zero, zero, live0, zero,
                        torch.zeros(n_body, dtype=torch.int64,
                                    device=rounds0.device), ovf0],
                     rounds0.device)
        return (*statics, *carried, scal0)

    def iteration_shard(base, others, statics, tails, wcnt, deltas, dcnt,
                        carried_blks):
        dev = wcnt[s_preds[0]].device

        def not_seen(rows, pred, cols=None):
            """keep-mask: rows whose (projected) tuple is in neither the
            phase-entry store shard nor the tail shard of ``pred`` (rows
            were routed by that tuple's hash, so the canonical-home shard
            answers membership locally)."""
            sel = rows if cols is None else ops.project_core(rows, cols)
            seen = (ops.member_mask_core(sel, base[pred])
                    | ops.member_mask_core(sel, tails[pred]))
            return (rows[:, 0] != pad_of(rows)) & ~seen

        triggers = torch.zeros((), dtype=torch.int64, device=dev)
        ovfs = []
        heads = {}
        for si, (plan, jd, carried, tags) in enumerate(sites):
            def route(rows, cols, tag, _plan=plan, _carried=carried,
                      _si=si):
                if tag == _carried:
                    return (carried_blks[carried_slot[_si]], [],
                            site_skey[_si])
                hit = statics.get((id(_plan), tag))
                if hit is not None:
                    return hit, [], (cols[0] if tag[0] != "pre" else None)
                # live tags are always join sides (_site_tags never marks
                # a pre tag live): the sorted exchange spares the keysort
                out, flag = yield from exch(rows, cols, (_plan.key, *tag),
                                            sort=True)
                return out, [flag], cols[0]

            inputs = [deltas[bp] if j == jd else others[bp]
                      for j, bp in enumerate(plan.body_preds)]
            pf = ((lambda rows, cols, p=plan.head_pred:
                   not_seen(rows, p, cols))
                  if use_prefilter and plan.pre is not None else None)
            head, t, flags = yield from _walk_rule(
                plan, inputs, None, join_caps[id(plan)], prefilter=pf,
                route=route)
            triggers = triggers + t
            ovfs += flags
            heads.setdefault(plan.head_pred, []).append(head)
        new_w, new_wc, new_d, new_dc = {}, {}, {}, {}
        for pred in s_preds:
            if pred in heads:
                hs = heads[pred]
                cat = hs[0] if len(hs) == 1 else torch.cat(hs, dim=0)
                tgt = _shard_of(_tuple_hash(cat), ndev)
                # full-lex sorted exchange: the absorb's lexsort becomes
                # the run merge (presorted below)
                lex = tuple(range(cat.shape[1]))
                routed, dropped = yield from _exchange(
                    cat, tgt, ndev, bucket_caps[("absorb", pred)],
                    ("absorb", pred), sort_cols=lex)
                routed = _merge_runs(routed, ndev, lex)
                ovfs.append(dropped > 0)
                nw, nc, delta, nf, (od, ow) = _absorb_traced(
                    [routed], lambda rows, p=pred: not_seen(rows, p),
                    tails[pred], wcnt[pred], delta_caps[pred],
                    presorted=True)
                new_w[pred], new_wc[pred] = nw, nc
                new_d[pred], new_dc[pred] = delta, nf
                ovfs += [od, ow]
            else:           # in S but not derived by any site: drains
                new_w[pred] = tails[pred]
                new_wc[pred] = wcnt[pred]
                new_d[pred] = torch.full_like(deltas[pred],
                                              pad_of(deltas[pred]))
                new_dc[pred] = torch.zeros((), dtype=torch.int64,
                                           device=dev)
        # the carried exchange for the next iteration: it depends on the
        # fresh deltas only, not on the tail merges above
        new_carried = []
        for si, (plan, jd, carried, tags) in enumerate(sites):
            if carried is None:
                continue
            blk, flag = yield from produce_carried(
                si, plan, jd, carried, new_d[plan.body_preds[jd]])
            new_carried.append(blk)
            ovfs.append(flag)
        ovf = _vec(ovfs, dev)
        if ovfs:
            ovf = yield _psum("overflow", ovf)
        fresh_tot = yield _psum("fresh", sum(new_dc[p] for p in s_preds))
        trg_tot = yield _psum("triggers", triggers)
        return (new_w, new_wc, new_d, new_dc, new_carried, ovf, fresh_tot,
                trg_tot)

    def step(consts, state):
        base_sh = [_shards(x, ndev) for x in consts[:S]]
        o_sh = [_shards(x, ndev) for x in consts[S:S + n_o]]
        st_sh = [_shards(x, ndev) for x in consts[S + n_o:]]
        w_datas, d_datas = state[:S], state[S:2 * S]
        c_datas, scal = state[2 * S:2 * S + n_c], state[-1]
        w_sh = [_shards(x, ndev) for x in w_datas]
        d_sh = [_shards(x, ndev) for x in d_datas]
        c_sh = [_shards(x, ndev) for x in c_datas]
        wc = scal[:S * ndev].view(S, ndev)
        dc = scal[S * ndev:R].view(S, ndev)
        outs = _lockstep([
            iteration_shard(
                dict(zip(s_preds, (s[d] for s in base_sh))),
                dict(zip(o_preds, (s[d] for s in o_sh))),
                dict(zip(static_keys, (s[d] for s in st_sh))),
                dict(zip(s_preds, (s[d] for s in w_sh))),
                dict(zip(s_preds, wc[:, d].unbind())),
                dict(zip(s_preds, (s[d] for s in d_sh))),
                dict(zip(s_preds, dc[:, d].unbind())),
                [s[d] for s in c_sh])
            for d in range(ndev)])
        new_w = [torch.cat([o[0][p] for o in outs]) for p in s_preds]
        new_d = [torch.cat([o[2][p] for o in outs]) for p in s_preds]
        new_c = [torch.cat([o[4][k] for o in outs]) for k in range(n_c)]
        _, _, _, _, _, ovf, fresh_tot, trg_tot = outs[0]
        ovf = torch.cat([ovf, torch.zeros(n_static, dtype=torch.int64,
                                          device=scal.device)])
        entered = cond(scal)
        bad = (ovf > 0).any() | ~entered
        good = (~bad).to(torch.int64)
        rounds, trg, drv, live, steps = scal[R:OV].unbind()
        counts = torch.where(bad, scal[:R], _vec(
            [torch.stack([o[1][p] for o in outs]) for p in s_preds]
            + [torch.stack([o[3][p] for o in outs]) for p in s_preds],
            scal.device))
        tally = torch.stack([rounds + good, trg + good * trg_tot,
                             drv + good * fresh_tot,
                             torch.where(bad, live, fresh_tot), steps + 1])
        new_ovf = torch.where(entered, ovf, scal[OV:])
        return (*_select_state(bad, w_datas, new_w),
                *_select_state(bad, d_datas, new_d),
                *_select_state(bad, c_datas, new_c),
                torch.cat([counts, tally, new_ovf]))

    def cond(scal):
        live = scal[R + 3] > 0
        ok = ~(scal[OV:] != 0).any()
        return live & ok & (scal[R] < max_rounds)

    return prologue, step, cond, ovf_labels, tail_caps, len(static_keys)


class _FixProgram:
    """A built fixpoint program: the prologue (torch ops on the CPU, a
    captured graph on the card), the loop (the host loop on the CPU, the
    device loop on the card), the overflow ``labels``, the tail caps and
    the number of static blocks the prologue returns first."""

    def __init__(self, built, device):
        (prologue, step, cond, self.labels, self.tail_caps,
         self.n_statics) = built
        if device.type == "cuda":
            self.prologue = _Replay(prologue, "dist_prologue")
            self.loop = _DeviceLoop(step, cond, "dist_fixpoint")
        else:
            self.prologue = _Eager(prologue)
            self.loop = _HostLoop(step, cond)

    def close(self):
        for run in (self.prologue, self.loop):
            close = getattr(run, "close", None)
            if close is not None:
                close()


# ---------------------------------------------------------------------------
# sharded store
# ---------------------------------------------------------------------------
def _partition(rows, ndev):
    """Split lexsorted, set-semantic rows (a (n, ar) tensor) into their
    canonical-home shards: returns (rows ordered by shard — lexsorted
    within each —, their shards, np (ndev,) int32 counts)."""
    tgt = _shard_of(_tuple_hash(rows), ndev)
    order = torch.argsort(tgt, stable=True)
    counts = torch.bincount(tgt, minlength=ndev).cpu().numpy()
    return rows[order], tgt[order], counts.astype(np.int32)


def _place(rows, tgt, counts, ndev, cap, pad):
    """(ndev * cap, ar) block holding each shard's rows at the front of
    its slot, PAD elsewhere."""
    ar = rows.shape[1]
    out = torch.full((ndev * cap + 1, ar), pad, dtype=rows.dtype,
                     device=rows.device)
    if rows.shape[0]:
        start = torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        ).to(rows.device)
        pos = torch.arange(rows.shape[0], device=rows.device) - start[tgt]
        out[tgt * cap + pos] = rows
    return out[:ndev * cap]


def refit_shards(data, ndev, new_cap):
    """Re-pad a (ndev * old_cap, ar) blocked tensor to (ndev * new_cap,
    ar) per shard (capacities only grow, so no valid row is cut)."""
    ar = data.shape[1]
    blk = data.view(ndev, -1, ar)
    keep = min(blk.shape[1], new_cap)
    out = torch.full((ndev, new_cap, ar), pad_of(data), dtype=data.dtype,
                     device=data.device)
    out[:, :keep] = blk[:, :keep]
    return out.view(ndev * new_cap, ar)


class ShardedKB:
    """Hash-partitioned store: per predicate, a global (ndev * store_cap,
    ar) tensor on the KB's device (shard = tuple hash % ndev; each shard's
    valid rows lexsorted) plus per-shard fill counts on the host.  ``fit``
    re-pads every shard when the planner doubles a store capacity."""

    def __init__(self, kb, preds, ndev):
        self.ndev = ndev
        self.arity = {p: kb.rels[p].arity for p in preds}
        self.dtype = {p: kb.rels[p].data.dtype for p in preds}
        self.data = {}               # pred -> (ndev * cap, ar) tensor
        self.counts = {}             # pred -> np (ndev,) int32
        self.per_shard_max = {}
        self._parts = {}
        for p in preds:
            rel = kb.rels[p]
            rows = rel.data
            if rel.count and not rel.is_lexsorted:
                rows = ops.lexsort_core(rows)
            # set semantics on entry
            rows = ops.compact_core(rows, ops.dedup_mask_core(rows),
                                    rows.shape[0])
            n = int((rows[:, 0] != pad_of(rows)).sum()) if rel.count else 0
            parts = _partition(rows[:n], ndev)
            self._parts[p] = parts
            self.counts[p] = parts[2]
            self.per_shard_max[p] = int(parts[2].max(initial=0))

    def pack(self, caps):
        """Place the per-shard rows at the planner's store caps."""
        for p, (rows, tgt, counts) in self._parts.items():
            self.data[p] = _place(rows, tgt, counts, self.ndev,
                                  caps.store[p], pad_value(self.dtype[p]))
        self._parts = {}

    def fit(self, pred, cap):
        """Current store block re-padded per shard to ``cap`` rows."""
        data = self.data[pred]
        if data.shape[0] // self.ndev == cap:
            return data
        return refit_shards(data, self.ndev, cap)

    def to_relations(self, kb):
        """Fold the shards back into lexsorted single-block Relations."""
        for p, data in self.data.items():
            ar = self.arity[p]
            n = int(self.counts[p].sum())
            cap = data.shape[0] // self.ndev
            idx = torch.arange(cap, device=data.device)
            cnt = torch.from_numpy(self.counts[p].astype(np.int64)).to(
                data.device)
            valid = (idx[None, :] < cnt[:, None]).reshape(-1)
            rows = ops.compact_core(data, valid, next_pow2(n))
            if self.ndev > 1 and n:
                rows = ops.lexsort_core(rows)
            kb.rels[p] = Relation(rows, n, lex_order(ar))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def default_ndev(device) -> int:
    """Shards when the caller names none: one, on the card and on the CPU.
    Every shard lives on the KB's one device, so more shards than one add
    launches and exchanges and no parallelism (PERF.md §5), whatever the
    number of local cards; a caller who wants shards names ``ndev``.  Once
    shard *d* is placed on ``cuda:d`` (ROADMAP.md), the default becomes
    one shard per local card, as the reference's ``make_data_mesh()``
    takes every local device."""
    return 1


def _pull(bundle: torch.Tensor) -> list:
    """The one blocking device->host pull of a round attempt or of a
    fixpoint exit."""
    ops.HOST_SYNC_STATS.dist_pulls += 1
    return bundle.cpu().tolist()


def _host_rows(block, ndev, s, count=None):
    """Shard ``s`` of a global block as host rows: the first ``count``
    rows, or (``count`` None) every non-PAD row, in lexsort order."""
    blk = block.view(ndev, -1, block.shape[1])[s].cpu().numpy()
    if count is not None:
        return blk[:count]
    rows = blk[blk[:, 0] != pad_value(blk.dtype)]
    return rows[host_order(rows)]


def materialize_distributed(kb, mode: str = "tg", max_rounds: int = 10_000,
                            ndev: int | None = None,
                            cfg: DistConfig | None = None,
                            spill: bool = True):
    """Sharded materialization of ``kb`` over ``ndev`` shards (default:
    :func:`default_ndev`), all on the KB's device.  ``cfg``, when given,
    floors the planner's per-shard store / delta / bucket capacities.
    Returns MatStats, or None when the program is outside the plannable
    fragment (the caller falls back to the fused / two-phase executors).

    Capacity overflows retry under a ``RetryBudget``; an exhausted budget
    mid-run ``spill``s the remaining rounds to the two-phase executor
    (``spill=False`` re-raises the ``CapacityError``).

    With ``REPRO_CKPT_DIR`` set, every shard's trimmed store and delta rows
    are checkpointed at round and fixpoint-exit boundaries, and a resume
    is elastic: the restored rows re-partition by the full-tuple hash for
    this ``ndev``, whatever executor or shard count wrote them."""
    from repro_torch.engine.materialize import MatStats
    if mode not in ("tg", "tg_noopt"):
        return None
    program = kb.program
    plans = {}
    for rule in program.rules:
        plan = compile_rule_plan(rule, kb.dict)
        if plan is None:
            return None
        plans[id(rule)] = plan

    dev = kb.device
    if ndev is None:
        ndev = default_ndev(dev)
    if ndev < 1:
        raise ValueError(f"ndev={ndev}: need at least one shard")
    preds = tuple(sorted(kb.rels))
    use_prefilter = mode == "tg"
    layout = (dev.type, str(kb.dict.id_dtype),
              tuple(kb.arities[p] for p in preds))
    st = MatStats(mode=mode)
    st.extra.update(dist=True, ndev=ndev)

    # restore BEFORE sharding: maybe_resume rebuilds kb.rels as global
    # relations, and ShardedKB re-partitions them for this ndev
    ck = recovery.EngineCheckpointer(kb, mode, "dist")
    resume = ck.maybe_resume(st)

    skb = ShardedKB(kb, preds, ndev)
    fp = (program_fingerprint((plans[id(r)].key for r in program.rules),
                              sum(kb.rels[p].count for p in preds)),
          "dist", ndev)
    caps = _Caps(fp, {p: (None, skb.per_shard_max[p]) for p in preds},
                 ndev=ndev)
    if ck.caps_state is not None and \
            st.extra.get("resumed_from") == ("dist", ndev):
        # capacity plans are per shard: only a same-ndev sharded run's
        # plan transfers; any other source replans
        caps.adopt(ck.caps_state)
    if cfg is not None:
        for p in preds:
            caps.store[p] = max(caps.store[p], cfg.shard_cap)
        caps._delta_guess = max(caps._delta_guess, cfg.delta_cap)
        caps._bucket_guess = max(caps._bucket_guess, cfg.bucket_cap)
    skb.pack(caps)

    row_bytes = max((np.dtype(kb.dict.id_dtype).itemsize * skb.arity[p]
                     for p in preds), default=8)
    budget = RetryBudget(caps, row_bytes=row_bytes)

    deltas: dict = {}    # pred -> (ndev * delta_cap, ar) tensor, PAD-padded

    def pad_block(rows, p):
        return torch.full((rows, skb.arity[p]), pad_value(skb.dtype[p]),
                          dtype=skb.dtype[p], device=dev)

    def state_fn():
        """Per-shard checkpoint payloads: each shard's trimmed store rows
        and PAD-filtered delta rows; the base facts ride shard 0."""
        shards = [{} for _ in range(ndev)]
        for p in preds:
            for s in range(ndev):
                shards[s][f"store__{p}"] = _host_rows(
                    skb.data[p], ndev, s, int(skb.counts[p][s]))
        for p, d in deltas.items():
            for s in range(ndev):
                shards[s][f"delta__{p}"] = _host_rows(d, ndev, s)
        for p, rel in kb.base.items():
            shards[0][f"base__{p}"] = rel.np_rows()
        return shards

    def fit_delta(pred):
        data = deltas[pred]
        cap = caps.delta_cap(pred)
        if data.shape[0] // ndev == cap:
            return data
        return refit_shards(data, ndev, cap)

    def run_round(active, delta_preds, is_ext=False):
        prefilter = use_prefilter and not is_ext   # no Def. 23 in round 1
        n = len(preds)
        while True:
            sig = _dist_signature(ndev, preds, caps, active, delta_preds,
                                  prefilter, layout)
            prog = _cached_program(sig, lambda: _RoundProgram(
                *_build_dist_round(ndev, preds, caps, active, delta_preds,
                                   prefilter), dev))
            args = [*(skb.fit(p, caps.store[p]) for p in preds),
                    _upload([int(c) for p in preds for c in skb.counts[p]],
                            dev),
                    *(fit_delta(p) for p in delta_preds)]
            outs = prog.run(*args)
            # ONE blocking pull per round attempt, whatever ndev: counts,
            # fresh totals, triggers and the overflow vector
            vals = _pull(outs[-1])
            k = len(prog.derived)
            cnts = np.asarray(vals[:n * ndev], np.int32).reshape(n, ndev)
            at = n * ndev + k * ndev
            fresh, trg, ovf = vals[at:at + k], vals[at + k], vals[at + k + 1:]
            if not any(ovf):
                budget.ok()
                for i, p in enumerate(preds):
                    skb.data[p] = outs[i]
                    skb.counts[p] = cnts[i]
                st.triggers += trg
                new = {}
                for p, d, ft in zip(prog.derived, outs[n:n + k], fresh):
                    st.derived += ft
                    if ft:
                        new[p] = d
                return new
            ops.HOST_SYNC_STATS.dist_retries += 1
            # the failed replay overwrote the outputs the driver may still
            # point at; the inputs it was given are intact
            held = prog.run.held(args)
            for p, d in zip(preds, held[:n]):
                skb.data[p] = d
            for p, d in zip(delta_preds, held[n + 1:]):
                deltas[p] = d
            _drop_program(sig)           # superseded by the doubled plan
            # a rule active at several delta positions repeats its labels;
            # dedupe so a shared capacity doubles once per retry
            budget.overflow(dict.fromkeys(
                l for f, l in zip(ovf, prog.labels) if f))

    def fit_delta_fix(pred):
        """The live delta refit to the planner cap, or an all-PAD block
        for a quiescent S-pred."""
        if pred not in deltas:
            return pad_block(ndev * caps.delta_cap(pred), pred)
        return fit_delta(pred)

    def fold_tails(s_preds_, w_datas, wcnts):
        """Fold the per-shard fixpoint tails into the sharded store (the
        exit path): a sorted merge per shard, growing the store capacity
        when a shard fills.  Tail rows were deduped against store | tail
        on their canonical-home shard, so the sets are disjoint."""
        for p, d, cnts in zip(s_preds_, w_datas, wcnts):
            cnts = np.asarray(cnts, np.int64)
            if not cnts.sum():
                continue
            new_counts = (skb.counts[p] + cnts).astype(np.int32)
            cap = caps.store[p]
            while cap < new_counts.max(initial=0):
                cap *= 2
            caps.store[p] = cap
            tails = _shards(d, ndev)
            stores = _shards(skb.data[p], ndev)
            skb.data[p] = torch.cat([
                ops.merge_core(ops.fit_rows(stores[s], cap), tails[s],
                               int(skb.counts[p][s]), int(cnts[s]))
                for s in range(ndev)])
            skb.counts[p] = new_counts

    def run_fixpoint(live):
        """Finish a linear fixpoint phase in the loop program: one host
        pull per program exit (converged / tail full / capacity retry).
        Returns False when the remaining program is not linear (the caller
        steps one host round instead)."""
        nonlocal deltas
        tail = _linear_tail(int_plans, live)
        if tail is None:
            return False
        s_preds_, active = tail
        o_preds_ = tuple(p for p in preds if p not in s_preds_)
        S = len(s_preds_)
        while True:
            sig = _dist_fix_signature(ndev, s_preds_, o_preds_, caps,
                                      active, use_prefilter, max_rounds,
                                      layout)
            prog = _cached_program(sig, lambda: _FixProgram(
                _build_dist_fixpoint(ndev, s_preds_, o_preds_, caps,
                                     active, use_prefilter, max_rounds),
                dev))
            s_in = [skb.fit(p, caps.store[p]) for p in s_preds_]
            d_in = [fit_delta_fix(p) for p in s_preds_]
            o_in = [skb.fit(p, caps.store[p]) for p in o_preds_]
            pro = prog.prologue(*s_in, *d_in, *o_in,
                                _upload([st.rounds], dev))
            k = prog.n_statics
            statics, carried, scal0 = pro[:k], pro[k:-1], pro[-1]
            tails0 = [pad_block(ndev * prog.tail_caps[p], p)
                      for p in s_preds_]
            enter = bool(deltas) and st.rounds < max_rounds
            out = prog.loop([*s_in, *o_in, *statics],
                            [*tails0, *d_in, *carried, scal0], enter)
            vals = _pull(out[-1])
            ops.HOST_SYNC_STATS.dist_fixpoint_pulls += 1
            R = 2 * S * ndev
            wcnts = np.asarray(vals[:S * ndev], np.int64).reshape(S, ndev)
            dcnts = np.asarray(vals[S * ndev:R], np.int64).reshape(S, ndev)
            rounds, trg, drv, _live, steps = vals[R:R + 5]
            ovf = vals[R + 5:]
            prog.loop.count(steps)
            ops.HOST_SYNC_STATS.dist_fixpoint_iters += rounds - st.rounds
            prev_rounds = st.rounds
            st.rounds = rounds
            st.triggers += trg
            st.derived += drv
            deltas = {p: d for p, d, c in zip(s_preds_, out[S:2 * S], dcnts)
                      if int(c.sum())}
            fold_tails(s_preds_, out[:S], wcnts)
            if st.rounds > prev_rounds:
                budget.ok()     # the loop advanced: real progress
                progressed[0] = True
            ck.boundary(st, state_fn, caps=caps)
            if not any(ovf):
                return True
            # tail-full exits double too: geometric growth bounds the
            # exits of a long phase at O(log facts) cold, and (through the
            # capacity memo) at one warm
            _drop_program(sig)           # superseded by the doubled plan
            budget.overflow(dict.fromkeys(
                l for f, l in zip(ovf, prog.labels) if f))

    progressed = [resume is not None]

    def drive():
        nonlocal deltas
        if resume is not None:
            st.extra["resumed"] = True
            for p, rows in resume.items():
                rows_t = kb._relation(rows).data[:len(rows)]
                part = _partition(rows_t, ndev)
                caps.seed_delta(p, int(part[2].max(initial=0)))
                deltas[p] = _place(*part, ndev, caps.delta_cap(p),
                                   pad_value(skb.dtype[p]))
        else:
            # round 1: extensional rules over B
            ext_active = tuple((plans[id(r)], None)
                               for r in program.extensional_rules())
            if ext_active:
                deltas = run_round(ext_active, (), is_ext=True)
            st.rounds = 1
            progressed[0] = True
            ck.boundary(st, state_fn, caps=caps)

        # fixpoint rounds: linear phases run in the loop program (one pull
        # per phase exit); other stretches step one round program per
        # round from the host
        fixpoint_on = ops.dist_fixpoint_enabled()
        while deltas and st.rounds < max_rounds:
            live = tuple(sorted(deltas))
            if fixpoint_on and run_fixpoint(live):
                continue
            active = tuple((plans[id(r)], j) for r in int_rules
                           for j, a in enumerate(r.body)
                           if a.pred in deltas)
            if not active:
                break
            deltas = run_round(active, live)
            st.rounds += 1
            progressed[0] = True
            ck.boundary(st, state_fn, caps=caps)

    int_rules = program.intensional_rules()
    int_plans = [plans[id(r)] for r in int_rules]
    try:
        drive()
    except CapacityError as e:
        if not spill:
            raise
        if not progressed[0]:
            return None     # cold-start overflow: plain fragment fallback
        # graceful degradation: gather the last-good shards back into the
        # kb and run the remaining rounds on the two-phase executor
        from repro_torch.engine.materialize import _fixpoint_rounds
        skb.to_relations(kb)
        seed = {}
        for p, d in deltas.items():
            rows = np.concatenate([_host_rows(d, ndev, s)
                                   for s in range(ndev)])
            seed[p] = kb._relation(rows[host_order(rows)],
                                   sorted_by=lex_order(skb.arity[p]))
        st.extra["spilled"] = str(e)
        _fixpoint_rounds(kb, st, seed, mode, max_rounds, ck)
        return st

    skb.to_relations(kb)
    caps.memoize()
    ck.final(st, state_fn, caps=caps)
    return st


# ---------------------------------------------------------------------------
# TC entry points (TC is one more Datalog program over the general executor)
# ---------------------------------------------------------------------------
def _tc_program():
    from repro_torch.core.terms import parse_program
    return parse_program("""
        e(X, Y) -> T(X, Y)
        T(X, Y) & e(Y, Z) -> T(X, Z)
    """)


def run_distributed_tc(edges: np.ndarray, ndev: int | None = None,
                       cfg: DistConfig = DistConfig(), device=None):
    """Transitive closure of int (n, 2) ``edges`` over the sharded
    executor; ``cfg``'s capacities floor the planner's.  Returns (t_rows
    (m, 2) int np, count, triggers, rounds)."""
    from repro_torch.core.terms import Atom
    from repro_torch.engine.materialize import EngineKB
    B = [Atom("e", (f"n{int(a)}", f"n{int(b)}")) for a, b in edges]
    kb = EngineKB(_tc_program(), B, device=device)
    st = materialize_distributed(kb, mode="tg", max_rounds=cfg.max_rounds,
                                 ndev=ndev, cfg=cfg)
    rows = np.array(sorted(
        tuple(int(t[1:]) for t in atom.args)
        for atom in kb.decode_facts() if atom.pred == "T"), np.int32)
    return rows, len(rows), st.triggers, st.rounds


def lower_distributed_tc(ndev: int, cfg: DistConfig = DistConfig(),
                         device=None) -> dict:
    """Dry-run entry: count one TG round of the TC program (delta exchange
    + planned join + canonical-home absorb) at ``cfg``'s per-shard
    capacities, for ``ndev`` lockstep shards on one device (the card
    unless the caller names one).  The reference lowers the round on a
    target mesh; the port's sharded executor runs its shards in lockstep
    on one device (shards on several cards are ROADMAP follow-up 5), so it
    takes ``ndev``.

    Returns ``repro_torch.analysis.cost.walk``'s record of the round
    program (its memory included), run once on PAD blocks (the TC round's
    counts depend on shapes alone).
    FLOPs and bytes are the whole one-device program, all ``ndev`` shards;
    the collectives are per shard, as in the reference's per-device
    program: each bucket exchange counts once as an all-to-all of one
    shard's (ndev, bucket_cap, 2) buckets, each psum once as an
    all-reduce."""
    from repro_torch.engine.dictionary import Dictionary
    from repro_torch.engine.relation import resolve_device
    dev = resolve_device(device)
    program = _tc_program()
    dic = Dictionary()
    plans = [compile_rule_plan(r, dic) for r in program.rules]
    preds = ("T", "e")
    caps = _Caps(("dryrun", ndev), {p: (None, 1) for p in preds}, ndev=ndev)
    active = ((plans[1], 0),)                    # T-delta in body position 0
    derived = ("T",)
    labels = _round_ovf_labels(active, True, derived)
    for p in preds:
        caps.store[p] = cfg.shard_cap
    caps.delta["T"] = cfg.delta_cap
    caps.join[(plans[1].key, 0)] = cfg.delta_cap * 4
    for key in _bucket_keys(labels):
        caps.bucket[key] = cfg.bucket_cap
    fn, _, _ = _build_dist_round(ndev, preds, caps, active, ("T",), True)
    pad = pad_value(torch.int32)
    stores = [torch.full((ndev * cfg.shard_cap, 2), pad, dtype=torch.int32,
                         device=dev) for _ in preds]
    counts = torch.zeros(len(preds) * ndev, dtype=torch.int64, device=dev)
    delta = torch.full((ndev * cfg.delta_cap, 2), pad, dtype=torch.int32,
                       device=dev)
    _, rec = _cost.walk(lambda: fn(*stores, counts, delta),
                        (stores, counts, delta))
    return rec
