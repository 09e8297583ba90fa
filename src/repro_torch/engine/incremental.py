"""Incremental maintenance of a materialized KB: ``materialize_delta`` (the
port of ``repro.engine.incremental``).

It maintains an already-materialized :class:`EngineKB` under fact
insertions and deletions without re-materializing; the maintained store
equals a from-scratch materialization of the updated base (up to null
renaming).

Insertions — semi-naive from a seeded delta
-------------------------------------------
Inserted facts are absorbed into the sorted store with an incremental
``merge_union`` and become the FIRST delta of the semi-naive loop: every
rule with a body atom over a live delta predicate re-fires against (delta
at one position, full store elsewhere).  Shallow cascades run two-phase at
delta-sized capacities; when a cascade runs past ``_FUSED_HANDOFF`` rounds
and ``REPRO_FUSED=1`` with the program in the plannable fragment, the live
deltas are handed to the fused executor
(``materialize_fused(initial_deltas=...)``, with lean capacity guesses),
as on the reference.  The sharded executor takes no deltas: under
``REPRO_DIST=1`` a delta call runs on these single-device paths, as on
the reference.

Deletions — DRed (delete and re-derive)
---------------------------------------
1. **Over-deletion**: the deleted facts seed a semi-naive loop through the
   rule bodies over the ORIGINAL store, with the Def. 23 pre-restriction
   *inverted* (``execute_rule(..., prefilter_mode="semi")``): candidate
   body rows are kept only when their projected head tuple IS in the
   store.  Everything reachable from a deleted fact lands in the
   over-deleted set ``O``.
2. **Commit**: ``store -= O`` per predicate via the sorted set-difference
   ``ops.merge_diff`` (membership probes + in-place compaction; the store
   is never re-sorted).
3. **Rescue**: facts in ``O`` that must survive — base facts not
   explicitly retracted (``EngineKB.base``), plus one alternative-
   derivation pass over the post-deletion store restricted to heads in
   ``O``.  Rescued facts re-enter through the insertion path, whose
   propagation re-derives any remaining cascade.

Skolem ids are memoized per (rule, exvar, frontier), so re-derived
existential facts keep their null ids, and the port gives the reference's
ids call for call.

Semantics of one ``materialize_delta(kb, insertions, deletions)`` call:
deletions are applied first, then insertions (a fact in both sets ends up
present).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from repro_torch.engine import ops
from repro_torch.engine.materialize import MatStats, execute_rule
from repro_torch.engine.relation import Relation


def _encode_facts(kb, facts) -> Dict[str, Relation]:
    """Encode ground atoms into per-predicate lexsorted deduped relations on
    ``kb.device``.  Unknown predicates are registered with empty store/base
    relations."""
    rows = defaultdict(list)
    for f in facts:
        if f.pred in kb.arities and f.arity != kb.arities[f.pred]:
            raise ValueError(f"arity mismatch for {f.pred}: got {f.arity}, "
                             f"KB has {kb.arities[f.pred]}")
        rows[f.pred].append(kb.dict.encode_many(f.args))
        if f.pred not in kb.arities:
            kb.arities[f.pred] = f.arity
            kb.rels[f.pred] = kb._empty(max(f.arity, 1))
            kb.base[f.pred] = kb.rels[f.pred]
    out = {}
    for p, rws in rows.items():
        ar = kb.arities[p]
        rel = kb._relation(
            np.asarray(rws, kb.dict.id_dtype).reshape(len(rws), ar))
        out[p] = ops.dedup(rel)
    return out


def _absorb(kb, pred: str, rel: Optional[Relation]) -> Optional[Relation]:
    """Dedup + antijoin ``rel`` against the store and fold the fresh rows in
    (the materializer's absorb).  Returns the fresh delta, or None when
    nothing is new."""
    if rel is None or rel.count == 0:
        return None
    rel = ops.dedup(rel)
    fresh = ops.antijoin(rel, kb.rels[pred])
    if fresh.count == 0:
        return None
    if ops.sorted_store_enabled():
        kb.rels[pred] = ops.merge_union(kb.rels[pred], fresh)
    else:
        kb.rels[pred] = ops.union(kb.rels[pred], fresh, dedupe=False)
    return fresh


def _fold(rels):
    acc = None
    for r in rels:
        acc = r if acc is None else ops.union(acc, r, dedupe=False)
    return acc


def _round_heads(kb, st, deltas, prefilter_of, prefilter_mode="anti"):
    """One semi-naive round over every rule with a body atom in ``deltas``:
    each head predicate's outputs, by predicate (``prefilter_of(rule)`` is
    the Def. 23 relation of that rule, or None)."""
    derived_round = defaultdict(list)
    for rule in kb.program.rules:
        prefilter = prefilter_of(rule)
        for j, atom in enumerate(rule.body):
            if atom.pred not in deltas:
                continue
            inputs = [deltas[atom.pred] if i == j else kb.rels[a.pred]
                      for i, a in enumerate(rule.body)]
            head, trg = execute_rule(kb, rule, inputs, prefilter=prefilter,
                                     prefilter_mode=prefilter_mode)
            st.triggers += trg
            if head.count:
                derived_round[rule.head.pred].append(head)
    st.rounds += 1
    return derived_round


# ---------------------------------------------------------------------------
# insertion side: semi-naive propagation from a seeded delta
# ---------------------------------------------------------------------------
# Small deltas run two-phase on purpose: the two-phase wrappers size their
# buffers to the actual delta, while the fused round programs run at the
# planned capacities.  Only a cascade that runs deep gains from the fused
# executor's device loop, so propagation hands off after this many rounds.
_FUSED_HANDOFF = 3


def _propagate(kb, seeds: Dict[str, Relation], st: MatStats, mode: str,
               max_rounds: int) -> None:
    """Run the semi-naive delta loop from ``seeds`` (already absorbed into
    the store).  Hands deep cascades off to the fused executor."""
    def prefilter_of(rule):
        return kb.rels.get(rule.head.pred) if mode == "tg" else None

    deltas = dict(seeds)
    fused_ok = ops.fused_enabled() and mode in ("tg", "tg_noopt")
    for rounds in range(max_rounds):
        if not deltas:
            break
        if fused_ok and rounds >= _FUSED_HANDOFF:
            from repro_torch.engine.fused import materialize_fused
            from repro_torch.engine.plan import CapacityError
            try:
                fst = materialize_fused(kb, mode=mode,
                                        max_rounds=max_rounds - rounds,
                                        initial_deltas=deltas, spill=False)
            except CapacityError as e:
                # retry budget exhausted before the handoff made progress:
                # stay on the two-phase loop, whose buffers track the
                # actual delta size
                st.extra["spilled"] = str(e)
                fst = None
            if fst is not None:
                st.rounds += fst.rounds
                st.triggers += fst.triggers
                st.derived += fst.derived
                st.extra["propagated"] += fst.derived
                st.extra["fused"] = True
                return
            fused_ok = False    # outside the plannable fragment
        derived_round = _round_heads(kb, st, deltas, prefilter_of)
        new_deltas: Dict[str, Relation] = {}
        for pred, rels in derived_round.items():
            fresh = _absorb(kb, pred, _fold(rels))
            if fresh is not None:
                new_deltas[pred] = fresh
                st.derived += fresh.count
                st.extra["propagated"] += fresh.count
        deltas = new_deltas


# ---------------------------------------------------------------------------
# deletion side: DRed over-deletion + rescue
# ---------------------------------------------------------------------------
def _over_delete(kb, present: Dict[str, Relation], st: MatStats,
                 max_rounds: int) -> Dict[str, Relation]:
    """Close ``present`` (deleted facts actually in the store) under
    "derivable using a deleted fact": semi-naive over the ORIGINAL store
    with the Def. 23 prefilter inverted.  Returns the over-deleted set."""
    def prefilter_of(rule):
        pref = kb.rels.get(rule.head.pred)
        return pref if pref is not None and pref.count else None

    over = dict(present)
    deltas = dict(present)
    for _ in range(max_rounds):
        if not deltas:
            break
        derived_round = _round_heads(kb, st, deltas, prefilter_of, "semi")
        new_deltas: Dict[str, Relation] = {}
        for pred, rels in derived_round.items():
            acc = ops.dedup(_fold(rels))
            # only facts in the store can be over-deleted, and each only once
            acc = ops.semijoin(acc, kb.rels[pred])
            if pred in over:
                acc = ops.antijoin(acc, over[pred])
            if acc.count == 0:
                continue
            over[pred] = (ops.merge_union(over[pred], acc)
                          if pred in over else acc)
            new_deltas[pred] = acc
        deltas = new_deltas
    return over


def _rescue(kb, over: Dict[str, Relation], st: MatStats) \
        -> Dict[str, Relation]:
    """Facts in ``over`` that must come back: base facts not explicitly
    retracted, plus one alternative-derivation pass over the post-deletion
    store (the insertion loop the rescued facts are fed into completes the
    cascade)."""
    rescued: Dict[str, Relation] = {}
    for p, rel in over.items():
        base = kb.base.get(p)
        if base is not None and base.count:
            keep = ops.semijoin(rel, base)
            if keep.count:
                rescued[p] = keep
    derived_round = defaultdict(list)
    for rule in kb.program.rules:
        over_h = over.get(rule.head.pred)
        if over_h is None or over_h.count == 0:
            continue
        inputs = [kb.rels[a.pred] for a in rule.body]
        head, trg = execute_rule(kb, rule, inputs, prefilter=over_h,
                                 prefilter_mode="semi")
        st.triggers += trg
        if head.count:
            derived_round[rule.head.pred].append(head)
    for pred, rels in derived_round.items():
        acc = ops.semijoin(ops.dedup(_fold(rels)), over[pred])
        if acc.count == 0:
            continue
        rescued[pred] = (ops.union(rescued[pred], acc, dedupe=True)
                         if pred in rescued else acc)
    return rescued


def _delete(kb, dels: Dict[str, Relation], st: MatStats,
            max_rounds: int) -> Dict[str, Relation]:
    """DRed deletion: over-delete, commit ``store -= O`` via ``merge_diff``,
    rescue.  Returns the rescued facts (to be re-inserted by the caller)."""
    # requested deletions restricted to facts actually present
    present = {}
    for p, rel in dels.items():
        pr = ops.semijoin(rel, kb.rels[p])
        if pr.count:
            present[p] = pr
    # explicit retraction always leaves the base set (base facts are only
    # protected from OVER-deletion, never from the user's own delete)
    for p, rel in dels.items():
        base = kb.base.get(p)
        if base is not None and base.count:
            kb.base[p] = ops.merge_diff(base, rel)
    if not present:
        return {}
    over = _over_delete(kb, present, st, max_rounds)
    st.extra["over_deleted"] += sum(r.count for r in over.values())
    for p, rel in over.items():
        kb.rels[p] = ops.merge_diff(kb.rels[p], rel)
    rescued = _rescue(kb, over, st)
    st.extra["rescued"] += sum(r.count for r in rescued.values())
    return rescued


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def materialize_delta(kb, insertions=(), deletions=(), mode: str = "tg",
                      max_rounds: int = 10_000) -> MatStats:
    """Incrementally maintain the materialized ``kb`` under a batch of fact
    ``insertions`` and ``deletions`` (ground :class:`Atom` iterables).

    Deletions apply first (DRed over-deletion / rescue), then insertions
    (semi-naive from the seeded delta; handed to the fused executor past
    ``_FUSED_HANDOFF`` rounds under ``REPRO_FUSED=1``) — a fact in both
    batches ends up present.  ``mode`` controls the Def. 23 pre-restriction
    on the insertion side exactly as in ``materialize`` (``tg`` =
    prefiltered)."""
    if mode not in ("seminaive", "tg", "tg_noopt"):
        raise ValueError(f"unknown mode {mode!r}")
    st = MatStats(mode=f"delta[{mode}]")
    st.extra.update(delta=True, over_deleted=0, rescued=0, propagated=0)
    dels = _encode_facts(kb, deletions) if deletions else {}
    ins = _encode_facts(kb, insertions) if insertions else {}
    st.extra["deleted"] = sum(r.count for r in dels.values())
    st.extra["inserted"] = sum(r.count for r in ins.values())

    rescued = _delete(kb, dels, st, max_rounds) if dels else {}

    # inserted facts become base facts by fiat
    for p, rel in ins.items():
        base = kb.base.get(p)
        kb.base[p] = (ops.union(base, rel, dedupe=True)
                      if base is not None and base.count else rel)

    # seed the semi-naive loop with whatever is genuinely new to the store:
    # user insertions plus rescued facts
    seeds: Dict[str, Relation] = {}
    for p in sorted(set(ins) | set(rescued)):
        cand = _fold([r for r in (ins.get(p), rescued.get(p))
                      if r is not None])
        fresh = _absorb(kb, p, cand)
        if fresh is not None:
            seeds[p] = fresh
            st.derived += fresh.count
    if seeds:
        _propagate(kb, seeds, st, mode, max_rounds)
    return st
