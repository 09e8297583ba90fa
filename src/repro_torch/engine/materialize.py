"""Two-phase materialization over dictionary-encoded relations on torch
tensors (the port of ``repro.engine.materialize``).

Modes
-----
* ``seminaive`` — the chase baseline (SNE, per-rule redundancy filtering:
  derived facts are deduped against the store right after each rule).
* ``tg``        — TG-guided execution (GLog): per-round nodes are (rule,
  delta-position) groups, executed over parent instances only, with the
  Def. 23 antijoin pre-restriction and redundancy filtering once per round.
* ``tg_noopt``  — ``tg`` without the Def. 23 pre-restriction.
* ``tg_linear`` — reasoning over a precomputed instance-independent TG of
  a linear program (``repro_torch.core.tg_linear``: ``tglinear`` +
  ``min_linear``), each EG node one rule execution over its parent's
  output, with or without cleaning.

Trigger counts = total body instantiations (join output rows / filtered
scan rows), the paper's hardware-independent work metric.

The KB lives on one device.  ``EngineKB`` defaults to ``cuda`` and raises
when no card is present; the caller asks for the CPU with
``device="cpu"``.  With ``REPRO_CKPT_DIR`` set, every round is a durable
checkpoint boundary and a later run resumes from the newest valid one
(``repro_torch.engine.recovery``); ``REPRO_FAULT_SPEC`` faults fire at the
same boundaries.  ``EngineKB.materialize_delta`` maintains a materialized
KB under inserts and deletes (``repro_torch.engine.incremental``).

With ``REPRO_FUSED=1``, the ``tg``/``tg_noopt`` modes route through the
fused round executor (``repro_torch.engine.fused``): each round is one
program, captured as a CUDA graph on the card, and linear-tail fixpoints
run in one device loop.  Programs outside the fused fragment
(existentials, disconnected bodies) run on the two-phase executor below,
as on the reference; ``seminaive`` and ``tg_linear`` are never fused.

With ``backend="dist"`` (or ``REPRO_DIST=1``), ``tg``/``tg_noopt`` route
through the sharded executor (``repro_torch.engine.distributed``): the
stores are hash-partitioned into shards on the KB's device, and each round
runs the shards in lockstep as one program.  Programs outside its fragment
fall back to the fused executor (``REPRO_FUSED=1``), then to the two-phase
executor; ``seminaive`` under ``backend="dist"`` runs two-phase.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.terms import Atom, Program, Rule, Var, is_var
from repro_torch.engine import ops, recovery
from repro_torch.engine.dictionary import Dictionary
from repro_torch.engine.relation import (Relation, host_order, lex_order,
                                         resolve_device)

# ---------------------------------------------------------------------------
# KB container
# ---------------------------------------------------------------------------
class EngineKB:
    def __init__(self, program: Program, base_facts, dtype=None,
                 device=None):
        """``dtype``: store dtype for this KB's dictionary ids and relation
        columns (default: the process ``REPRO_STORE_DTYPE``).  ``device``:
        where the stores live (default ``cuda``; raises if there is none)."""
        self.device = resolve_device(device)
        self.program = program.normalize()
        self.dict = Dictionary(id_dtype=dtype)
        rows = defaultdict(list)
        self.arities = dict(self.program.arities)
        for f in base_facts:
            rows[f.pred].append(f.args)
            self.arities.setdefault(f.pred, f.arity)
        self.rels: Dict[str, Relation] = {}
        # the base (extensional) facts, tracked apart from the derived
        # closure
        self.base: Dict[str, Relation] = {}
        for p, ar in self.arities.items():
            if p in rows:
                rel = self._relation(self._encode_block(rows[p], ar))
                # set semantics: duplicate base facts collapse, and every
                # store relation starts lexsorted (the store invariant)
                self.rels[p] = ops.dedup(rel)
            else:
                self.rels[p] = self._empty(max(ar, 1))
            self.base[p] = self.rels[p]

    def _relation(self, rows: np.ndarray, sorted_by=None) -> Relation:
        return Relation.from_numpy(rows, sorted_by=sorted_by,
                                   dtype=self.dict.id_dtype,
                                   device=self.device)

    def _empty(self, arity: int) -> Relation:
        return Relation.empty(arity, dtype=self.dict.id_dtype,
                              device=self.device)

    def _encode_block(self, fact_args, ar: int) -> np.ndarray:
        """Vectorized encoding of a list of same-arity argument tuples; falls
        back to the per-term loop for unorderable mixed terms."""
        n = len(fact_args)
        if n == 0 or ar == 0:
            return np.zeros((n, ar), self.dict.id_dtype)
        try:
            return self.dict.encode_columns(
                np.array(fact_args, dtype=object))
        except TypeError:
            enc = [self.dict.encode_many(args) for args in fact_args]
            return np.asarray(enc, self.dict.id_dtype).reshape(n, ar)

    # -- streamed ingest ----------------------------------------------------
    def ingest_rows(self, pred: str, rows: np.ndarray) -> None:
        """Fold one chunk of base rows for ``pred`` into the store: encode,
        dedup, antijoin against the store, merge the fresh rows in.

        Each chunk is ATOMIC: the merged store is staged while the old
        relation stays referenced, and the dictionary's growth is rolled
        back if anything in the chunk fails — a malformed chunk raises and
        leaves the dictionary and the store as they were."""
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows.reshape(-1, 1)
        known = self.arities.get(pred)
        if known is not None and len(rows) and rows.shape[1] != known:
            raise ValueError(
                f"ingest chunk for {pred!r} has arity {rows.shape[1]}, "
                f"store expects {known}")
        token = self.dict.mark()
        try:
            enc = self.dict.encode_columns(rows)
            n, ar = enc.shape
            store = self.rels.get(pred)
            if store is None:
                store = self._empty(max(ar, 1))
            staged = store
            if n:
                rel = ops.dedup(self._relation(enc))
                if store.count == 0:
                    staged = rel
                else:
                    fresh = ops.antijoin(rel, store)
                    if fresh.count:
                        staged = ops.merge_union(store, fresh)
        except Exception:
            self.dict.rollback(token)
            raise
        # commit point: dictionary growth and the store swap land together
        self.arities.setdefault(pred, ar)
        self.rels[pred] = staged
        self.base[pred] = staged

    @classmethod
    def from_stream(cls, program: Program, chunks, dtype=None,
                    device=None) -> "EngineKB":
        """Build a KB from an iterable of ``(pred, (n, ar) ndarray)``
        chunks; peak host memory is one chunk."""
        kb = cls(program, (), dtype=dtype, device=device)
        for pred, rows in chunks:
            kb.ingest_rows(pred, rows)
        return kb

    @classmethod
    def from_arrays(cls, program: Program, tables, dtype=None,
                    device=None) -> "EngineKB":
        """Build a KB from ``{pred: (n, ar) ndarray}`` (or an iterable of
        pairs) of term arrays."""
        items = tables.items() if hasattr(tables, "items") else tables
        return cls.from_stream(program, items, dtype=dtype, device=device)

    # -- state carried across packages ----------------------------------------
    @classmethod
    def from_host_state(cls, program: Program, payload: dict,
                        dict_state: dict, device=None) -> "EngineKB":
        """Build a KB from host state in the reference's layout: ``payload``
        maps ``store__<pred>`` / ``base__<pred>`` to (n, ar) encoded row
        arrays (the keys of the reference's ``_host_state``), ``dict_state``
        is a ``Dictionary.state_dict()``.  Rows are put in this engine's
        lexsort order on the host; no sort pass or pull is counted."""
        dtype = np.dtype(dict_state["id_dtype"])
        kb = cls(program, (), dtype=dtype, device=device)
        kb.dict.load_state(dict_state)
        for key, rows in payload.items():
            kind, _, pred = key.partition("__")
            if kind not in ("store", "base"):
                continue
            rows = np.asarray(rows, dtype)
            rel = kb._relation(rows[host_order(rows)],
                               sorted_by=lex_order(rows.shape[1]))
            kb.arities.setdefault(pred, rows.shape[1])
            (kb.rels if kind == "store" else kb.base)[pred] = rel
        return kb

    def host_state(self) -> tuple:
        """(payload, dict_state): the inverse of ``from_host_state``, in
        the layout of a checkpoint without live deltas."""
        return _host_state(self, {})[0], self.dict.state_dict()

    def materialize_delta(self, insertions=(), deletions=(), **kw):
        """Incrementally maintain an already-materialized store: see
        :func:`repro_torch.engine.incremental.materialize_delta`."""
        from repro_torch.engine.incremental import materialize_delta
        return materialize_delta(self, insertions=insertions,
                                 deletions=deletions, **kw)

    def insert_facts(self, facts, **kw):
        return self.materialize_delta(insertions=facts, **kw)

    def delete_facts(self, facts, **kw):
        return self.materialize_delta(deletions=facts, **kw)

    def decode_facts(self):
        out = set()
        for p, rel in self.rels.items():
            ar = self.arities[p]
            for row in rel.np_rows():
                out.add(Atom(p, tuple(self.dict.decode(int(x))
                                      for x in row[:ar])))
        return out

    def num_facts(self):
        return sum(r.count for r in self.rels.values())


# ---------------------------------------------------------------------------
# rule plan execution
# ---------------------------------------------------------------------------
def _atom_filters(atom: Atom, dic: Dictionary):
    """(eq_pairs, const_pairs, var->col) for a single atom scan."""
    eq, consts, var_col = [], [], {}
    for i, t in enumerate(atom.args):
        if is_var(t):
            if t in var_col:
                eq.append((var_col[t], i))
            else:
                var_col[t] = i
        else:
            consts.append((i, dic.encode(t)))
    return tuple(eq), tuple(consts), var_col


def execute_rule(kb: EngineKB, rule: Rule, inputs: List[Relation],
                 prefilter: Optional[Relation] = None,
                 prefilter_mode: str = "anti"):
    """Evaluate the body over per-atom input relations.  Returns
    (head_rel (n, head_arity), triggers).

    ``prefilter``: Def. 23 — a relation of already-derived head tuples; if
    some body atom's variables cover the head variables, that atom's input is
    antijoined against it before the join.  ``prefilter_mode="semi"``
    inverts the restriction (keep only rows whose projected head tuple IS in
    ``prefilter``)."""
    dic = kb.dict

    # Def. 23 pre-restriction: if some body atom's columns determine the full
    # head tuple, antijoin that atom's input against the derived head facts.
    pre_j = None
    if prefilter is not None and prefilter.count > 0:
        for j, a in enumerate(rule.body):
            _, _, vc = _atom_filters(a, dic)
            if rule.head.args and all(is_var(t) and t in vc
                                      for t in rule.head.args):
                pre_j = (j, tuple(vc[t] for t in rule.head.args))
                break

    cur = None
    var_col: Dict[Var, int] = {}
    for j, atom in enumerate(rule.body):
        eq, consts, vc = _atom_filters(atom, dic)
        rel = ops.filter_rows(inputs[j], eq, consts)
        if pre_j is not None and pre_j[0] == j:
            rel = (ops.semijoin(rel, prefilter, cols=pre_j[1])
                   if prefilter_mode == "semi"
                   else ops.antijoin(rel, prefilter, cols=pre_j[1]))
        if cur is None:
            cur = rel
            var_col = dict(vc)
            continue
        shared = [v for v in vc if v in var_col]
        if not shared:
            joined, _ = ops.cross(cur, rel)
            eq2 = []
        else:
            v0 = shared[0]
            joined, _ = ops.sm_join(cur, rel, var_col[v0], vc[v0])
            # post-join equality for remaining shared vars
            eq2 = [(var_col[v], cur.arity + vc[v]) for v in shared[1:]]
        if eq2:
            joined = ops.filter_rows(joined, tuple(eq2), ())
        new_var_col = dict(var_col)
        for v, c in vc.items():
            if v not in new_var_col:
                new_var_col[v] = cur.arity + c
        var_col = new_var_col
        cur = joined
    triggers = cur.count

    # head projection
    exvars = rule.existentials
    if not exvars:
        spec = [var_col[t] if is_var(t) else None for t in rule.head.args]
        head = ops.project(cur, tuple(c if c is not None else 0
                                      for c in spec))
        if any(c is None for c in spec):
            data = head.data[:head.count].cpu().numpy().copy()
            for i, (t, c) in enumerate(zip(rule.head.args, spec)):
                if c is None:
                    data[:, i] = dic.encode(t)
            head = kb._relation(data)
        return head, triggers

    # skolem existentials (host-side vectorized)
    frontier = [t for t in rule.head.args if is_var(t) and t in var_col]
    fr_cols = [var_col[t] for t in frontier]
    rows = ops.project(cur, tuple(fr_cols or (0,))).data[:cur.count]
    rows = rows.cpu().numpy()
    out = np.zeros((cur.count, len(rule.head.args)), dic.id_dtype)
    fcol = {t: i for i, t in enumerate(frontier)}
    # skolem ids are a function of the frontier tuple, so dictionary lookups
    # only run once per DISTINCT frontier row
    if frontier and cur.count:
        uniq, inv = np.unique(rows[:, :len(frontier)], axis=0,
                              return_inverse=True)
        inv = inv.reshape(-1)
        ftuples = [tuple(int(x) for x in u) for u in uniq]
    else:
        inv = np.zeros(cur.count, np.intp)
        ftuples = [()] * (1 if cur.count else 0)
    for i, t in enumerate(rule.head.args):
        if is_var(t) and t in fcol:
            out[:, i] = rows[:, fcol[t]]
        elif is_var(t):  # existential
            ids = np.fromiter((dic.skolem((rule.name, t.name, ft))
                               for ft in ftuples), dic.id_dtype,
                              len(ftuples))
            out[:, i] = ids[inv]
        else:
            out[:, i] = dic.encode(t)
    return kb._relation(out), triggers


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------
@dataclass
class MatStats:
    rounds: int = 0
    triggers: int = 0
    derived: int = 0
    mode: str = ""
    extra: dict = field(default_factory=dict)


def materialize(kb: EngineKB, mode: str = "tg", max_rounds: int = 10_000,
                tg_eg=None, cleaning: bool = True,
                backend: Optional[str] = None) -> MatStats:
    """mode: seminaive (VLog-like, per-rule filtering) | tg_noopt (TG round-
    level filtering) | tg (tg_noopt + Def. 23 prefilter) | tg_linear
    (reasoning over the precomputed instance-independent TG ``tg_eg`` of a
    linear program, with or without ``cleaning``).

    backend: None (``REPRO_DIST=1`` selects "dist") | "dist" (the sharded
    executor, over ``distributed.default_ndev`` shards) | "local".  The
    sharded executor covers the plannable fragment of ``tg``/``tg_noopt``;
    anything else falls back to the executors below.  ``REPRO_FUSED=1``
    runs ``tg`` / ``tg_noopt`` on the fused executor where the program is
    in its fragment.  ``tg_linear`` returns before ``backend`` and the
    executor flags are read, as on the reference."""
    if mode == "tg_linear":
        return _materialize_tg_linear(kb, tg_eg, cleaning)
    if backend not in (None, "local", "dist"):
        raise ValueError(f"unknown backend {backend!r}")
    if mode not in ("seminaive", "tg", "tg_noopt"):
        raise ValueError(f"unknown mode {mode!r}")
    if backend is None and ops.dist_enabled():
        backend = "dist"
    if backend == "dist" and mode in ("tg", "tg_noopt"):
        from repro_torch.engine.distributed import materialize_distributed
        st = materialize_distributed(kb, mode=mode, max_rounds=max_rounds)
        if st is not None:  # None: outside the plannable fragment
            return st
    if mode in ("tg", "tg_noopt") and ops.fused_enabled():
        from repro_torch.engine.fused import materialize_fused
        st = materialize_fused(kb, mode=mode, max_rounds=max_rounds)
        if st is not None:      # None: outside the fused fragment, fall back
            return st
    per_rule = mode == "seminaive"
    st = MatStats(mode=mode)
    deltas: Dict[str, Relation] = {}

    ck = recovery.EngineCheckpointer(kb, mode, "two-phase")
    resume = ck.maybe_resume(st)
    if resume is not None:
        st.extra["resumed"] = True
        for p, rows in resume.items():
            deltas[p] = kb._relation(rows, sorted_by=lex_order(rows.shape[1]))
    else:
        # round 1: extensional rules over B
        derived_round = defaultdict(list)
        for rule in kb.program.extensional_rules():
            inputs = [kb.rels[a.pred] for a in rule.body]
            head, trg = execute_rule(kb, rule, inputs)
            st.triggers += trg
            if per_rule:
                _absorb(kb, st, rule.head.pred, head, deltas)
            elif head.count:
                derived_round[rule.head.pred].append(head)
        st.rounds = 1
        if not per_rule:
            _absorb_round(kb, st, derived_round, deltas)
        ck.boundary(st, lambda: _host_state(kb, deltas))

    _fixpoint_rounds(kb, st, deltas, mode, max_rounds, ck, per_rule=per_rule)
    return st


def _absorb_round(kb, st, derived_round, collector):
    """Round-level redundancy filtering: each head predicate's outputs of
    the round are concatenated and absorbed once."""
    for pred, rels in derived_round.items():
        acc = None
        for r in rels:
            acc = r if acc is None else ops.union(acc, r, dedupe=False)
        _absorb(kb, st, pred, acc, collector)


def _absorb(kb, st, pred, rel, collector):
    """Dedup + antijoin vs store, merge-append, record delta.

    With the sorted store the delta comes out of ``dedup`` lexsorted, the
    antijoin probes the already-sorted store (no sort pass), and the
    surviving rows — disjoint from the store by construction — are folded
    in with an incremental merge instead of concat + resort."""
    if rel is None or rel.count == 0:
        return
    rel = ops.dedup(rel)
    fresh = ops.antijoin(rel, kb.rels[pred])
    if fresh.count == 0:
        return
    sorted_store = ops.sorted_store_enabled()
    if sorted_store:
        kb.rels[pred] = ops.merge_union(kb.rels[pred], fresh)
    else:
        kb.rels[pred] = ops.union(kb.rels[pred], fresh, dedupe=False)
    st.derived += fresh.count
    if pred in collector:
        # prior deltas for pred are already in the store, so ``fresh`` is
        # disjoint from them too and the merge path applies
        if sorted_store:
            collector[pred] = ops.merge_union(collector[pred], fresh)
        else:
            collector[pred] = ops.union(collector[pred], fresh, dedupe=True)
    else:
        collector[pred] = fresh


def _host_state(kb, deltas):
    """Single-shard checkpoint payload: trimmed host rows, in the engine's
    lexsort order, of every store / live delta / base relation.  Rows are
    read with ``np_rows``, so a save adds no ``count_pulls``."""
    def rows_of(rel):
        rows = rel.np_rows()
        if len(rows) and not rel.is_lexsorted:
            rows = rows[host_order(rows)]
        return rows
    payload = {}
    for p, rel in kb.rels.items():
        payload[f"store__{p}"] = rows_of(rel)
    for p, rel in deltas.items():
        if rel.count:
            payload[f"delta__{p}"] = rows_of(rel)
    for p, rel in kb.base.items():
        payload[f"base__{p}"] = rows_of(rel)
    return [payload]


def _fixpoint_rounds(kb, st, deltas, mode, max_rounds, ck,
                     per_rule: bool = False):
    """Semi-naive fixpoint rounds, continuing from ``st.rounds`` with the
    given live ``deltas`` (pred -> Relation); each committed round is a
    boundary of the checkpointer ``ck``."""
    program = kb.program
    int_rules = list(program.intensional_rules())
    ext_rules = list(program.extensional_rules())

    while deltas and st.rounds < max_rounds:
        derived_round = defaultdict(list)
        new_deltas: Dict[str, Relation] = {}
        # seeds on EDB predicates make extensional rules with a live body
        # atom join the round (empty for a from-scratch run)
        live_ext = [r for r in ext_rules
                    if any(a.pred in deltas for a in r.body)]
        for rule in int_rules + live_ext:
            prefilter = (kb.rels.get(rule.head.pred)
                         if mode == "tg" else None)
            for j, atom in enumerate(rule.body):
                if atom.pred not in deltas:
                    continue
                inputs = [deltas[atom.pred] if i == j else kb.rels[a.pred]
                          for i, a in enumerate(rule.body)]
                head, trg = execute_rule(kb, rule, inputs,
                                         prefilter=prefilter)
                st.triggers += trg
                if per_rule:
                    _absorb(kb, st, rule.head.pred, head, new_deltas)
                elif head.count:
                    derived_round[rule.head.pred].append(head)
        st.rounds += 1
        if not per_rule:
            _absorb_round(kb, st, derived_round, new_deltas)
        deltas = new_deltas
        ck.boundary(st, lambda: _host_state(kb, deltas))
    ck.final(st, lambda: _host_state(kb, deltas))
    return st


def _materialize_tg_linear(kb: EngineKB, eg, cleaning: bool) -> MatStats:
    """Reason over an instance-independent TG (Def. 5) for linear programs:
    each node runs its rule over its parent's output (a root over the base
    store), in topological order; then each head predicate's node outputs
    are absorbed into the store once.  With ``cleaning`` they are deduped
    and antijoined against the store first; without it the store's union
    dedupes and ``derived`` counts the redundant rows too."""
    if eg is None:
        raise AssertionError("mode='tg_linear' needs tg_eg (an EG from "
                             "repro_torch.core.tg_linear)")
    st = MatStats(mode=f"tg_linear[{'w' if cleaning else 'wo'}-cleaning]")
    node_rel: Dict[int, Relation] = {}
    for v in eg.topo_order():
        rule = eg.rule_of[v]
        ps = eg.parents(v)
        src = node_rel[ps[0]] if ps else kb.rels[rule.body[0].pred]
        head, trg = execute_rule(kb, rule, [src])
        st.triggers += trg
        node_rel[v] = head
    st.rounds = eg.graph_depth() + 1
    by_pred = defaultdict(list)
    for v, rel in node_rel.items():
        by_pred[eg.rule_of[v].head.pred].append(rel)
    for pred, rels in by_pred.items():
        acc = rels[0]
        for r in rels[1:]:
            acc = ops.union(acc, r, dedupe=False)
        if cleaning:
            acc = ops.antijoin(ops.dedup(acc), kb.rels[pred])
        st.derived += acc.count
        if cleaning and ops.sorted_store_enabled():
            kb.rels[pred] = ops.merge_union(kb.rels[pred], acc)
        else:
            kb.rels[pred] = ops.union(kb.rels[pred], acc,
                                      dedupe=not cleaning)
    return st
