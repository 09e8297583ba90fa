"""Instance-dependent TGs for Datalog (paper §4 construction + §6
optimizations): level-k full EG (Φ^k), minDatalog (Def. 19), the Def. 23
rule-execution strategy, and TGmat (Algorithm 2, Thm. 24).

The port's own copy of ``repro.core.tg_datalog`` (the port imports nothing of
``repro``); keep the two in step.

Scalability notes (symbolic layer): Def. 9 generates every k-compatible
parent combination; we additionally prune nodes whose instance is empty on
the given base (instance-dependent TGs may do this without losing
completeness — an empty node contributes no facts and its descendants are
empty) and apply minDatalog each level, per Algorithm 2 line 5.  The
vectorized engine (repro_torch.engine) coalesces combination nodes per
(rule, delta-position); the semantics is the same union of rule executions.
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, Set

from repro_torch.core.eg import EG, _positional_homs
from repro_torch.core.rewrite import eg_rewriting, rewriting_contained
from repro_torch.core.terms import Atom, Program
from repro_torch.core.unify import Index


class TGmatState:
    def __init__(self, program: Program, base):
        self.program = program.normalize()
        self.eg = EG(self.program)
        self.base_idx = Index(base)
        self.node_facts: Dict[int, Set[Atom]] = {}
        self.node_depth: Dict[int, int] = {}
        self.instance = Index(base)
        self.triggers = 0
        self.rewritings = {}

    def rew(self, v):
        if v not in self.rewritings:
            self.rewritings[v] = eg_rewriting(self.eg, v)
        return self.rewritings[v]


def _eval_node(st: TGmatState, v: int, restrict_to_new: bool = True):
    """Def. 5 evaluation of one node with the Def. 23 execution strategy.

    With ``restrict_to_new`` we (a) pick a body atom whose variables cover
    the head variables and antijoin its facts against the already-derived
    head relation *before* enumerating homomorphisms (step (v)/(vi) of
    Example 22 — this is what reduces the trigger count), and (b) drop
    derived facts already in the global instance (v(B,I) = v(B) \\ I,
    Claim 40)."""
    rule = st.eg.rule_of[v]
    ps = st.eg.parents(v)
    n = len(rule.body)
    if not ps:
        per_atom = [st.base_idx] * n
    else:
        per_atom = []
        for j in range(n):
            u = ps.get(j)
            per_atom.append(Index(st.node_facts.get(u, set()))
                            if u is not None else st.base_idx)

    if restrict_to_new:
        head_vars = [t for t in rule.head.args]
        hv_set = {t for t in head_vars}
        derived = st.instance.by_pred.get(rule.head.pred, ())
        if derived:
            derived_set = set(derived)
            for j in range(n):
                aj = rule.body[j]
                pos_of = {}
                for i, t in enumerate(aj.args):
                    pos_of.setdefault(t, i)
                if all((not hasattr(tv, "name")) or tv in pos_of
                       for tv in hv_set):
                    # antijoin: keep only facts whose induced head tuple is new
                    kept = Index()
                    for f in per_atom[j].by_pred.get(aj.pred, ()):
                        ht = tuple(
                            f.args[pos_of[t]] if t in pos_of else t
                            for t in rule.head.args)
                        if Atom(rule.head.pred, ht) not in derived_set:
                            kept.add(f)
                    per_atom = list(per_atom)
                    per_atom[j] = kept
                    break

    homs = _positional_homs(rule.body, per_atom)
    st.triggers += len(homs)
    facts = set()
    for h in homs:
        f = rule.head.subst(h)
        if restrict_to_new and f in st.instance:
            continue
        facts.add(f)
    return facts


def _expand_level(st: TGmatState, k: int) -> List[int]:
    """Add level-k nodes (paper-depth k): k=1 extensional rules; k>=2 every
    k-compatible combination (Def. 9), deduped by (rule, parent-tuple)."""
    eg = st.eg
    new_nodes = []
    if k == 1:
        for r in st.program.extensional_rules():
            v = eg.add_node(r)
            st.node_depth[v] = 1
            new_nodes.append(v)
        return new_nodes

    # candidate providers per predicate, by depth
    by_pred = defaultdict(list)
    for v in eg.rule_of:
        by_pred[eg.rule_of[v].head.pred].append(v)
    seen_combos = set()
    for r in st.program.intensional_rules():
        options = []
        feasible = True
        for a in r.body:
            if a.pred in st.program.edb:
                options.append([None])          # base-instance position
                continue
            cands = [u for u in by_pred.get(a.pred, [])
                     if st.node_depth[u] < k]
            if not cands:
                feasible = False
                break
            options.append(cands)
        if not feasible:
            continue
        for combo in itertools.product(*options):
            if not any(u is not None and st.node_depth[u] == k - 1
                       for u in combo):
                continue
            key = (r.name, combo)
            if key in seen_combos:
                continue
            seen_combos.add(key)
            v = eg.add_node(r)
            st.node_depth[v] = k
            for j, u in enumerate(combo):
                if u is not None:
                    eg.add_edge(u, j, v)
            new_nodes.append(v)
    return new_nodes


def min_datalog_level(st: TGmatState, new_nodes: List[int]) -> List[int]:
    """Def. 19 applied to the fresh level: remove v if some surviving u with
    depth(u) <= depth(v), same head predicate, and rew(v) ⊆ rew(u)."""
    eg = st.eg
    survivors = []
    old_nodes = [u for u in eg.rule_of if u not in new_nodes]
    for v in new_nodes:
        dominated_by = None
        rv = st.rew(v)
        for u in old_nodes + survivors:
            if u == v or eg.rule_of[u].head.pred != eg.rule_of[v].head.pred:
                continue
            if st.node_depth[u] > st.node_depth[v]:
                continue
            if rewriting_contained(rv, st.rew(u)):
                dominated_by = u
                break
        if dominated_by is None:
            survivors.append(v)
        else:
            eg.remove_node(v)
            st.rewritings.pop(v, None)
            st.node_depth.pop(v, None)
    return survivors


def tgmat(program: Program, base, *, use_min: bool = True,
          use_ruleexec: bool = True, max_rounds: int = 10_000):
    """Algorithm 2.  Returns (instance, eg, stats).

    ``use_min``      — apply minDatalog per level (column 'm')
    ``use_ruleexec`` — Def. 23 new-facts-only restriction (column 'm+r');
                       disabling it still dedupes facts globally at the end of
                       each round (the chase-equivalent 'No opt' baseline
                       keeps per-node instances unfiltered).
    """
    assert program.is_datalog, "TGmat targets Datalog programs"
    st = TGmatState(program, base)
    k = 0
    while k < max_rounds:
        k += 1
        new_nodes = _expand_level(st, k)
        if use_min and k > 1:
            new_nodes = min_datalog_level(st, new_nodes)
        any_new_fact = False
        for v in new_nodes:
            facts = _eval_node(st, v, restrict_to_new=use_ruleexec)
            if not use_ruleexec:
                facts = {f for f in facts if f not in st.instance}
            if facts:
                st.node_facts[v] = facts
                any_new_fact = True
                # running instance (I grows within the round: Def. 23 allows
                # any I ⊆ G(B); GLog executes nodes sequentially, Example 22)
                for f in facts:
                    st.instance.add(f)
            else:
                # instance-dependent pruning: empty nodes are dropped
                st.eg.remove_node(v)
                st.node_depth.pop(v, None)
                st.rewritings.pop(v, None)
        if not any_new_fact:
            break
    stats = {"rounds": k, "triggers": st.triggers,
             **st.eg.stats(),
             "derived": len(st.instance) - len(st.base_idx)}
    return st.instance, st.eg, stats
