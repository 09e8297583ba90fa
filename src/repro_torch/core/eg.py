"""Execution Graphs / Trigger Graphs (paper §4, Defs. 4–6).

The port's own copy of ``repro.core.eg`` (the port imports nothing of
``repro``); keep the two in step.

An EG is an acyclic digraph: nodes are labelled with rules; an intensional
node ``v`` has at most one incoming edge per body position ``j`` (``u ->_j
v``), so different parent combinations yield different nodes (Def. 9).

``evaluate(eg, base)`` implements Def. 5: reasoning guided by the graph —
extensional nodes evaluate their rule over B; intensional nodes evaluate over
the union of their parents' instances, with body atom j restricted to the
j-th parent's facts.  ``G(B) = B ∪ ⋃_v v(B)``.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.chase import _NullFactory, chase
from repro_torch.core.terms import Program, Rule, Var, is_var
from repro_torch.core.unify import Index, entails, homomorphisms


class EG:
    def __init__(self, program: Program):
        self.program = program
        self.rule_of: Dict[int, Rule] = {}
        self.parent: Dict[int, Dict[int, int]] = defaultdict(dict)  # v -> {j: u}
        self._next = 0

    # ---------------- construction ----------------
    def add_node(self, rule: Rule) -> int:
        nid = self._next
        self._next += 1
        self.rule_of[nid] = rule
        return nid

    def add_edge(self, u: int, j: int, v: int):
        assert j not in self.parent[v], "one incoming edge per body position"
        self.parent[v][j] = u

    def remove_node(self, v: int):
        del self.rule_of[v]
        self.parent.pop(v, None)
        for w, ps in self.parent.items():
            for j, u in list(ps.items()):
                if u == v:
                    del ps[j]

    def copy(self) -> "EG":
        out = EG(self.program)
        out.rule_of = dict(self.rule_of)
        out.parent = defaultdict(dict, {v: dict(ps)
                                        for v, ps in self.parent.items()})
        out._next = self._next
        return out

    # ---------------- structure ----------------
    @property
    def nodes(self):
        return list(self.rule_of)

    @property
    def num_edges(self):
        return sum(len(ps) for v, ps in self.parent.items()
                   if v in self.rule_of)

    def parents(self, v: int):
        return self.parent.get(v, {})

    def children(self, v: int):
        out = []
        for w, ps in self.parent.items():
            if w in self.rule_of and v in ps.values():
                out.append(w)
        return out

    def depth(self, v: int, memo=None) -> int:
        memo = memo if memo is not None else {}
        if v in memo:
            return memo[v]
        ps = self.parents(v)
        d = 0 if not ps else 1 + max(self.depth(u, memo) for u in ps.values())
        memo[v] = d
        return d

    def graph_depth(self) -> int:
        memo = {}
        return max((self.depth(v, memo) for v in self.rule_of), default=0)

    def ancestors(self, v: int):
        out = set()
        stack = [v]
        while stack:
            x = stack.pop()
            for u in self.parents(x).values():
                if u not in out:
                    out.add(u)
                    stack.append(u)
        return out

    def topo_order(self):
        memo = {}
        return sorted(self.rule_of, key=lambda v: (self.depth(v, memo), v))

    def stats(self):
        return {"nodes": len(self.rule_of), "edges": self.num_edges,
                "depth": self.graph_depth()}


# ---------------------------------------------------------------------------
# Def. 5 evaluation
# ---------------------------------------------------------------------------
def _positional_homs(body, per_atom_indices):
    """Homomorphisms h from the body s.t. h(body[j]) ∈ per_atom_indices[j]."""
    order = sorted(range(len(body)), key=lambda j: 0)  # keep given order
    out = []

    def bt(i, sigma):
        if i == len(order):
            out.append(sigma)
            return
        j = order[i]
        a = body[j]
        for f in per_atom_indices[j].by_pred.get(a.pred, ()):
            s2 = _match(a, f, sigma)
            if s2 is not None:
                bt(i + 1, s2)

    def _match(pattern, fact, sigma):
        if pattern.arity != fact.arity:
            return None
        o = dict(sigma)
        for p, fv in zip(pattern.args, fact.args):
            if is_var(p):
                if p in o:
                    if o[p] != fv:
                        return None
                else:
                    o[p] = fv
            elif p != fv:
                return None
        return o

    bt(0, {})
    return out


@dataclass
class EvalResult:
    node_facts: Dict[int, set]
    instance: Index
    triggers: int

    @property
    def facts(self):
        return set(self.instance.facts)


def evaluate(eg: EG, base, nulls: Optional[_NullFactory] = None,
             count_triggers: bool = True) -> EvalResult:
    """Reason over base via the EG (Def. 5)."""
    program = eg.program
    nf = nulls or _NullFactory()
    base_idx = Index(base)
    node_facts: Dict[int, set] = {}
    triggers = 0
    for v in eg.topo_order():
        rule = eg.rule_of[v]
        n = len(rule.body)
        ps = eg.parents(v)
        if not ps:
            homs = homomorphisms(rule.body, base_idx)
        else:
            per_atom = []
            for j in range(n):
                u = ps.get(j)
                per_atom.append(Index(node_facts.get(u, set())) if u is not None
                                else base_idx)
            homs = _positional_homs(rule.body, per_atom)
        facts = set()
        for h in homs:
            triggers += 1
            hs = dict(h)
            for z in rule.existentials:
                key = tuple(h.get(x) for x in rule.frontier)
                hs[z] = nf.skolem(rule, Var(f"{z.name}@{v}"), key)
            facts.add(rule.head.subst(hs))
        node_facts[v] = facts
    inst = Index(base_idx.facts)
    for fs in node_facts.values():
        for f in fs:
            inst.add(f)
    return EvalResult(node_facts=node_facts, instance=inst, triggers=triggers)


# ---------------------------------------------------------------------------
# Def. 6 check (test utility): G is a TG for (P,B) iff G(B) answers every BCQ
# like (P,B) — instance hom-equivalence is a sufficient certificate.
# ---------------------------------------------------------------------------
def is_tg_for(eg: EG, program: Program, base, chase_variant="restricted") \
        -> bool:
    g_res = evaluate(eg, base)
    ch = chase(program, base, variant=chase_variant)
    assert ch.terminated
    # soundness: G(B) entailed by chase; completeness: chase entailed by G(B)
    return (entails(ch.facts, g_res.facts)
            and entails(g_res.facts, ch.facts))
