"""Instance-independent TGs for linear programs (paper §5).

The port's own copy of ``repro.core.tg_linear`` (the port imports nothing of
``repro``); keep the two in step.

* ``canonical_facts(P)`` — H(P): one representative base fact per
  pattern-isomorphism class (set partitions of argument positions) per EDB
  predicate.
* ``tglinear(P)`` — Algorithm 1: chase each canonical fact (equivalent-chase
  variant, Thm. 10), track the chase graph, emit one node per rule execution
  chained along derivations; union across canonical facts with rule-path
  sharing (a trie), which preserves Def. 4's one-parent-per-position shape.
* ``min_linear(G)`` — Defs. 12–14: exhaustively remove nodes dominated via
  *preserving homomorphisms* (nulls shared with ancestor instances are rigid).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from repro_torch.core.chase import chase
from repro_torch.core.eg import EG, evaluate
from repro_torch.core.terms import Atom, Program, Rule, Var, is_null
from repro_torch.core.unify import homomorphisms


# ---------------------------------------------------------------------------
# H(P): canonical facts modulo pattern isomorphism
# ---------------------------------------------------------------------------
def _set_partitions(n: int):
    """All partitions of range(n) (Bell(n) of them) as tuples of block ids."""
    if n == 0:
        yield ()
        return

    def rec(i, assignment, nblocks):
        if i == n:
            yield tuple(assignment)
            return
        for b in range(nblocks + 1):
            assignment.append(b)
            yield from rec(i + 1, assignment, max(nblocks, b + 1))
            assignment.pop()

    yield from rec(0, [], 0)


def canonical_facts(program: Program) -> List[Atom]:
    out = []
    fresh = 0
    for p in sorted(program.edb):
        ar = program.arities[p]
        for part in _set_partitions(ar):
            consts = {}
            args = []
            for b in part:
                if b not in consts:
                    consts[b] = f"c{fresh}"
                    fresh += 1
                args.append(consts[b])
            out.append(Atom(p, tuple(args)))
    return out


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------
def tglinear(program: Program, max_rounds: int = 64) -> EG:
    program = program.normalize()
    assert program.is_linear, "tglinear requires a linear program"
    eg = EG(program)
    trie: Dict[tuple, int] = {}          # rule-path -> node id

    def node_for(path: tuple, rule: Rule, parent_key):
        if path in trie:
            return trie[path]
        nid = eg.add_node(rule)
        trie[path] = nid
        if parent_key is not None:
            eg.add_edge(trie[parent_key], 1 - 1, nid)  # single body atom: j=0
        return nid

    for f in canonical_facts(program):
        res = chase(program, [f], variant="equivalent", track_graph=True,
                    max_rounds=max_rounds)
        # fact -> list of rule-paths of nodes that derived it
        paths_of: Dict[Atom, List[tuple]] = defaultdict(list)
        paths_of[f] = [()]
        # graph edges are recorded in derivation (round) order
        for body_facts, rule, fact in res.graph:
            src = body_facts[0]
            for ppath in paths_of.get(src, []):
                path = ppath + (rule.name,)
                node_for(path, rule, ppath if ppath else None)
                if path not in paths_of[fact]:
                    paths_of[fact].append(path)
        # root nodes: extensional rule executions start chains from f itself
        # (handled above since paths_of[f] = [()], parent_key None)
    return eg


# ---------------------------------------------------------------------------
# minLinear (Defs. 12-14)
# ---------------------------------------------------------------------------
def _preserving_hom_exists(u_facts, v_facts, rigid_nulls) -> bool:
    """Hom from u_facts into v_facts mapping rigid nulls to themselves and
    other nulls anywhere (constants fixed)."""
    qvars = {}
    query = []
    for a in u_facts:
        args = []
        for t in a.args:
            if is_null(t) and t not in rigid_nulls:
                args.append(qvars.setdefault(t, Var(f"__h{t.nid}")))
            else:
                args.append(t)
        query.append(Atom(a.pred, tuple(args)))
    return bool(homomorphisms(query, v_facts, limit=1))


def _dominates(eg: EG, evals, v: int, u: int) -> bool:
    """True if u is dominated by v: preserving hom u({f}) -> v({f}) ∀f."""
    for f, ev in evals.items():
        uf = ev.node_facts.get(u, set())
        vf = ev.node_facts.get(v, set())
        anc = eg.ancestors(u)
        anc_nulls = set()
        for w in anc:
            for a in ev.node_facts.get(w, set()):
                anc_nulls.update(t for t in a.args if is_null(t))
        if not _preserving_hom_exists(uf, vf, anc_nulls):
            return False
    return True


def min_linear(eg: EG) -> EG:
    eg = eg.copy()        # never mutate the caller's TG
    program = eg.program
    H = canonical_facts(program)

    def all_evals():
        return {f: evaluate(eg, [f]) for f in H}

    changed = True
    while changed:
        changed = False
        evals = all_evals()
        nodes = eg.topo_order()
        for u in nodes:
            if u not in eg.rule_of:
                continue
            for v in nodes:
                if v == u or v not in eg.rule_of or u not in eg.rule_of:
                    continue
                if eg.rule_of[v].head.pred != eg.rule_of[u].head.pred:
                    continue
                if u in eg.ancestors(v):
                    continue   # dominator must survive u's removal
                if _dominates(eg, evals, v, u):
                    # redirect u's children to v, then drop u
                    for w in eg.children(u):
                        for j, pu in list(eg.parent[w].items()):
                            if pu == u:
                                del eg.parent[w][j]
                                eg.add_edge(v, j, w)
                    eg.remove_node(u)
                    changed = True
                    break
            if changed:
                break
    return eg
