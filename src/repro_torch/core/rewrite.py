"""EG-rewritings (paper Def. 17) and characteristic queries.

The port's own copy of ``repro.core.rewrite`` (the port imports nothing of
``repro``); keep the two in step.

The EG-rewriting of a node v unfolds rule(v)'s body backwards through v's
*specific* ancestors (one parent per body position — the guided variant of
XRewrite) until only extensional atoms remain.  Lemma 18: answers of rew(v)
on B = facts of v(B).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.terms import Atom, Rule, is_var
from repro_torch.core.unify import cq_contained, mgu


@dataclass
class CQ:
    head_args: tuple          # terms (vars/consts)
    body: tuple               # tuple[Atom], extensional only when complete

    def __repr__(self):
        b = " & ".join(map(str, self.body))
        return f"Q({', '.join(map(str, self.head_args))}) <- {b}"


def eg_rewriting(eg, v: int, max_atoms: int = 256) -> Optional[CQ]:
    """Def. 17.  Returns None if the rewriting exceeds ``max_atoms`` (guard
    for deep graphs; callers must treat None as 'unknown')."""
    program = eg.program
    counter = itertools.count()

    def fresh_rule(rule: Rule) -> Rule:
        return rule.rename_apart(f"_{next(counter)}")

    rv = fresh_rule(eg.rule_of[v])
    head_args = rv.head.args
    # worklist of (atom, node) — node provides the unfolding rule
    pending: List[Tuple[Atom, Optional[int]]] = []
    done: List[Atom] = []
    sigma_total: Dict = {}

    def push_body(rule: Rule, node: int):
        for j, a in enumerate(rule.body):
            if a.pred in program.edb:
                done.append(a)
            else:
                parent = eg.parents(node).get(j)
                pending.append((a, parent))

    push_body(rv, v)
    while pending:
        if len(done) + len(pending) > max_atoms:
            return None
        alpha, u = pending.pop()
        alpha = alpha.subst(sigma_total)
        if u is None:
            # dangling intensional atom (shouldn't happen in well-formed EGs)
            done.append(alpha)
            continue
        ru = fresh_rule(eg.rule_of[u])
        theta = mgu([ru.head, alpha])
        if theta is None:
            # unsatisfiable unfolding: rewriting denotes the empty query
            return CQ(head_args=tuple(), body=(Atom("__false", ()),))
        sigma_total = {**{k: _apply(theta, t) for k, t in sigma_total.items()},
                       **theta}
        done[:] = [a.subst(theta) for a in done]
        pending[:] = [(a.subst(theta), n) for a, n in pending]
        head_args = tuple(_apply(theta, t) for t in head_args)
        for j, a in enumerate(ru.body):
            a = a.subst(theta)
            if a.pred in program.edb:
                done.append(a)
            else:
                parent = eg.parents(u).get(j)
                pending.append((a, parent))
    return CQ(head_args=head_args, body=tuple(done))


def _apply(theta, t):
    return theta.get(t, t) if is_var(t) else t


def rewriting_contained(q1: CQ, q2: CQ) -> bool:
    """q1 ⊆ q2 via the freeze test."""
    if q1 is None or q2 is None:
        return False
    if any(a.pred == "__false" for a in q1.body):
        return True           # empty query contained in everything
    if any(a.pred == "__false" for a in q2.body):
        return False
    return cq_contained(q1.head_args, q1.body, q2.head_args, q2.body)
