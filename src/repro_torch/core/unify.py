"""Homomorphisms, MGUs, CQ containment, instance equivalence (paper §3).

The port's own copy of ``repro.core.unify`` (the port imports nothing of
``repro``); keep the two in step.

* ``homomorphisms(atoms, instance)`` — all homomorphisms from a conjunction of
  atoms into an instance (backtracking with first-argument indexing).
  Constants map to themselves; *frozen nulls* in the query side (treated as
  constants) map to themselves; variables map to ground terms.
* ``instance_hom(I1, I2)`` — a homomorphism between instances (nulls in I1
  may map to any ground term; constants fixed), i.e. I2 |= I1.
* ``cq_contained(q1, q2)`` — CQ containment via the canonical-database
  (freeze) test [Chandra–Merlin].
* ``mgu(atoms)`` — most general unifier of a set of atoms.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Optional

from repro_torch.core.terms import Atom, Var, is_null, is_var


# ---------------------------------------------------------------------------
# instance indexing
# ---------------------------------------------------------------------------
class Index:
    """Per-predicate fact index for join/backtracking."""

    def __init__(self, facts: Iterable[Atom] = ()):
        self.by_pred = defaultdict(list)
        self.facts = set()
        for f in facts:
            self.add(f)

    def add(self, f: Atom) -> bool:
        if f in self.facts:
            return False
        self.facts.add(f)
        self.by_pred[f.pred].append(f)
        return True

    def __contains__(self, f: Atom):
        return f in self.facts

    def __len__(self):
        return len(self.facts)

    def __iter__(self):
        return iter(self.facts)


def _match_atom(pattern: Atom, fact: Atom, sigma: dict) -> Optional[dict]:
    """Extend sigma to map pattern onto fact (pattern may contain vars/nulls;
    nulls on the pattern side are *rigid* unless flex_nulls)."""
    if pattern.pred != fact.pred or pattern.arity != fact.arity:
        return None
    out = dict(sigma)
    for p, f in zip(pattern.args, fact.args):
        if is_var(p):
            if p in out:
                if out[p] != f:
                    return None
            else:
                out[p] = f
        else:
            if p != f:
                return None
    return out


def homomorphisms(atoms, instance, sigma0: Optional[dict] = None,
                  limit: Optional[int] = None):
    """All homomorphisms from ``atoms`` (conjunction, vars flexible) into
    ``instance`` (an Index or iterable of facts)."""
    if not isinstance(instance, Index):
        instance = Index(instance)
    atoms = sorted(atoms, key=lambda a: -sum(1 for t in a.args
                                             if not is_var(t)))
    out = []

    def bt(i, sigma):
        if limit is not None and len(out) >= limit:
            return
        if i == len(atoms):
            out.append(sigma)
            return
        a = atoms[i]
        for f in instance.by_pred.get(a.pred, ()):
            s2 = _match_atom(a, f, sigma)
            if s2 is not None:
                bt(i + 1, s2)

    bt(0, dict(sigma0 or {}))
    return out


def exists_hom(atoms, instance, sigma0=None) -> bool:
    return bool(homomorphisms(atoms, instance, sigma0, limit=1))


# ---------------------------------------------------------------------------
# instance-level homomorphism (nulls flexible)
# ---------------------------------------------------------------------------
def _freeze_nulls_to_vars(atoms):
    """Replace nulls with variables (for instance-hom search)."""
    out = []
    for a in atoms:
        out.append(Atom(a.pred, tuple(
            Var(f"__n{t.nid}") if is_null(t) else t for t in a.args)))
    return out


def instance_hom(I1, I2) -> Optional[dict]:
    """A homomorphism from instance I1 into I2 (maps nulls of I1 to ground
    terms of I2, constants to themselves).  Returns the null mapping or None."""
    q = _freeze_nulls_to_vars(I1)
    homs = homomorphisms(q, I2, limit=1)
    return homs[0] if homs else None


def entails(I2, I1) -> bool:
    """I2 |= I1 (there is a homomorphism I1 -> I2)."""
    return instance_hom(I1, I2) is not None


def equivalent(I1, I2) -> bool:
    return entails(I1, I2) and entails(I2, I1)


# ---------------------------------------------------------------------------
# CQ containment (freeze test)
# ---------------------------------------------------------------------------
def cq_contained(head_vars1, body1, head_vars2, body2) -> bool:
    """Q1 ⊆ Q2 iff the frozen head tuple of Q1 is an answer of Q2 on the
    canonical database of Q1."""
    freeze = {}
    for a in body1:
        for t in a.args:
            if is_var(t) and t not in freeze:
                freeze[t] = f"~f{len(freeze)}_{t.name}"
    canon = [a.subst(freeze) for a in body1]
    target = [freeze.get(v, v) for v in head_vars1]
    sigma0 = {}
    if len(head_vars1) != len(head_vars2):
        return False
    for v2, t in zip(head_vars2, target):
        if is_var(v2):
            if v2 in sigma0 and sigma0[v2] != t:
                return False
            sigma0[v2] = t
        elif v2 != t:
            return False
    return exists_hom(body2, canon, sigma0)


# ---------------------------------------------------------------------------
# MGU
# ---------------------------------------------------------------------------
def mgu(atoms) -> Optional[dict]:
    """Most general unifier of a set of atoms (vars over terms)."""
    atoms = list(atoms)
    if not atoms:
        return {}
    eqs = []
    first = atoms[0]
    for other in atoms[1:]:
        if other.pred != first.pred or other.arity != first.arity:
            return None
        eqs.extend(zip(first.args, other.args))
    sigma = {}

    def walk(t):
        while is_var(t) and t in sigma:
            t = sigma[t]
        return t

    while eqs:
        a, b = eqs.pop()
        a, b = walk(a), walk(b)
        if a == b:
            continue
        if is_var(a):
            sigma[a] = b
        elif is_var(b):
            sigma[b] = a
        else:
            return None
    # path-compress
    def resolve(t):
        seen = set()
        while is_var(t) and t in sigma and t not in seen:
            seen.add(t)
            t = sigma[t]
        return t
    return {v: resolve(v) for v in sigma}
