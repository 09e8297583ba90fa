"""Terms, atoms, rules, programs (paper §3) + a small rule parser.

The port's own copy of ``repro.core.terms`` (the port imports nothing of
``repro``); keep the two in step.

Representation
--------------
* constants: plain python strings (or ints once dictionary-encoded)
* variables: ``Var(name)``
* nulls:     ``Null(id)`` — labelled nulls introduced for existentials
* atom:      ``Atom(pred, args)`` (args: tuple of terms)
* rule:      ``Rule(body, head)`` — single-head (form (1) of the paper);
             existential variables = head vars not occurring in the body.

Rule text syntax (parser):  ``p(X,Y) & q(Y,Z) -> r(X,Z)`` with existentials
written as head variables that don't appear in the body.
Capitalised identifiers are variables; everything else is a constant.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True, order=True)
class Var:
    name: str

    def __repr__(self):
        return f"?{self.name}"


@dataclass(frozen=True, order=True)
class Null:
    nid: int

    def __repr__(self):
        return f"_n{self.nid}"


Term = object   # Var | Null | str/int constant


def is_var(t) -> bool:
    return isinstance(t, Var)


def is_null(t) -> bool:
    return isinstance(t, Null)


def is_const(t) -> bool:
    return not isinstance(t, (Var, Null))


def is_ground(t) -> bool:
    return not isinstance(t, Var)


@dataclass(frozen=True, order=True)
class Atom:
    pred: str
    args: tuple

    def __repr__(self):
        return f"{self.pred}({', '.join(map(str, self.args))})"

    @property
    def arity(self):
        return len(self.args)

    def vars(self):
        return [t for t in self.args if is_var(t)]

    def subst(self, sigma: dict) -> "Atom":
        return Atom(self.pred, tuple(sigma.get(t, t) for t in self.args))


@dataclass(frozen=True)
class Rule:
    body: tuple          # tuple[Atom]
    head: Atom
    name: str = ""

    def __repr__(self):
        b = " & ".join(map(str, self.body))
        return f"[{self.name}] {b} -> {self.head}"

    @property
    def frontier(self):
        """head vars that occur in the body"""
        bv = self.body_vars()
        return [v for v in self.head.vars() if v in bv]

    def body_vars(self):
        out = []
        for a in self.body:
            for v in a.vars():
                if v not in out:
                    out.append(v)
        return out

    @property
    def existentials(self):
        bv = set(self.body_vars())
        out = []
        for v in self.head.vars():
            if v not in bv and v not in out:
                out.append(v)
        return out

    @property
    def is_datalog(self):
        return not self.existentials

    @property
    def is_linear(self):
        return len(self.body) == 1

    def rename_apart(self, suffix: str) -> "Rule":
        sigma = {}
        for v in set(self.body_vars()) | set(self.head.vars()):
            sigma[v] = Var(v.name + suffix)
        return Rule(tuple(a.subst(sigma) for a in self.body),
                    self.head.subst(sigma), self.name)


class Program:
    """A set of rules + EDB/IDB bookkeeping (paper assumes rule bodies are
    homogeneous: all-EDB or all-IDB; ``normalize()`` enforces it)."""

    def __init__(self, rules: Sequence[Rule]):
        self.rules = list(rules)
        for i, r in enumerate(self.rules):
            if not r.name:
                self.rules[i] = Rule(r.body, r.head, f"r{i+1}")
        self.idb = {r.head.pred for r in self.rules}
        self.edb = {a.pred for r in self.rules for a in r.body} - self.idb
        self.arities = {}
        for r in self.rules:
            for a in list(r.body) + [r.head]:
                self.arities.setdefault(a.pred, a.arity)

    def __iter__(self):
        return iter(self.rules)

    def __len__(self):
        return len(self.rules)

    def __repr__(self):
        return "\n".join(map(str, self.rules))

    @property
    def is_datalog(self):
        return all(r.is_datalog for r in self.rules)

    @property
    def is_linear(self):
        return all(r.is_linear for r in self.rules)

    def extensional_rules(self):
        return [r for r in self.rules if all(a.pred in self.edb
                                             for a in r.body)]

    def intensional_rules(self):
        return [r for r in self.rules if any(a.pred in self.idb
                                             for a in r.body)]

    def normalize(self) -> "Program":
        """Ensure every rule body is all-EDB or all-IDB by introducing an IDB
        twin ``P~aux`` for each EDB predicate used in a mixed body."""
        mixed_preds = set()
        for r in self.rules:
            preds = {a.pred for a in r.body}
            if preds & self.edb and preds & self.idb:
                mixed_preds |= (preds & self.edb)
        if not mixed_preds:
            return self
        new_rules = []
        aux = {}
        for p in sorted(mixed_preds):
            ar = self.arities[p]
            vs = tuple(Var(f"U{i}") for i in range(ar))
            aux[p] = f"{p}~aux"
            new_rules.append(Rule((Atom(p, vs),), Atom(aux[p], vs),
                                  f"aux_{p}"))
        for r in self.rules:
            preds = {a.pred for a in r.body}
            if preds & self.edb and preds & self.idb:
                body = tuple(Atom(aux.get(a.pred, a.pred), a.args)
                             if a.pred in aux else a for a in r.body)
                new_rules.append(Rule(body, r.head, r.name))
            else:
                new_rules.append(r)
        return Program(new_rules)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------
_ATOM_RE = re.compile(r"([\w~]+)\s*\(([^)]*)\)")


def _parse_term(tok: str):
    tok = tok.strip()
    if tok and (tok[0].isupper() or tok[0] == "?"):
        return Var(tok.lstrip("?"))
    return tok


def parse_atom(s: str) -> Atom:
    m = _ATOM_RE.match(s.strip())
    if not m:
        raise ValueError(f"bad atom: {s}")
    pred = m.group(1)
    args = tuple(_parse_term(t) for t in m.group(2).split(",") if t.strip()) \
        if m.group(2).strip() else ()
    return Atom(pred, args)


def parse_rule(s: str, name: str = "") -> Rule:
    lhs, rhs = s.split("->")
    body = tuple(parse_atom(a) for a in re.split(r"[&,](?![^()]*\))", lhs)
                 if a.strip())
    rhs = rhs.replace("exists", "").strip()
    if "." in rhs:
        rhs = rhs.split(".", 1)[1]
    head = parse_atom(rhs)
    return Rule(body, head, name)


def parse_program(text: str) -> Program:
    rules = []
    for i, line in enumerate(l for l in text.strip().splitlines()
                             if l.strip() and not l.strip().startswith("#")):
        rules.append(parse_rule(line, f"r{i+1}"))
    return Program(rules)


def example1_program() -> Program:
    """The paper's Example 1 (P1)."""
    return parse_program("""
        r(X, Y) -> R(X, Y)
        R(X, Y) -> T(Y, X, Y)
        T(Y, X, Y) -> R(X, Y)
        r(X, Y) -> exists Z. T(Y, X, Z)
    """)
