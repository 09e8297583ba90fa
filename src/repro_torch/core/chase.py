"""Breadth-first chase variants (paper §3) with semi-naive evaluation (SNE),
trigger counting and chase-graph tracking.

The port's own copy of ``repro.core.chase`` (the port imports nothing of
``repro``); keep the two in step.

Variants
--------
* ``restricted`` — a trigger is *active* if its head instantiation has no
  extension-homomorphism into the current instance (VLog's variant; for
  Datalog this degenerates to fact membership).
* ``skolem``     — existentials become deterministic skolem nulls keyed by
  (rule, frontier binding); add-if-absent (RDFox/COM variant).
* ``equivalent`` — no applicability checks; fresh nulls per trigger; stops
  when the round output is logically entailed by the previous instance
  (guarantees termination for FES programs; used by tglinear/Thm. 10).
* ``oblivious``  — fresh nulls, no checks, no entailment test (bounded by
  ``max_rounds``; analysis tool only).

The chase is the paper's *baseline* against which TGs are measured; the
trigger count is the hardware-independent work metric of Table 5/8a.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.terms import Null, Program, Rule, Var
from repro_torch.core.unify import Index, entails, exists_hom, homomorphisms


@dataclass
class ChaseResult:
    instance: Index
    rounds: int
    triggers: int
    derived: int
    graph: list = field(default_factory=list)   # (body_facts, rule, fact)
    per_round: list = field(default_factory=list)
    terminated: bool = True

    @property
    def facts(self):
        return set(self.instance.facts)


class _NullFactory:
    def __init__(self):
        self.count = 0
        self.skolem_memo = {}

    def fresh(self) -> Null:
        self.count += 1
        return Null(self.count)

    def skolem(self, rule: Rule, var: Var, frontier_binding: tuple) -> Null:
        key = (rule.name, var.name, frontier_binding)
        if key not in self.skolem_memo:
            self.skolem_memo[key] = self.fresh()
        return self.skolem_memo[key]


def _round_triggers(program: Program, full: Index, delta: set,
                    first_round: bool):
    """Semi-naive trigger enumeration: each trigger must use >= 1 delta fact
    (round 1: all body positions over the base instance)."""
    seen = set()
    for rule in program:
        n = len(rule.body)
        if first_round:
            for h in homomorphisms(rule.body, full):
                key = (rule.name, tuple(sorted(h.items())))
                if key not in seen:
                    seen.add(key)
                    yield rule, h
            continue
        if not delta:
            continue
        delta_idx = Index(delta)
        for j in range(n):
            a_j = rule.body[j]
            for hj in homomorphisms([a_j], delta_idx):
                rest = [rule.body[i] for i in range(n) if i != j]
                for h in homomorphisms(rest, full, sigma0=hj):
                    key = (rule.name, tuple(sorted(h.items())))
                    if key not in seen:
                        seen.add(key)
                        yield rule, h


def chase(program: Program, base, variant: str = "restricted",
          max_rounds: int = 10_000, track_graph: bool = False,
          nulls: Optional[_NullFactory] = None) -> ChaseResult:
    program = program.normalize()
    nf = nulls or _NullFactory()
    inst = Index(base)
    delta = set(inst.facts)
    total_triggers = 0
    derived = 0
    graph = []
    per_round = []
    rounds = 0
    terminated = False

    for k in range(1, max_rounds + 1):
        new_facts = set()
        round_triggers = 0
        for rule, h in _round_triggers(program, inst, delta, k == 1):
            round_triggers += 1
            frontier_binding = tuple(h[v] for v in rule.frontier)
            if variant == "restricted":
                # active? no extension hom of head into inst
                head_inst = rule.head.subst(h)
                if exists_hom([head_inst], inst):
                    continue
                hs = dict(h)
                for z in rule.existentials:
                    hs[z] = nf.fresh()
            elif variant == "skolem":
                hs = dict(h)
                for z in rule.existentials:
                    hs[z] = nf.skolem(rule, z, frontier_binding)
            else:  # equivalent / oblivious
                hs = dict(h)
                for z in rule.existentials:
                    hs[z] = nf.fresh()
            fact = rule.head.subst(hs)
            if fact in inst or fact in new_facts:
                continue
            new_facts.add(fact)
            if track_graph:
                body_facts = tuple(a.subst(h) for a in rule.body)
                graph.append((body_facts, rule, fact))
        total_triggers += round_triggers
        per_round.append((round_triggers, len(new_facts)))
        if variant == "skolem" or variant == "restricted":
            if not new_facts:
                terminated = True
                rounds = k - 1
                break
        elif variant == "equivalent":
            if not new_facts or entails(inst.facts, new_facts):
                terminated = True
                rounds = k - 1
                break
        else:  # oblivious
            if not new_facts:
                terminated = True
                rounds = k - 1
                break
        for f in new_facts:
            inst.add(f)
        derived += len(new_facts)
        delta = new_facts
        rounds = k
    return ChaseResult(instance=inst, rounds=rounds, triggers=total_triggers,
                       derived=derived, graph=graph, per_round=per_round,
                       terminated=terminated)


def certain_answer_bcq(program: Program, base, query_atoms) -> bool:
    """(P,B) |= Q via a terminating chase (restricted) + hom test."""
    res = chase(program, base, variant="restricted")
    return exists_hom(query_atoms, res.instance)
