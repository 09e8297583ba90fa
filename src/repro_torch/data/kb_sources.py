"""KB scenario generators + rule programs for the port's main path.

The port's own copy of the scenarios it runs from ``repro.data.kb_sources``
(the port imports nothing of ``repro``): the LUBM-flavoured university
program ``LUBM_L``, the ChaseBench-style existential scenario, the ρDF
triple scenario, deep-chain TC, and the streamed wide-TC scale scenario.
The generators are identical, so both packages see the same facts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.terms import Atom, parse_program
from repro_torch.engine.relation import id_range, store_dtype


LUBM_L = parse_program("""
    gradStudent(S, D) -> Student(S)
    ugStudent(S, D) -> Student(S)
    fullProf(P, D) -> Professor(P)
    assocProf(P, D) -> Professor(P)
    assistProf(P, D) -> Professor(P)
    Professor(P) -> Faculty(P)
    lecturer(P, D) -> Faculty(P)
    Faculty(P) -> Employee(P)
    Student(S) -> Person(S)
    Employee(P) -> Person(P)
    teaches(P, C) -> Faculty(P)
    takes(S, C) -> Student(S)
    advisor(S, P) -> Professor(P)
    publication(B, P) -> Author(P)
    headOf(P, D) -> Chair(P)
    Chair(P) -> Professor(P)
    subOrg(A, B) & subOrg(B, C) -> SubOrgOf(A, C)
    subOrg(A, B) -> SubOrgOf(A, B)
    SubOrgOf(A, B) & subOrg(B, C) -> SubOrgOf(A, C)
    fullProf(P, D) & SubOrgOf(D, U) -> WorksFor(P, U)
    assocProf(P, D) & SubOrgOf(D, U) -> WorksFor(P, U)
    gradStudent(S, D) & SubOrgOf(D, U) -> MemberOf(S, U)
    ugStudent(S, D) & SubOrgOf(D, U) -> MemberOf(S, U)
    WorksFor(P, U) -> MemberOf(P, U)
    takes(S, C) & teaches(P, C) -> TaughtBy(S, P)
    advisor(S, P) & WorksFor(P, U) -> StudentOfUniv(S, U)
    publication(B, P) & advisor(S, P) -> AdvisorPub(S, B)
""")


def lubm_facts(n_univ: int = 2, seed: int = 0, scale: int = 1):
    """University-domain EDB.  ~(scale * 600) facts per university."""
    rng = np.random.default_rng(seed)
    facts = []
    add = facts.append
    for u in range(n_univ):
        U = f"univ{u}"
        n_dept = 4 * scale
        for d in range(n_dept):
            D = f"dept{u}_{d}"
            add(Atom("subOrg", (D, U)))
            if d % 3 == 0:
                add(Atom("subOrg", (f"group{u}_{d}", D)))
            profs = []
            for p in range(6):
                P = f"prof{u}_{d}_{p}"
                profs.append(P)
                kind = ("fullProf", "assocProf", "assistProf")[p % 3]
                add(Atom(kind, (P, D)))
                if p == 0:
                    add(Atom("headOf", (P, D)))
            for le in range(2):
                add(Atom("lecturer", (f"lect{u}_{d}_{le}", D)))
            courses = []
            for c in range(8):
                C = f"course{u}_{d}_{c}"
                courses.append(C)
                add(Atom("teaches", (profs[c % len(profs)], C)))
            students = []
            for s in range(25):
                S = f"stud{u}_{d}_{s}"
                students.append(S)
                kind = "gradStudent" if s % 4 == 0 else "ugStudent"
                add(Atom(kind, (S, D)))
                for c in rng.choice(8, size=3, replace=False):
                    add(Atom("takes", (S, courses[c])))
                if s % 4 == 0:
                    add(Atom("advisor", (S, profs[int(rng.integers(6))])))
            for b in range(10):
                add(Atom("publication",
                         (f"pub{u}_{d}_{b}", profs[int(rng.integers(6))])))
    return facts


CHASEBENCH = parse_program("""
    src1(X, Y) -> exists Z. A(X, Z)
    src2(X, Y) -> B(X, Y)
    A(X, Z) & B(X, Y) -> C(Z, Y)
    C(Z, Y) -> exists W. D(Y, W)
    D(Y, W) & B(X, Y) -> E(X, W)
    E(X, W) -> A(X, W)
    src3(X, Y, Z) -> F(X, Y, Z)
    F(X, Y, Z) & B(X, U) -> G(Y, Z, U)
""")


def chasebench_facts(n: int = 200, seed: int = 1):
    rng = np.random.default_rng(seed)
    facts = []
    dom = [f"o{i}" for i in range(max(8, n // 10))]
    for i in range(n):
        facts.append(Atom("src1", (dom[int(rng.integers(len(dom)))],
                                   dom[int(rng.integers(len(dom)))])))
        facts.append(Atom("src2", (dom[int(rng.integers(len(dom)))],
                                   dom[int(rng.integers(len(dom)))])))
        if i % 3 == 0:
            facts.append(Atom("src3", (dom[int(rng.integers(len(dom)))],
                                       dom[int(rng.integers(len(dom)))],
                                       dom[int(rng.integers(len(dom)))])))
    return list(dict.fromkeys(facts))


RHO_DF = parse_program("""
    sco(A, B) & sco(B, C) -> SCO(A, C)
    sco(A, B) -> SCO(A, B)
    SCO(A, B) & sco(B, C) -> SCO(A, C)
    spo(A, B) & spo(B, C) -> SPO(A, C)
    spo(A, B) -> SPO(A, B)
    SPO(A, B) & spo(B, C) -> SPO(A, C)
    type(X, A) & SCO(A, B) -> Type(X, B)
    type(X, A) -> Type(X, A)
    triple(S, P, O) & SPO(P, Q) -> Triple(S, Q, O)
    triple(S, P, O) -> Triple(S, P, O)
    Triple(S, P, O) & dom(P, A) -> Type(S, A)
    Triple(S, P, O) & range(P, A) -> Type(O, A)
""")


def rho_df_facts(n_classes: int = 40, n_props: int = 15,
                 n_instances: int = 600, seed: int = 2):
    """Random taxonomy (forest) + instance triples (YAGO-ish shape)."""
    rng = np.random.default_rng(seed)
    facts = []
    for c in range(1, n_classes):
        parent = int(rng.integers(0, c))
        facts.append(Atom("sco", (f"C{c}", f"C{parent}")))
    for p in range(1, n_props):
        parent = int(rng.integers(0, p))
        facts.append(Atom("spo", (f"P{p}", f"P{parent}")))
        facts.append(Atom("dom", (f"P{p}", f"C{int(rng.integers(n_classes))}")))
        facts.append(Atom("range", (f"P{p}",
                                    f"C{int(rng.integers(n_classes))}")))
    for i in range(n_instances):
        facts.append(Atom("type", (f"i{i}", f"C{int(rng.integers(n_classes))}")))
        facts.append(Atom("triple", (f"i{int(rng.integers(n_instances))}",
                                     f"P{int(rng.integers(n_props))}",
                                     f"i{int(rng.integers(n_instances))}")))
    return facts


TC = parse_program("""
    e(X, Y) -> T(X, Y)
    T(X, Y) & e(Y, Z) -> T(X, Z)
""")


def tc_chain_facts(n_chain: int = 128, chord_every: int = 8):
    """Deep-chain TC base: an ``n_chain``-edge path plus sparse back-chords
    (``(3i+2, i)`` every ``chord_every`` nodes).  The closure needs
    O(n_chain) rounds — the scenario that separates O(phases) host sync
    from O(rounds)."""
    edges = [(i, i + 1) for i in range(n_chain)] + \
        [(3 * i + 2, i) for i in range(n_chain // chord_every)]
    return [Atom("e", (f"v{a}", f"v{b}")) for a, b in edges]


def _check_node_range(n_nodes: int, dtype) -> np.dtype:
    dt = np.dtype(dtype) if dtype is not None else store_dtype()
    lo, hi = id_range(dt)
    if n_nodes - 1 > hi:
        raise OverflowError(
            f"{n_nodes} nodes exceed the {dt} store id range [0, {hi}]; "
            "use a wider REPRO_STORE_DTYPE")
    return dt


def tc_wide_chunks(n_chains: int, chain_len: int = 4,
                   chunk_rows: int = 1 << 20, dtype=None):
    """Wide-TC base as edge chunks: ``n_chains`` DISJOINT chains of
    ``chain_len`` edges each.  The closure adds exactly
    ``chain_len * (chain_len + 1) / 2`` facts per chain (see
    :func:`tc_wide_total`), so the total fact count scales linearly with
    ``n_chains`` while the fixpoint stays ``chain_len`` rounds deep — the
    regime where sort/merge/probe throughput, not round count, is the
    engine's cost.  Yields ``("e", (n, 2) ndarray)`` chunks of at most
    ``chunk_rows`` rows in the store id dtype."""
    dt = _check_node_range(n_chains * (chain_len + 1), dtype)
    total = n_chains * chain_len
    start = 0
    while start < total:
        stop = min(start + chunk_rows, total)
        idx = np.arange(start, stop, dtype=np.int64)
        chain, off = np.divmod(idx, chain_len)
        src = chain * (chain_len + 1) + off
        yield "e", np.stack([src, src + 1], axis=1).astype(dt)
        start = stop


def tc_wide_total(n_chains: int, chain_len: int = 4) -> int:
    """Total fact count (base edges + closure) of the tc_wide scenario."""
    return n_chains * chain_len + n_chains * chain_len * (chain_len + 1) // 2
