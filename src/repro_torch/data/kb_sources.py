"""KB scenario generators + rule libraries.

The port's own copy of ``repro.data.kb_sources`` (the port imports nothing
of ``repro``); the generators are identical, so both packages see the same
facts.  The original benchmark data (LUBM dumps, DBpedia, Claros, Reactome,
YAGO) is not redistributable; these generators produce scenarios with the
same *shape*: a university-domain generator with the standard LI ⊂ L ⊂ LE
rule-set hierarchy (linear subset, full Datalog, plus transitive/symmetric
extensions), an iBench-style recursive existential scenario (ChaseBench
analogue), a ρDF triple scenario (RDFS analogue), and transitive closure.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.terms import Atom, Program, parse_program
from repro_torch.engine.relation import id_range, store_dtype


# ---------------------------------------------------------------------------
# LUBM-flavoured university scenario
# ---------------------------------------------------------------------------
LUBM_LI = parse_program("""
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
""")

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

LUBM_LE = parse_program("""
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
    takes(S, C) & takes(T, C) -> Classmate(S, T)
    Classmate(S, T) -> Classmate(T, S)
    advisor(S, P) & advisor(T, P) -> Colleague(S, T)
    Colleague(S, T) -> Colleague(T, S)
    Colleague(S, T) & Colleague(T, U) -> Colleague(S, U)
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


# ---------------------------------------------------------------------------
# ChaseBench-style recursive existential scenario (iBench STB/ONT analogue)
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# ρDF (RDFS subset) triple scenario
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# transitive closure — the canonical deep-fixpoint / exchange-heavy scenarios
# ---------------------------------------------------------------------------
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


def tc_random_facts(n_nodes: int = 400, n_edges: int = 1200, seed: int = 3):
    """Wide random-graph TC base: few rounds, large joins and deltas, so
    the per-round exchange/join cost — not the round count — dominates
    (the scenario where sharding the sort/merge work pays off).  Edge
    endpoints are generated at the dictionary's id dtype so the data
    round-trips through the narrow store without a silent upcast."""
    rng = np.random.default_rng(seed)
    edges = np.unique(
        rng.integers(0, n_nodes, (n_edges, 2)).astype(store_dtype()), axis=0)
    return [Atom("e", (f"v{a}", f"v{b}")) for a, b in edges.tolist()]


# ---------------------------------------------------------------------------
# streamed (chunked-ndarray) scale scenarios: base facts yielded as
# ("pred", (n, ar) int ndarray) chunks for EngineKB.from_stream — a 10^8-fact
# KB never exists as decoded Python tuples
# ---------------------------------------------------------------------------
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


def tc_random_chunks(n_nodes: int, n_edges: int, seed: int = 3,
                     chunk_rows: int = 1 << 20, dtype=None):
    """Random-graph TC base as edge chunks (duplicate edges possible across
    chunks — the streamed ingest dedups them against the store)."""
    dt = _check_node_range(n_nodes, dtype)
    rng = np.random.default_rng(seed)
    left = n_edges
    while left > 0:
        n = min(left, chunk_rows)
        yield "e", rng.integers(0, n_nodes, (n, 2)).astype(dt)
        left -= n


# ---------------------------------------------------------------------------
# linear scenarios (LI) helper: the linear sub-programs
# ---------------------------------------------------------------------------
def linear_subset(program):
    return Program([r for r in program.rules if r.is_linear])


SCENARIOS = {
    "LUBM-LI": (LUBM_LI, lambda scale: lubm_facts(n_univ=scale)),
    "LUBM-L": (LUBM_L, lambda scale: lubm_facts(n_univ=scale)),
    "LUBM-LE": (LUBM_LE, lambda scale: lubm_facts(n_univ=scale)),
    "CHASEBENCH": (CHASEBENCH, lambda scale: chasebench_facts(n=100 * scale)),
    "RHO-DF": (RHO_DF, lambda scale: rho_df_facts(
        n_classes=20 * scale, n_instances=300 * scale)),
    "TC-CHAIN": (TC, lambda scale: tc_chain_facts(n_chain=64 * scale)),
    "TC-RAND": (TC, lambda scale: tc_random_facts(
        n_nodes=200 * scale, n_edges=600 * scale)),
}

# streamed counterparts: (program, scale -> iterator of (pred, ndarray)
# chunks) for EngineKB.from_stream — scale is the TOTAL fact target (base +
# closure for TC-WIDE), so bases never exist as python tuples
STREAM_SCENARIOS = {
    "TC-WIDE": (TC, lambda total: tc_wide_chunks(max(total // 14, 1))),
    "TC-RAND": (TC, lambda total: tc_random_chunks(
        n_nodes=max(total // 3, 1), n_edges=total)),
}
