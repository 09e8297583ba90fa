"""The port's symbolic layer (``repro_torch.core``) against the reference's
``repro.core``, in-process.

Both layers are pure Python.  ``chase`` walks sets of atoms and
``tglinear`` numbers EG nodes in derivation order, so node ids and null ids
depend on string hashing; in one process both packages hash alike, and
their EGs, chase graphs and instances must agree node for node and null
for null.  Programs and bases are built once per package from the same
text or the same numpy seed.
"""
import numpy as np
import pytest

from repro.core import chase as RC
from repro.core import eg as REG
from repro.core import rewrite as RR
from repro.core import terms as RT
from repro.core import tg_datalog as RTD
from repro.core import tg_linear as RTL
from repro.core import unify as RU
from repro.data import kb_sources as RS
from repro_torch.core import chase as TC
from repro_torch.core import eg as TEG
from repro_torch.core import rewrite as TR
from repro_torch.core import terms as TT
from repro_torch.core import tg_datalog as TTD
from repro_torch.core import tg_linear as TTL
from repro_torch.core import unify as TU
from repro_torch.data import kb_sources as TS

# one namespace per package, so one function builds a case for either
REF = dict(T=RT, S=RS, C=RC, EG=REG, R=RR, TD=RTD, TL=RTL, U=RU)
PORT = dict(T=TT, S=TS, C=TC, EG=TEG, R=TR, TD=TTD, TL=TTL, U=TU)

LINEAR_TEXT = {
    "chain": """
        a(X) -> B(X)
        B(X) -> C(X)
        C(X) -> D(X)
    """,
    # Example 2: the r2/r3 cycle must close after one pass
    "cycle": """
        r(X, Y) -> R(X, Y)
        R(X, Y) -> S(Y, X)
        S(Y, X) -> R(X, Y)
    """,
    # existentials that min_linear keeps: a chain of two nulls
    "exist": """
        r(X, Y) -> exists Z. S(Y, Z)
        S(Y, Z) -> exists W. U(Z, W)
        U(Z, W) -> V(W)
        r(X, Y) -> Q(X, Y)
        Q(X, Y) -> P(Y)
        S(Y, Z) -> P(Y)
    """,
}


def linear_program(P, name):
    """The named linear program, built with package ``P``."""
    T, S = P["T"], P["S"]
    if name == "example1":
        return T.example1_program()
    if name == "lubm_li":
        return S.LUBM_LI
    if name == "rhodf_li":
        return S.linear_subset(S.RHO_DF)
    return T.parse_program(LINEAR_TEXT[name])


LINEAR = ["example1", "lubm_li", "rhodf_li"] + sorted(LINEAR_TEXT)


def random_linear(P, seed):
    """A random linear Datalog program and base in the style of
    ``tests/test_property.py::linear_program``, drawn with numpy from
    ``seed`` (the same draws for either package)."""
    T = P["T"]
    rng = np.random.default_rng(seed)
    X, Y = T.Var("X"), T.Var("Y")
    body_args = [(X, Y), (Y, X), (X, X)]
    head_args = body_args + [(Y, Y)]
    idb = ["P", "Q", "R"]
    rules = [T.Rule((T.Atom("e", (X, Y)),),
                    T.Atom(idb[rng.integers(3)], body_args[rng.integers(3)]),
                    "seed")]
    for i in range(int(rng.integers(1, 5))):
        src, dst = idb[rng.integers(3)], idb[rng.integers(3)]
        b, h = body_args[rng.integers(3)], head_args[rng.integers(4)]
        if set(h) <= set(b):
            rules.append(T.Rule((T.Atom(src, b),), T.Atom(dst, h), f"g{i}"))
    edges = rng.integers(0, 4, (int(rng.integers(1, 7)), 2))
    base = [T.Atom("e", (f"c{a}", f"c{b}")) for a, b in edges]
    return T.Program(rules), base


def norm_term(t):
    kind = type(t).__name__
    if kind == "Null":
        return ("null", t.nid)
    if kind == "Var":
        return ("var", t.name)
    return t


def norm_atom(a):
    return (a.pred, tuple(norm_term(t) for t in a.args))


def norm_facts(facts):
    return {norm_atom(a) for a in facts}


def eg_shape(g):
    """Everything of an EG that either engine reads: nodes with their rules
    and parent maps, the next id, stats and the topological order."""
    return ([(v, g.rule_of[v].name, repr(g.rule_of[v]),
              sorted(g.parents(v).items())) for v in sorted(g.rule_of)],
            g._next, g.stats(), g.topo_order())


def chase_shape(res):
    return (norm_facts(res.facts), res.rounds, res.triggers, res.derived,
            res.per_round, res.terminated,
            [(tuple(norm_atom(b) for b in body), rule.name, norm_atom(f))
             for body, rule, f in res.graph])


def eval_shape(ev):
    return ({v: norm_facts(fs) for v, fs in ev.node_facts.items()},
            norm_facts(ev.facts), ev.triggers)


def bases(P):
    """Bases of the paper's Example 1 program (the reference's
    ``tests/test_tg_linear.py``)."""
    T = P["T"]
    return [[T.parse_atom(s) for s in b] for b in (
        ["r(c1, c2)"], ["r(c1, c1)"], ["r(a, b)", "r(b, c)", "r(c, c)"])]


# ---------------------------------------------------------------------------
# tglinear / min_linear (Alg. 1, Defs. 12-14)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", LINEAR)
def test_tglinear_and_min_linear_match_reference(name):
    got, want = ({}, {})
    for P, out in ((PORT, got), (REF, want)):
        prog = linear_program(P, name)
        out["H"] = [norm_atom(f) for f in P["TL"].canonical_facts(prog)]
        g = P["TL"].tglinear(prog)
        m = P["TL"].min_linear(g)
        out["tg"], out["min"] = eg_shape(g), eg_shape(m)
        out["untouched"] = eg_shape(g)      # min_linear copies its input
    assert got == want
    assert got["tg"] == got["untouched"]


def test_example1_figures():
    """Figure 1(b): r1 -> r2 and a root r4; Figure 1(c): min_linear drops
    the r4 node (Example 16); Example 41: the node instances over
    r(c1, c2)."""
    P = TT.example1_program()
    g = TTL.tglinear(P)
    names = {g.rule_of[v].name: v for v in g.nodes}
    assert sorted(names) == ["r1", "r2", "r4"]
    assert g.parents(names["r2"]) == {0: names["r1"]}
    m = TTL.min_linear(g)
    assert sorted(m.rule_of[v].name for v in m.nodes) == ["r1", "r2"]
    ev = TEG.evaluate(g, [TT.parse_atom("r(c1, c2)")])
    assert {str(f) for f in ev.node_facts[names["r2"]]} == {"T(c2, c1, c2)"}


@pytest.mark.parametrize("seed", range(16))
def test_random_linear_programs_match_reference(seed):
    got, want = ({}, {})
    for P, out in ((PORT, got), (REF, want)):
        prog, base = random_linear(P, seed)
        g = P["TL"].tglinear(prog)
        m = P["TL"].min_linear(g)
        out["egs"] = eg_shape(g), eg_shape(m)
        out["eval"] = eval_shape(P["EG"].evaluate(m, base))
        out["is_tg"] = (P["EG"].is_tg_for(g, prog, base),
                        P["EG"].is_tg_for(m, prog, base))
        out["chase"] = chase_shape(P["C"].chase(prog, base))
    assert got == want
    assert got["is_tg"] == (True, True)


# ---------------------------------------------------------------------------
# EG evaluation (Def. 5) and the TG check (Def. 6)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["example1", "exist", "cycle"])
def test_evaluate_and_is_tg_for_match_reference(name):
    got, want = ([], [])
    for P, out in ((PORT, got), (REF, want)):
        prog = linear_program(P, name)
        g = P["TL"].tglinear(prog)
        m = P["TL"].min_linear(g)
        for base in bases(P):          # each program's EDB is r/2
            for eg in (g, m):
                out.append((eval_shape(P["EG"].evaluate(eg, base)),
                            P["EG"].is_tg_for(eg, prog, base)))
    assert got == want
    assert all(ok for _, ok in got)


def test_eg_structure_calls_match_reference():
    """``parents``, ``children``, ``ancestors``, ``depth``, ``copy``,
    ``remove_node`` on the LUBM-LI TG."""
    got, want = ([], [])
    for P, out in ((PORT, got), (REF, want)):
        g = P["TL"].tglinear(P["S"].LUBM_LI)
        c = g.copy()
        for v in g.topo_order():
            out.append((v, g.children(v), sorted(g.ancestors(v)),
                        g.depth(v)))
        c.remove_node(g.topo_order()[0])
        out.append((eg_shape(c), eg_shape(g)))
    assert got == want


# ---------------------------------------------------------------------------
# the chase (four variants, graph tracking) and certain answers
# ---------------------------------------------------------------------------
def chase_case(P, name):
    S, T = P["S"], P["T"]
    if name == "example1":
        return T.example1_program(), [T.parse_atom(s) for s in (
            "r(a, b)", "r(b, c)", "r(c, c)")]
    if name == "chasebench":
        return S.CHASEBENCH, S.chasebench_facts(n=8)
    if name == "lubm_l":
        return S.LUBM_L, S.lubm_facts(n_univ=1)
    return S.TC, S.tc_chain_facts(n_chain=12)


@pytest.mark.parametrize("variant",
                         ["restricted", "skolem", "equivalent", "oblivious"])
@pytest.mark.parametrize("name", ["example1", "chasebench", "lubm_l", "tc"])
def test_chase_matches_reference(name, variant):
    got, want = (chase_shape(P["C"].chase(
        *chase_case(P, name), variant=variant, max_rounds=6,
        track_graph=True)) for P in (PORT, REF))
    assert got == want


def test_certain_answer_bcq_matches_reference():
    got, want = ([], [])
    for P, out in ((PORT, got), (REF, want)):
        T = P["T"]
        prog, base = chase_case(P, "example1")
        for q in ("T(c, c, c)", "T(b, a, Z)", "R(c, Z) & T(Z, c, W)",
                  "R(a, a)"):
            atoms = [T.parse_atom(s) for s in q.split("&")]
            out.append(P["C"].certain_answer_bcq(prog, base, atoms))
    assert got == want
    assert got == [True, True, True, False]


# ---------------------------------------------------------------------------
# unification, containment, rewriting
# ---------------------------------------------------------------------------
def test_unify_matches_reference():
    got, want = ([], [])
    for P, out in ((PORT, got), (REF, want)):
        T, U = P["T"], P["U"]
        a = T.parse_atom
        inst = U.Index([a("r(a, b)"), a("r(b, c)"), a("r(c, c)"),
                        a("s(b)"), a("r(a, b)")])
        out.append(len(inst))
        homs = U.homomorphisms([a("r(X, Y)"), a("r(Y, Z)")], inst)
        out.append(sorted(sorted((v.name, t) for v, t in h.items())
                          for h in homs))
        out.append(U.exists_hom([a("r(X, X)"), a("s(X)")], inst))
        n1, n2 = T.Null(1), T.Null(2)
        i1 = [T.Atom("r", ("a", n1)), T.Atom("r", (n1, n2))]
        i2 = [a("r(a, b)"), a("r(b, c)")]
        out.append((U.entails(i2, i1), U.entails(i1, i2),
                    U.equivalent(i1, i1), U.equivalent(i1, i2)))
        hom = U.instance_hom(i1, i2)
        out.append(sorted((v.name, t) for v, t in hom.items()))
        X = T.Var("X")
        out.append((U.cq_contained((X,), [a("r(X, Y)"), a("r(Y, Z)")],
                                   (X,), [a("r(X, Y)")]),
                    U.cq_contained((X,), [a("r(X, Y)")],
                                   (X,), [a("r(X, Y)"), a("r(Y, Z)")])))
        for atoms in ([a("r(X, b)"), a("r(a, Y)")],
                      [a("r(X, X)"), a("r(a, Y)")],
                      [a("r(X, b)"), a("r(a, c)")],
                      [a("r(X, Y)"), a("s(X)")]):
            m = U.mgu(atoms)
            out.append(None if m is None else
                       sorted((v.name, norm_term(t)) for v, t in m.items()))
    assert got == want


def test_eg_rewriting_matches_reference():
    """Def. 17 rewritings of every node of TGmat's EG for the paper's
    Example 43 program and for TC, and their pairwise containment."""
    text = """
        r(X1, Y1, Z1) -> T(X1, X1, Y1)
        T(X2, Y2, Z2) -> R(Y2, Z2)
        R(X3, Y3) & s(Y3) -> A(X3)
    """
    got, want = ([], [])
    for P, out in ((PORT, got), (REF, want)):
        T = P["T"]
        for prog, base in ((T.parse_program(text),
                            [T.parse_atom("r(a, b, c)"),
                             T.parse_atom("s(b)")]),
                           (P["S"].TC, P["S"].tc_chain_facts(n_chain=6))):
            _, eg, _ = P["TD"].tgmat(prog, base, use_min=False)
            rews = {v: P["R"].eg_rewriting(eg, v) for v in eg.topo_order()}
            out.append({v: repr(q) for v, q in rews.items()})
            out.append([(u, v, P["R"].rewriting_contained(rews[u], rews[v]))
                        for u in rews for v in rews])
    assert got == want


# ---------------------------------------------------------------------------
# TGmat (Alg. 2) with minDatalog and the Def. 23 strategy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_min,use_ruleexec",
                         [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("name", ["lubm_l", "rho_df"])
def test_tgmat_matches_reference(name, use_min, use_ruleexec):
    got, want = (None, None)
    for P in (PORT, REF):
        S = P["S"]
        prog, base = ((S.LUBM_L, S.lubm_facts(n_univ=1)) if name == "lubm_l"
                      else (S.RHO_DF, S.rho_df_facts(n_instances=60)))
        inst, eg, stats = P["TD"].tgmat(prog, base, use_min=use_min,
                                        use_ruleexec=use_ruleexec)
        shape = (norm_facts(inst.facts), stats, eg_shape(eg))
        if P is PORT:
            got = shape
            chased = norm_facts(P["C"].chase(prog, base).facts)
        else:
            want = shape
    assert got == want
    assert got[0] == chased
