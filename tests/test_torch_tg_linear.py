"""``materialize(kb, mode="tg_linear")`` on the CPU against the JAX reference.

The reference engine needs ``jax.experimental.enable_x64``, which the
installed jax no longer has, so it runs in ONE module-scoped subprocess with
a shim for it (as in ``test_torch_materialize.py``).  EG node ids follow
string hashing, which differs between processes, so the port builds each
case's TG here (``min_linear(tglinear(P))``) and hands it to the subprocess
as data (node id, rule name, parent map); both engines walk the same graph.
Every case runs with and without cleaning, under ``REPRO_SORTED_STORE=0``
and ``1``; facts (nulls by id), ``rounds``, ``triggers``, ``derived``,
``mode``, ``SORT_STATS`` and ``count_pulls`` must be equal, and the result
must be the port's own chase of the same KB.
"""
import functools
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core import chase as TC
from repro_torch.core import terms as TT
from repro_torch.core.tg_linear import min_linear, tglinear
from repro_torch.core.unify import equivalent
from repro_torch.data import kb_sources as TS
from repro_torch.engine import ops
from repro_torch.engine.materialize import EngineKB, materialize

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# a linear program whose TG keeps existential nodes (a chain of two nulls),
# and a root ``t`` with no base facts: its node and the child of that node
# run over empty inputs
EXIST = """
    r(X, Y) -> exists Z. S(Y, Z)
    S(Y, Z) -> exists W. U(Z, W)
    U(Z, W) -> V(W)
    r(X, Y) -> Q(X, Y)
    Q(X, Y) -> P(Y)
    t(X) -> exists Y. Q(X, Y)
"""

# Each case is one piece of source, run against either package (``S`` is
# the package's kb_sources, ``T`` its terms module): (program, facts).
CASES = {
    "lubm_li": "S.LUBM_LI, S.lubm_facts(n_univ=2)",
    "rhodf_li": ("S.linear_subset(S.RHO_DF), S.rho_df_facts("
                 "n_classes=10, n_props=5, n_instances=100)"),
    "exist": ("T.parse_program(EXIST), [T.Atom('r', (f'c{a}', f'c{b}')) "
              "for a, b in np.random.default_rng(5).integers(0, 6, (12, 2))]"),
}
FLAGS = [(c, s) for c in (True, False) for s in ("1", "0")]

REFERENCE_RUN = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.core import terms as T
    from repro.core.eg import EG
    from repro.core.terms import Null
    from repro.data import kb_sources as S
    from repro.engine import ops
    from repro.engine.materialize import EngineKB, materialize

    def norm(facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, Null) else t
                               for t in f.args)) for f in facts}

    def rebuild(program, nodes):
        prog = program.normalize()
        by_name = {r.name: r for r in prog}
        eg = EG(prog)
        for v, name, parents in nodes:
            eg.rule_of[v] = by_name[name]
            eg.parent[v] = dict(parents)
        eg._next = max(eg.rule_of, default=-1) + 1
        return eg

    cases, flags, exist, egs = pickle.loads(bytes.fromhex(sys.argv[2]))
    out = {}
    for name, src in cases.items():
        program, facts = eval(src, {"S": S, "T": T, "np": np,
                                    "EXIST": exist})
        eg = rebuild(program, egs[name])
        for cleaning, sorted_store in flags:
            os.environ["REPRO_SORTED_STORE"] = sorted_store
            ops.SORT_STATS.reset()
            ops.HOST_SYNC_STATS.reset()
            kb = EngineKB(program, facts)
            st = materialize(kb, mode="tg_linear", tg_eg=eg,
                             cleaning=cleaning)
            out[name, cleaning, sorted_store] = {
                "facts": norm(kb.decode_facts()), "rounds": st.rounds,
                "triggers": st.triggers, "derived": st.derived,
                "mode": st.mode, "sort_stats": dict(vars(ops.SORT_STATS)),
                "count_pulls": ops.HOST_SYNC_STATS.count_pulls}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def norm(facts):
    return {(f.pred, tuple(("null", t.nid) if isinstance(t, TT.Null) else t
                           for t in f.args)) for f in facts}


def case(name):
    return eval(CASES[name], {"S": TS, "T": TT, "np": np, "EXIST": EXIST})


@functools.lru_cache(maxsize=None)
def tg_of(name):
    return min_linear(tglinear(case(name)[0]))


@functools.lru_cache(maxsize=None)
def chased(name):
    program, facts = case(name)
    res = TC.chase(program, facts)
    assert res.terminated
    return frozenset(res.facts | set(facts))


def eg_nodes(eg):
    return [(v, eg.rule_of[v].name, sorted(eg.parents(v).items()))
            for v in eg.topo_order()]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "tg_linear.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC)
    egs = {name: eg_nodes(tg_of(name)) for name in CASES}
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path),
                    pickle.dumps((CASES, FLAGS, EXIST, egs)).hex()],
                   check=True, env=env, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


def run_port(name, cleaning):
    program, facts = case(name)
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = EngineKB(program, facts, device="cpu")
    st = materialize(kb, mode="tg_linear", tg_eg=tg_of(name),
                     cleaning=cleaning)
    return kb, {"facts": norm(kb.decode_facts()), "rounds": st.rounds,
                "triggers": st.triggers, "derived": st.derived,
                "mode": st.mode, "sort_stats": dict(vars(ops.SORT_STATS)),
                "count_pulls": ops.HOST_SYNC_STATS.count_pulls}


@pytest.mark.parametrize("cleaning,sorted_store", FLAGS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_tg_linear_matches_reference(reference, name, cleaning, sorted_store,
                                     monkeypatch):
    monkeypatch.setenv("REPRO_SORTED_STORE", sorted_store)
    kb, got = run_port(name, cleaning)
    assert got == reference[name, cleaning, sorted_store]
    dtypes = {rel.data.dtype for rel in kb.rels.values()}
    assert len(dtypes) == 1, dtypes       # empty nodes keep the store dtype
    facts = kb.decode_facts()
    if name == "exist":       # the chase's nulls are not the skolem ids
        assert equivalent(facts, chased(name))
    else:
        assert facts == chased(name)


def test_the_cases_reach_what_they_are_for():
    """The existential case keeps existential nodes and has nodes over
    empty inputs; cleaning drops redundant rows that ``wo-cleaning``
    counts."""
    eg = tg_of("exist")
    assert any(eg.rule_of[v].existentials for v in eg.nodes)
    kb, _ = run_port("exist", True)
    assert kb.rels["t"].count == 0 and any(
        eg.rule_of[v].body[0].pred == "t" for v in eg.nodes)
    _, wo = run_port("lubm_li", False)
    _, w = run_port("lubm_li", True)
    assert wo["derived"] > w["derived"] and wo["facts"] == w["facts"]


def test_fused_flag_does_not_change_tg_linear(reference, monkeypatch):
    """The reference has no fused ``tg_linear``: ``REPRO_FUSED=1`` runs the
    same path."""
    monkeypatch.setenv("REPRO_FUSED", "1")
    _, got = run_port("lubm_li", True)
    assert got == reference["lubm_li", True, "1"]


def test_missing_tg_fails_as_on_the_reference():
    kb = EngineKB(*case("lubm_li"), device="cpu")
    with pytest.raises(AssertionError):
        materialize(kb, mode="tg_linear")
