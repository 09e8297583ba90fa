"""The port's fused round executor (``REPRO_FUSED=1``) on the CPU against the
JAX reference.

The reference engine needs ``jax.experimental.enable_x64``, which the
installed jax no longer has, so it runs in ONE module-scoped subprocess with
a shim for it (as in ``test_torch_materialize.py``).  The scenarios are one
piece of source (``SCENARIOS``) run against either package: every case of
the reference's ``tests/test_fused.py``, the deep-chain TC of
``benchmarks/bench_fused.py``, LUBM-L, and the four entry points under
``REPRO_FUSED=1``.  Each run hands back the facts (nulls by id), ``rounds``,
``triggers``, ``derived``, ``MatStats.extra``, ``fused_pulls``,
``fused_retries``, ``count_pulls`` and ``SORT_STATS``; the port must
reproduce all of them.  Each scenario starts from an empty capacity memo,
so the retries do not depend on the order the tests run in.  The planner's
pure-python pieces are held against ``repro.engine.plan`` in-process.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from repro.core import terms as RT
from repro.data import kb_sources as RS
from repro.engine import dictionary as RD
from repro.engine import plan as rplan
from repro_torch.core import terms as TT
from repro_torch.data import kb_sources as TS
from repro_torch.engine import dictionary as TD
from repro_torch.engine import faultinject, fused, ops, plan
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.engine.relation import lex_order

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))

# One piece of source, run against either package: ``E`` carries the
# package's modules and a ``kb(program, facts)`` factory.
SCENARIOS = textwrap.dedent('''
    import os
    import numpy as np

    TC = "e(X, Y) -> T(X, Y)\\nT(X, Y) & e(Y, Z) -> T(X, Z)"
    # benchmarks/bench_datalog.py's layout: the recursive join is on the
    # primary column of both the delta and the edge store
    DEEP = "e(X, Y) -> T(Y, X)\\nT(Y, X) & e(Y, Z) -> T(Z, X)"
    EXIST = "p(X, Y) -> Q(X, Y)\\nQ(X, Y) & Q(Y, Z) -> exists W. Q(Z, W)"

    def chain(E, n, extra=0, seed=0):
        rng = np.random.default_rng(seed)
        edges = [(i, i + 1) for i in range(n)]
        edges += [tuple(e) for e in rng.integers(0, n, (extra, 2))]
        return [E.parse_atom(f"e(v{a}, v{b})") for a, b in edges]

    def norm(E, facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, E.Null)
                               else t for t in f.args)) for f in facts}

    def reset(E):
        E.ops.HOST_SYNC_STATS.reset()
        E.ops.SORT_STATS.reset()

    def result(E, kb, st):
        h = E.ops.HOST_SYNC_STATS
        return {"facts": norm(E, kb.decode_facts()), "rounds": st.rounds,
                "triggers": st.triggers, "derived": st.derived,
                "extra": dict(st.extra), "fused_pulls": h.fused_pulls,
                "fused_retries": h.fused_retries,
                "count_pulls": h.count_pulls,
                "sort_stats": dict(vars(E.ops.SORT_STATS))}

    def run(E, prog, facts, mode="tg", fused=True, **kw):
        os.environ["REPRO_FUSED"] = "1" if fused else "0"
        reset(E)
        kb = E.kb(E.parse_program(prog) if isinstance(prog, str) else prog,
                  facts)
        return result(E, kb, E.materialize(kb, mode=mode, **kw))

    def scenario(E, name):
        E.plan._CAP_MEMO.clear()
        if name in ("tg", "tg_noopt"):
            B = chain(E, 24, extra=16, seed=3)
            return [run(E, TC, B, mode=name, fused=False),
                    run(E, TC, B, mode=name)]
        if name == "host_sync":
            B = chain(E, 48)
            return [run(E, TC, B, fused=False), run(E, TC, B)]
        if name == "retry":
            B = chain(E, 60)
            out = [run(E, TC, B, fused=False), run(E, TC, B)]
            # a join plan one doubling short of what this instance needs:
            # the chain's biggest join emits 59 rows
            orig = E.plan._Caps.join_cap

            def small_join_cap(self, plan, idx):
                key = (plan.key, idx)
                if key not in self.join:
                    self.join[key] = 32
                return self.join[key]
            E.plan._Caps.join_cap = small_join_cap
            try:
                out.append(run(E, TC, B))
            finally:
                E.plan._Caps.join_cap = orig
            return out
        if name == "invariant":
            return [run(E, TC, chain(E, 20, extra=12, seed=5))]
        if name == "warm":
            B = chain(E, 30, extra=8, seed=9)
            return [run(E, TC, B), run(E, TC, B)]
        if name == "fallback":
            B = [E.parse_atom("p(a, b)"), E.parse_atom("p(b, c)")]
            return [run(E, EXIST, B, fused=False, max_rounds=5),
                    run(E, EXIST, B, max_rounds=5)]
        if name == "seminaive":
            return [run(E, TC, chain(E, 10), mode="seminaive")]
        if name == "deep":
            B = chain(E, 192, extra=16)
            return [run(E, DEEP, B, fused=False), run(E, DEEP, B),
                    run(E, DEEP, B)]
        if name == "lubm":
            B = E.S.lubm_facts(n_univ=1)
            return [run(E, E.S.LUBM_L, B, fused=False),
                    run(E, E.S.LUBM_L, B), run(E, E.S.LUBM_L, B)]
        if name.startswith("entry-"):
            entry = name.partition("-")[2]
            os.environ["REPRO_FUSED"] = "1"
            reset(E)
            kb = E.kb(E.S.LUBM_L, E.S.lubm_facts(n_univ=1))
            fact = E.Atom("Student", ("s",))
            if entry == "materialize":
                st = E.materialize(kb)
            elif entry == "materialize_delta":
                st = kb.materialize_delta(insertions=[fact])
            else:
                st = getattr(kb, entry)([fact])
            return [result(E, kb, st)]
        raise KeyError(name)
''')

NAMES = ("tg", "tg_noopt", "host_sync", "retry", "invariant", "warm",
         "fallback", "seminaive", "deep", "lubm", "entry-materialize",
         "entry-materialize_delta", "entry-insert_facts",
         "entry-delete_facts")

REFERENCE_RUN = textwrap.dedent("""
    import os, pickle, sys, types
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.core.terms import Atom, Null, parse_atom, parse_program
    from repro.data import kb_sources as S
    from repro.engine import ops, plan
    from repro.engine.materialize import EngineKB, materialize

    E = types.SimpleNamespace(
        Atom=Atom, Null=Null, parse_atom=parse_atom,
        parse_program=parse_program, S=S, ops=ops, plan=plan,
        materialize=materialize, kb=EngineKB)
    src, names = pickle.loads(bytes.fromhex(sys.argv[2]))
    ns = {}
    exec(src, ns)
    out = {name: ns["scenario"](E, name) for name in names}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def port_env():
    return types.SimpleNamespace(
        Atom=TT.Atom, Null=TT.Null, parse_atom=TT.parse_atom,
        parse_program=TT.parse_program, S=TS, ops=ops, plan=plan,
        materialize=materialize,
        kb=lambda prog, facts: EngineKB(prog, facts, device="cpu"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "fused.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path),
                    pickle.dumps((SCENARIOS, NAMES)).hex()], check=True,
                   env=env, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


@pytest.fixture
def port(monkeypatch):
    """Runs one scenario on the port (its own flags, an empty memo)."""
    for var in ("REPRO_FUSED", "REPRO_CKPT_DIR", "REPRO_FAULT_SPEC",
                "REPRO_MAX_RETRIES", "REPRO_MAX_RESIDENT_MB"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    ns = {}
    exec(SCENARIOS, ns)
    env = port_env()

    def run(name):
        try:
            return ns["scenario"](env, name)
        finally:
            os.environ.pop("REPRO_FUSED", None)
    return run


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_reference(reference, port, name):
    """Facts, rounds, triggers, derived, ``extra``, fused_pulls,
    fused_retries, count_pulls and SORT_STATS, run for run."""
    want = reference[name]
    got = port(name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, i, {k: (g[k], w[k]) for k in g
                                  if k != "facts" and g[k] != w[k]})


@pytest.mark.parametrize("mode", ["tg", "tg_noopt"])
def test_fused_matches_two_phase(port, mode):
    two, fus = port(mode)
    assert fus["extra"].get("fused") is True
    assert "fused" not in two["extra"]
    assert [two[k] for k in ("facts", "rounds", "triggers", "derived")] == \
        [fus[k] for k in ("facts", "rounds", "triggers", "derived")]


def test_fused_host_sync_reduction(port):
    """The deep-chain fixpoint collapses hundreds of per-primitive host
    pulls into a handful of per-round / per-fixpoint pulls."""
    two, fus = port("host_sync")
    assert two["facts"] == fus["facts"]
    assert two["rounds"] == fus["rounds"] > 40
    fused_total = fus["fused_pulls"] + fus["count_pulls"]
    assert fused_total < fus["rounds"]
    assert fused_total * 5 <= two["count_pulls"]


def test_fused_overflow_retry_exactly_once(port):
    ref, _, small = port("retry")
    assert small["extra"].get("fused") is True
    assert small["fused_retries"] == 1
    assert small["facts"] == ref["facts"]


def test_fused_store_invariant(monkeypatch):
    """Fused stores come back lexsorted, compacted, and set-semantic."""
    monkeypatch.setenv("REPRO_FUSED", "1")
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    ns = {}
    exec(SCENARIOS, ns)
    env = port_env()
    kb = env.kb(TT.parse_program(ns["TC"]), ns["chain"](env, 20, 12, 5))
    materialize(kb, mode="tg")
    for pred, rel in kb.rels.items():
        assert rel.sorted_by == lex_order(rel.arity), pred
        rows = rel.np_rows()
        assert (np.lexsort(rows.T[::-1]) == np.arange(len(rows))).all()
        assert len(rel.rows_set()) == rel.count, pred
        assert (rel.data[rel.count:] == rel.pad).all(), pred


def test_fused_capacity_memo_warm_start(port):
    cold, warm = port("warm")
    assert cold["fused_retries"] > 0 and warm["fused_retries"] == 0
    assert cold["facts"] == warm["facts"]


def test_fused_falls_back_outside_fragment(port):
    two, fus = port("fallback")
    assert "fused" not in fus["extra"]
    assert fus["facts"] == two["facts"]
    assert fus["fused_pulls"] == 0


def test_seminaive_never_fused(port):
    (st,) = port("seminaive")
    assert "fused" not in st["extra"] and st["fused_pulls"] == 0


def test_deep_chain_counters_as_committed(port):
    """``BENCH_tc.json``'s ``tc.fused`` and ``tc.two_phase`` rows (the
    reference's warm run of ``benchmarks/bench_fused.py`` at full size:
    ``tc_facts(192, 16)``)."""
    with open(os.path.join(ROOT, "BENCH_tc.json")) as f:
        rows = {r["name"]: r for r in json.load(f)["results"]}
    two, cold, warm = port("deep")
    for got, row in ((two, rows["tc.two_phase"]), (warm, rows["tc.fused"])):
        assert (got["rounds"], got["triggers"], got["derived"],
                len(got["facts"]), got["fused_pulls"], got["fused_retries"],
                got["count_pulls"]) == \
            (row["rounds"], row["triggers"], row["derived"], row["facts"],
             row["fused_pulls"], row["fused_retries"], row["count_pulls"])
    assert (warm["rounds"], warm["triggers"], warm["derived"],
            warm["fused_pulls"]) == (128, 39546, 36314, 21)
    assert cold["facts"] == warm["facts"] == two["facts"]


def test_entry_points_run_fused(port):
    """``materialize`` under ``REPRO_FUSED=1`` runs the fused executor on
    LUBM-L (in its fragment); a delta call on the unmaterialized KB takes
    one round there and stays two-phase, below the hand-off."""
    (mat,) = port("entry-materialize")
    assert mat["extra"] == {"fused": True} and mat["fused_pulls"] > 0
    for entry in ("materialize_delta", "insert_facts", "delete_facts"):
        (st,) = port(f"entry-{entry}")
        assert "fused" not in st["extra"], entry


# ---------------------------------------------------------------------------
# the planner's pure-python pieces against repro.engine.plan, in-process
# ---------------------------------------------------------------------------
PROGRAMS = ("TC", "LUBM_L", "RHO_DF")


def _plans(pkg_terms, pkg_sources, pkg_dict, pkg_plan, prog):
    program = getattr(pkg_sources, prog).normalize()
    dic = pkg_dict.Dictionary()
    return [pkg_plan.compile_rule_plan(r, dic) for r in program.rules]


@pytest.mark.parametrize("prog", PROGRAMS)
def test_rule_plans_and_linear_tail_match_reference(prog):
    ref = _plans(RT, RS, RD, rplan, prog)
    got = _plans(TT, TS, TD, plan, prog)
    assert [p.key for p in got] == [p.key for p in ref]
    assert [(p.pre, p.head_spec) for p in got] == \
        [(p.pre, p.head_spec) for p in ref]
    preds = sorted({p.head_pred for p in ref} | {b for p in ref
                                                 for b in p.body_preds})
    lives = [(p,) for p in preds] + [tuple(preds)]
    for live in lives:
        r = rplan._linear_tail(ref, live)
        g = plan._linear_tail(got, live)
        if r is None:
            assert g is None, live
            continue
        assert g[0] == r[0], live
        assert [(p.key, j) for p, j in g[1]] == \
            [(p.key, j) for p, j in r[1]], live


def _bare_caps(mod, delta):
    caps = mod._Caps.__new__(mod._Caps)
    caps.store, caps.delta, caps.tail = {}, dict(delta), {}
    caps.join, caps.bucket = {}, {}
    return caps


def test_retry_budget_escalates_and_raises(monkeypatch):
    """The reference's ladder: x2, x2, then escalating doublings; the
    attempt ceiling raises with the label and the planned bytes; progress
    resets the ladder."""
    monkeypatch.setenv("REPRO_MAX_RETRIES", "3")
    label = ("delta", "T")
    trail = []
    for mod in (rplan, plan):
        caps = _bare_caps(mod, {"T": 1})
        budget = mod.RetryBudget(caps, row_bytes=8)
        sizes = []
        for _ in range(3):
            budget.overflow([label])
            sizes.append(caps.delta["T"])
        with pytest.raises(mod.CapacityError) as ei:
            budget.overflow([label])
        assert ei.value.label == label and "REPRO_MAX_RETRIES" in str(ei.value)
        budget.ok()
        budget.overflow([label])
        sizes.append(caps.delta["T"])
        trail.append((sizes, ei.value.requested_bytes, ei.value.attempts,
                      str(ei.value)))
    assert trail[0] == trail[1]
    assert trail[1][0] == [2, 4, 16, 32]


def test_retry_budget_resident_ceiling():
    out = []
    for mod in (rplan, plan):
        caps = _bare_caps(mod, {"T": 1 << 20})
        budget = mod.RetryBudget(caps, row_bytes=8, attempts=100,
                                 resident_bytes=1 << 22)
        with pytest.raises(mod.CapacityError,
                           match="REPRO_MAX_RESIDENT_MB") as ei:
            budget.overflow([("delta", "T")])
        out.append((ei.value.requested_bytes, ei.value.attempts,
                    str(ei.value)))
    assert out[0] == out[1]


@pytest.mark.parametrize("lean", [False, True])
def test_caps_state_adopt_memoize_match_reference(lean, monkeypatch):
    """Cold guesses, seeded deltas, doubling, ``state``, ``adopt`` and
    ``memoize`` give the reference's sizes, key for key."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    stores = {"T": (None, 700), "e": (None, 33), "x": (None, 0)}
    join_plan = types.SimpleNamespace(key=("T", ("T", "e")))
    out = []
    for mod in (rplan, plan):
        monkeypatch.setattr(mod, "_CAP_MEMO", {})
        caps = mod._Caps(("fp",), stores, lean=lean)
        caps.delta_cap("T")
        caps.join_cap(join_plan, 0)
        caps.tail_cap("T")
        caps.seed_delta("e", 5000)
        caps.double(("join", (join_plan.key, 0)))
        caps.double(("tail", "T"))
        caps.double(("store", "e"))
        first = caps.state()
        caps.adopt({"delta": {"T": 1 << 20, "zz": 8}, "store": {"e": 2}})
        caps.memoize()
        memo = dict(mod._CAP_MEMO)
        again = mod._Caps(("fp",), stores, lean=lean)
        out.append((first, caps.state(), caps.planned_rows(), memo,
                    again.state(), again.delta_cap("T"),
                    again.join_cap(join_plan, 0)))
    assert out[0] == out[1]


def test_storm_floors_the_guesses(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SPEC", "storm")
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    caps = plan._Caps(("fp",), {"T": (None, 1 << 16)})
    assert caps.delta_cap("T") == 64
    monkeypatch.delenv("REPRO_FAULT_SPEC")
    monkeypatch.setattr(faultinject, "_CACHE", {})
    assert plan._Caps(("fp",), {"T": (None, 1 << 16)}).delta_cap("T") == \
        1 << 17


def test_lower_fused_programs_is_not_ported(monkeypatch):
    """``lower_fused_programs`` counts the round and fixpoint programs of a
    materialized KB (``tests/test_torch_analysis.py`` holds them against
    the reference's): None outside the fused fragment, ``{}`` when no rule
    reads a derived predicate, and neither a retry nor a memo entry."""
    monkeypatch.setenv("REPRO_FUSED", "1")
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    ns = {}
    exec(SCENARIOS, ns)
    env = port_env()
    facts = [TT.parse_atom("p(a, b)")]
    assert fused.lower_fused_programs(
        env.kb(TT.parse_program(ns["EXIST"]), facts)) is None
    assert fused.lower_fused_programs(
        env.kb(TT.parse_program("p(X, Y) -> Q(X, Y)"), facts)) == {}
    kb = env.kb(TT.parse_program(ns["TC"]), ns["chain"](env, 20, 12, 5))
    materialize(kb, mode="tg")
    memo, retries = dict(plan._CAP_MEMO), ops.HOST_SYNC_STATS.fused_retries
    got = fused.lower_fused_programs(kb)
    assert set(got) == {"round", "fixpoint"}
    assert plan._CAP_MEMO == memo
    assert ops.HOST_SYNC_STATS.fused_retries == retries
    for rec in got.values():
        assert rec["sort_ops_static"] == rec["sorts"] >= 1
        assert rec["bytes"] > 0 and rec["trip_count"] == 1
