"""The port's incremental maintenance (``materialize_delta``, DRed deletes)
on the CPU against the JAX reference.

The reference engine needs ``jax.experimental.enable_x64``, which the
installed jax no longer has, so it runs in ONE module-scoped subprocess
with a shim for it (as in ``test_torch_materialize.py``).  For every case
and mode the subprocess materializes the base from scratch, then runs each
scenario's delta calls on a copy of that KB and hands back, after every
call, the facts (nulls by id), ``MatStats`` with ``extra``, ``SORT_STATS``
and ``count_pulls``; the port must reproduce all of them.  The port's
maintained store must also equal its own from-scratch materialization of
the updated base, nulls compared by their skolem terms.  The subprocess
also runs the reference's ``merge_diff`` on seeded inputs.
"""
import copy
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro_torch.core.terms import Atom, Null
from repro_torch.data import kb_sources as TS
from repro_torch.engine import ops
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.engine.relation import Relation, host_order, lex_order

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODES = ("seminaive", "tg", "tg_noopt")
CASES = {
    "tc_chain": ("TC", "tc_chain_facts", {"n_chain": 32}),
    "lubm_l": ("LUBM_L", "lubm_facts", {"n_univ": 1}),
    "rho_df": ("RHO_DF", "rho_df_facts",
               {"n_classes": 10, "n_props": 5, "n_instances": 100}),
    "chasebench": ("CHASEBENCH", "chasebench_facts", {"n": 30}),
}
SCENARIOS = ("insert", "delete", "mixed", "both", "absent", "rederive",
             "unknown", "roundtrip")
# the tc_chain sequence the slice was specified with: insert e(x1, x2),
# delete it again, then delete the first 3 base edges by str order
TC_SEQUENCE = "tc_sequence"
TC_NUMBERS = [
    {"rounds": 2, "triggers": 2, "derived": 3, "propagated": 2},
    {"rounds": 2, "triggers": 624, "over_deleted": 3},
    {"rounds": 45, "triggers": 785, "derived": 110, "over_deleted": 402,
     "rescued": 13, "propagated": 97},
]
DIFF_DTYPES = ("int16", "int32", "int64")

REFERENCE_RUN = textwrap.dedent("""
    import copy, pickle, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.core.terms import Atom, Null
    from repro.data import kb_sources as S
    from repro.engine import ops
    from repro.engine.materialize import EngineKB, materialize
    from repro.engine.relation import Relation

    def norm(facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, Null) else t
                               for t in f.args)) for f in facts}

    def clone(kb):
        c = copy.copy(kb)
        c.rels, c.base = dict(kb.rels), dict(kb.base)
        c.arities, c.dict = dict(kb.arities), copy.deepcopy(kb.dict)
        return c

    def atoms(rows):
        return [Atom(p, a) for p, a in rows]

    cases, modes, scenarios, diffs = pickle.loads(bytes.fromhex(sys.argv[2]))
    out = {"delta": {}, "merge_diff": {}}
    for name, (prog, gen, kw) in cases.items():
        program, facts = getattr(S, prog), getattr(S, gen)(**kw)
        for mode in modes:
            scratch = EngineKB(program, facts)
            materialize(scratch, mode=mode)
            for scen, calls in scenarios[name].items():
                kb = clone(scratch)
                steps = []
                for ins, dels in calls:
                    ops.SORT_STATS.reset()
                    ops.HOST_SYNC_STATS.reset()
                    st = kb.materialize_delta(insertions=atoms(ins),
                                              deletions=atoms(dels),
                                              mode=mode)
                    steps.append({
                        "facts": norm(kb.decode_facts()),
                        "stats": (st.rounds, st.triggers, st.derived,
                                  st.mode, dict(st.extra)),
                        "sort_stats": dict(vars(ops.SORT_STATS)),
                        "count_pulls": ops.HOST_SYNC_STATS.count_pulls})
                out["delta"][name, mode, scen] = steps
    jax.config.update("jax_enable_x64", True)     # int64 stores
    for key, (dtype, ar, a, acap, b, bcap, marked) in diffs.items():
        order = tuple(range(ar)) if marked else None
        ra = Relation.from_numpy(a, acap, sorted_by=order, dtype=dtype)
        rb = Relation.from_numpy(b, bcap, sorted_by=order, dtype=dtype)
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        d = ops.merge_diff(ra, rb)
        out["merge_diff"][key] = {
            "rows": d.np_rows(), "count": d.count, "capacity": d.capacity,
            "sorted_by": d.sorted_by,
            "sort_stats": dict(vars(ops.SORT_STATS)),
            "count_pulls": ops.HOST_SYNC_STATS.count_pulls}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def norm(facts):
    return {(f.pred, tuple(("null", t.nid) if isinstance(t, Null) else t
                           for t in f.args)) for f in facts}


def skolem_facts(kb):
    """Decoded facts with every null named by its skolem term (rule,
    existential, frontier), recursively: equal sets mean equal up to null
    renaming."""
    key_of = {nid: key for key, nid in kb.dict._skolem.items()}

    def term(i):
        if i >= 0:
            return kb.dict.decode(i)
        rule, var, frontier = key_of[i]
        return (rule, var, tuple(term(int(x)) for x in frontier))

    return {(p, tuple(term(int(x)) for x in row[:kb.arities[p]]))
            for p, rel in kb.rels.items() for row in rel.np_rows()}


def scratch_kb(name, mode, facts=None):
    prog, gen, kw = CASES[name]
    kb = EngineKB(getattr(TS, prog),
                  getattr(TS, gen)(**kw) if facts is None else facts,
                  device="cpu")
    materialize(kb, mode=mode)
    return kb


def clone(kb):
    """A copy of a KB that delta calls can change: relations are never
    changed in place, so the dicts of them are copied and the dictionary
    deep-copied."""
    c = copy.copy(kb)
    c.rels, c.base = dict(kb.rels), dict(kb.base)
    c.arities, c.dict = dict(kb.arities), copy.deepcopy(kb.dict)
    return c


def rows(atoms):
    return [(f.pred, f.args) for f in atoms]


def build_scenarios(name):
    """Each scenario's delta calls as ((insertions, deletions), ...) of
    (pred, args) pairs, from the base by ``str`` order and, for
    "rederive", the smallest derived fact without nulls."""
    prog, gen, kw = CASES[name]
    base = sorted(getattr(TS, gen)(**kw), key=str)
    new = [Atom(f.pred, (f"{f.args[0]}_new",) + f.args[1:])
           for f in base[:3]]
    kb = scratch_kb(name, "tg")
    derived = sorted((f for f in kb.decode_facts() if f not in set(base)
                      and not any(isinstance(t, Null) for t in f.args)),
                     key=str)
    absent = Atom(base[0].pred, tuple(f"absent{i}"
                                      for i in range(base[0].arity)))
    calls = {
        "insert": [(new, [])],
        "delete": [([], base[:3])],
        "mixed": [(new, base[3:6])],
        "both": [([base[0], new[0]], [base[0]])],
        "absent": [([], [absent])],
        "rederive": [([], derived[:1])],
        "unknown": [([Atom("iso", ("a", "b"))], [])],
        "roundtrip": [(new[:1], []), ([], new[:1])],
    }
    if name == "tc_chain":
        x = Atom("e", ("x1", "x2"))
        calls[TC_SEQUENCE] = [([x], []), ([], [x]), ([], base[:3])]
    return {k: [(rows(i), rows(d)) for i, d in v] for k, v in calls.items()}


def diff_inputs():
    """Seeded ``merge_diff`` inputs per store dtype: overlapping and
    disjoint sides, PAD tails (capacity above count), duplicate rows in
    ``a``, empty sides, marked and unmarked inputs, arities 1-3."""
    rng = np.random.default_rng(0)
    out = {}
    for dtype in DIFF_DTYPES:
        for ar in (1, 2, 3):
            for na, nb, hi, marked in ((40, 25, 6, False), (64, 64, 4, True),
                                       (100, 7, 50, False), (0, 5, 4, True),
                                       (5, 0, 4, False), (1, 1, 2, True)):
                a = rng.integers(0, hi, (na, ar)).astype(dtype)
                b = np.concatenate([a[:nb // 2],
                                    rng.integers(0, hi, (nb - nb // 2, ar))
                                    ]).astype(dtype)
                if marked:          # marked inputs must really be sorted
                    a, b = a[host_order(a)], b[host_order(b)]
                out[dtype, ar, na, nb, marked] = (
                    dtype, ar, a, 2 * max(na, 1), b, 4 * max(nb, 1), marked)
    return out


@pytest.fixture(scope="module")
def scenarios():
    return {name: build_scenarios(name) for name in CASES}


@pytest.fixture(scope="module")
def reference(scenarios, tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "deltas.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC)
    arg = pickle.dumps((CASES, MODES, scenarios, diff_inputs())).hex()
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path), arg],
                   check=True, env=env, timeout=1200)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


_SCRATCH = {}


def port_scratch(name, mode):
    """The port's from-scratch KB per (case, mode), built once."""
    if (name, mode) not in _SCRATCH:
        _SCRATCH[name, mode] = scratch_kb(name, mode)
    return _SCRATCH[name, mode]


def run_scenario(reference, scenarios, name, mode, scen):
    """Run one scenario on the port, holding every call against the
    reference and against a from-scratch materialization of the updated
    base.  Returns the port's steps."""
    want = reference["delta"][name, mode, scen]
    prog, gen, kw = CASES[name]
    base = set(getattr(TS, gen)(**kw))
    kb = clone(port_scratch(name, mode))
    steps = []
    for (ins, dels), w in zip(scenarios[name][scen], want):
        ins = [Atom(p, a) for p, a in ins]
        dels = [Atom(p, a) for p, a in dels]
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        st = kb.materialize_delta(insertions=ins, deletions=dels, mode=mode)
        got = (st.rounds, st.triggers, st.derived, st.mode, dict(st.extra))
        assert got == w["stats"]
        assert dict(vars(ops.SORT_STATS)) == w["sort_stats"]
        assert ops.HOST_SYNC_STATS.count_pulls == w["count_pulls"]
        assert norm(kb.decode_facts()) == w["facts"]
        base = (base - set(dels)) | set(ins)
        assert skolem_facts(kb) == skolem_facts(
            scratch_kb(name, mode, sorted(base, key=str)))
        steps.append(st)
    assert len(steps) == len(want)
    return steps


@pytest.mark.parametrize("scen", SCENARIOS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_delta_matches_reference(reference, scenarios, name, mode, scen):
    run_scenario(reference, scenarios, name, mode, scen)


@pytest.mark.parametrize("mode", MODES)
def test_tc_sequence_matches_reference(reference, scenarios, mode):
    """Insert e(x1, x2), delete it again, delete the first 3 base edges:
    with ``tg``, the counts the slice was specified with, reaching all
    three DRed stages."""
    steps = run_scenario(reference, scenarios, "tc_chain", mode,
                         TC_SEQUENCE)
    if mode == "tg":
        for st, want in zip(steps, TC_NUMBERS):
            got = {"rounds": st.rounds, "triggers": st.triggers,
                   "derived": st.derived, **st.extra}
            assert {k: got[k] for k in want} == want


def test_scenarios_reach_every_dred_stage(reference):
    """Over-delete, rescue and re-derive each happen somewhere, and in
    LUBM-L too, as the slice needs."""
    extras = {k: [s["stats"][4] for s in v]
              for k, v in reference["delta"].items()}
    lubm = [e for (name, _, _), v in extras.items() if name == "lubm_l"
            for e in v]
    for stage in ("over_deleted", "rescued", "propagated"):
        assert any(e[stage] for e in lubm), stage


@pytest.mark.parametrize("key", sorted(diff_inputs(), key=str))
def test_merge_diff_matches_reference(reference, key):
    dtype, ar, a, acap, b, bcap, marked = diff_inputs()[key]
    order = lex_order(ar) if marked else None
    ra = Relation.from_numpy(a, acap, sorted_by=order, dtype=dtype,
                             device="cpu")
    rb = Relation.from_numpy(b, bcap, sorted_by=order, dtype=dtype,
                             device="cpu")
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    d = ops.merge_diff(ra, rb)
    want = reference["merge_diff"][key]
    assert np.array_equal(d.np_rows(), want["rows"])
    assert (d.count, d.capacity, d.sorted_by) == \
        (want["count"], want["capacity"], want["sorted_by"])
    assert dict(vars(ops.SORT_STATS)) == want["sort_stats"]
    assert ops.HOST_SYNC_STATS.count_pulls == want["count_pulls"]


@hst.composite
def diff_case(draw):
    dtype = draw(hst.sampled_from(DIFF_DTYPES))
    ar = draw(hst.integers(1, 3))
    hi = draw(hst.integers(1, 6))
    row = hst.tuples(*[hst.integers(0, hi)] * ar)
    a = draw(hst.lists(row, max_size=40))
    b = draw(hst.lists(row, max_size=40))
    pad_a, pad_b = draw(hst.integers(0, 20)), draw(hst.integers(0, 20))
    return dtype, ar, a, b, pad_a, pad_b, draw(hst.booleans())


@settings(max_examples=150, deadline=None)
@given(diff_case())
def test_merge_diff_is_a_set_difference(case):
    """``a - b`` over lexsorted sides: ``a``'s rows (duplicates kept)
    whose tuple is not in ``b``, in the engine's lex order, at ``a``'s
    capacity."""
    dtype, ar, a, b, pad_a, pad_b, marked = case
    a = np.array(a, dtype).reshape(-1, ar)
    b = np.array(b, dtype).reshape(-1, ar)
    if marked:
        a, b = a[host_order(a)], b[host_order(b)]
    order = lex_order(ar) if marked else None
    ra = Relation.from_numpy(a, len(a) + pad_a, sorted_by=order,
                             device="cpu")
    rb = Relation.from_numpy(b, len(b) + pad_b, sorted_by=order,
                             device="cpu")
    d = ops.merge_diff(ra, rb)
    gone = {tuple(r) for r in b.tolist()}
    sa = a[host_order(a)]
    want = np.array([r for r in sa.tolist() if tuple(r) not in gone],
                    dtype).reshape(-1, ar)
    assert np.array_equal(d.np_rows(), want)
    assert d.capacity == ra.capacity and d.is_lexsorted
    assert (d.data[d.count:] == torch.iinfo(d.data.dtype).max).all()


# ---------------------------------------------------------------------------
# under REPRO_FUSED=1: the fused hand-off, against the reference
# ---------------------------------------------------------------------------
# One piece of source, run against either package (``E`` carries its
# modules and a ``kb`` factory); each scenario starts from an empty
# capacity memo.
FUSED_SCENARIOS = textwrap.dedent('''
    import copy, os

    TC = "e(X, Y) -> T(X, Y)\\nT(X, Y) & e(Y, Z) -> T(X, Z)"

    def norm(E, facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, E.Null)
                               else t for t in f.args)) for f in facts}

    def chain(E, n, prefix="n"):
        return [E.parse_atom(f"e({prefix}{i}, {prefix}{i + 1})")
                for i in range(n)]

    def scratch(E, prog, facts, fused):
        os.environ["REPRO_FUSED"] = fused
        kb = E.kb(E.parse_program(prog) if isinstance(prog, str) else prog,
                  facts)
        E.materialize(kb, mode="tg")
        return kb

    def call(E, kb, fn):
        E.ops.HOST_SYNC_STATS.reset()
        E.ops.SORT_STATS.reset()
        st = fn(kb)
        h = E.ops.HOST_SYNC_STATS
        return {"facts": norm(E, kb.decode_facts()),
                "stats": (st.rounds, st.triggers, st.derived, st.mode,
                          dict(st.extra)),
                "sort_stats": dict(vars(E.ops.SORT_STATS)),
                "count_pulls": h.count_pulls, "fused_pulls": h.fused_pulls,
                "fused_retries": h.fused_retries}

    def scenario(E, name):
        E.plan._CAP_MEMO.clear()
        P = E.parse_atom
        if name.startswith("chasebench-"):
            entry = name.partition("-")[2]
            fact = E.Atom("iso", ("a", "b"))
            out = []
            for fused in ("0", "1"):
                kb = scratch(E, E.S.CHASEBENCH, E.S.chasebench_facts(n=30),
                             "0")
                os.environ["REPRO_FUSED"] = fused
                if entry == "materialize_delta":
                    fn = lambda kb: kb.materialize_delta(
                        insertions=[fact], deletions=[fact])
                else:
                    fn = lambda kb: getattr(kb, entry)([fact])
                out.append(call(E, kb, fn))
            return out
        if name == "insert_only":
            base = chain(E, 10)
            extra = [P("e(n10, n11)"), P("e(x, n0)")]
            kb = scratch(E, TC, base, "1")
            return [call(E, kb, lambda kb: kb.materialize_delta(
                        insertions=extra)),
                    {"facts": norm(E, scratch(E, TC, base + extra,
                                              "1").decode_facts())}]
        if name == "delete_only":
            base = chain(E, 10)
            kb = scratch(E, TC, base, "1")
            return [call(E, kb, lambda kb: kb.materialize_delta(
                        deletions=[P("e(n4, n5)")])),
                    {"facts": norm(E, scratch(E, TC, base[:4] + base[5:],
                                              "1").decode_facts())}]
        if name == "mixed":
            base = chain(E, 8)
            kb = scratch(E, TC, base, "1")
            return [call(E, kb, lambda kb: kb.materialize_delta(
                        insertions=[P("e(m, n0)")],
                        deletions=[P("e(n3, n4)")])),
                    {"facts": norm(E, scratch(
                        E, TC, [P("e(m, n0)")] + base[:3] + base[4:],
                        "1").decode_facts())}]
        if name == "shallow":
            kb = scratch(E, TC, chain(E, 8), "1")
            return [call(E, kb, lambda kb: kb.materialize_delta(
                        insertions=[P("e(w0, w1)")]))]
        if name == "handoff":
            # prepending a chain edge cascades one closure hop per round
            base = chain(E, 16)
            kb = scratch(E, TC, base, "1")
            w1, w2 = P("e(w1, n0)"), P("e(w2, w1)")
            out = [call(E, kb, lambda kb: kb.materialize_delta(
                       insertions=[w1]))]
            out.append(call(E, kb, lambda kb: kb.materialize_delta(
                insertions=[w2])))
            for extra in ([w1], [w1, w2]):
                out.append({"facts": norm(E, scratch(
                    E, TC, base + extra, "1").decode_facts())})
            return out
        raise KeyError(name)
''')

FUSED_NAMES = ("chasebench-materialize_delta", "chasebench-insert_facts",
               "chasebench-delete_facts", "insert_only", "delete_only",
               "mixed", "shallow", "handoff")

FUSED_REFERENCE_RUN = textwrap.dedent("""
    import pickle, sys, types
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


@pytest.fixture(scope="module")
def fused_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "fused_deltas.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC)
    subprocess.run([sys.executable, "-c", FUSED_REFERENCE_RUN, str(path),
                    pickle.dumps((FUSED_SCENARIOS, FUSED_NAMES)).hex()],
                   check=True, env=env, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


@pytest.fixture
def fused_port(monkeypatch):
    from repro_torch.core.terms import parse_atom, parse_program
    from repro_torch.engine import faultinject, plan
    for var in ("REPRO_FUSED", "REPRO_CKPT_DIR", "REPRO_FAULT_SPEC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    ns = {}
    exec(FUSED_SCENARIOS, ns)
    env = types.SimpleNamespace(
        Atom=Atom, Null=Null, parse_atom=parse_atom,
        parse_program=parse_program, S=TS, ops=ops, plan=plan,
        materialize=materialize,
        kb=lambda prog, facts: EngineKB(prog, facts, device="cpu"))

    def run(name):
        try:
            return ns["scenario"](env, name)
        finally:
            os.environ.pop("REPRO_FUSED", None)
    return run


@pytest.mark.parametrize("name", FUSED_NAMES)
def test_fused_delta_matches_reference(fused_reference, fused_port, name):
    """Every call under ``REPRO_FUSED=1`` (and the scratch runs it is held
    to): facts, MatStats with ``extra``, SORT_STATS, count_pulls,
    fused_pulls and fused_retries, as the reference's."""
    got, want = fused_port(name), fused_reference[name]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, i)


@pytest.mark.parametrize("entry", ["materialize_delta", "insert_facts",
                                   "delete_facts"])
def test_fused_flag_on_chasebench_falls_back(fused_port, entry):
    """ChaseBench has existentials, outside the fused fragment: the call
    under ``REPRO_FUSED=1`` leaves no ``fused`` flag and equals the
    two-phase call."""
    two, fus = fused_port(f"chasebench-{entry}")
    assert "fused" not in fus["stats"][4]
    assert fus == two


@pytest.mark.parametrize("name", ["insert_only", "delete_only", "mixed"])
def test_fused_delta_matches_scratch(fused_port, name):
    st, scratch = fused_port(name)
    assert st["facts"] == scratch["facts"]


def test_shallow_delta_stays_two_phase(fused_port):
    """A disconnected edge converges in 2 rounds, below the hand-off."""
    (st,) = fused_port("shallow")
    assert st["stats"][0] <= 3 and "fused" not in st["stats"][4]
    assert st["fused_pulls"] == 0


def test_deep_cascade_hands_off_to_fused_warm_no_retries(fused_port):
    """Prepending a chain edge cascades one closure hop per round, so the
    call hands off to the fused executor; a second same-shaped delta plans
    from the memoized capacities (zero retries)."""
    first, second, want1, want2 = fused_port("handoff")
    assert first["stats"][4].get("fused") is True
    assert second["stats"][4].get("fused") is True
    assert second["fused_retries"] == 0
    assert first["facts"] == want1["facts"]
    assert second["facts"] == want2["facts"]
