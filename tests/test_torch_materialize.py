"""The port's two-phase materialization on the CPU against the JAX reference.

The reference engine needs ``jax.experimental.enable_x64``, which the
installed jax no longer has.  It therefore runs in ONE module-scoped
subprocess with a shim for it; applying the shim in-process would leak
shimmed traces through the reference's ``lru_cache``d jitted functions into
the reference's own tests on the same worker.  The subprocess materializes
every case in every mode and hands back the fact sets, ``rounds``,
``triggers``, ``derived``, ``SORT_STATS`` and ``count_pulls``; the port
must reproduce all of them.  The module also carries a reference base KB
into the port with ``EngineKB.from_host_state`` and checks one Datalog
case against the symbolic chase in-process.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core.chase import chase
from repro.data import kb_sources as RS
from repro_torch.core.terms import Null
from repro_torch.data import kb_sources as TS
from repro_torch.engine import ops
from repro_torch.engine.materialize import EngineKB, materialize

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODES = ("seminaive", "tg", "tg_noopt")
# name -> (program name, generator name, kwargs); the generators exist in
# both packages under the same names
CASES = {
    "lubm_l": ("LUBM_L", "lubm_facts", {"n_univ": 2}),
    "tc_chain": ("TC", "tc_chain_facts", {"n_chain": 32}),
    "rho_df": ("RHO_DF", "rho_df_facts",
               {"n_classes": 10, "n_props": 5, "n_instances": 100}),
    "chasebench": ("CHASEBENCH", "chasebench_facts", {"n": 30}),
}
# the streamed-ingest case: tc_wide edges in many small chunks
STREAM = {"n_chains": 50, "chunk_rows": 37}

REFERENCE_RUN = textwrap.dedent("""
    import pickle, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.core.terms import Null
    from repro.data import kb_sources as S
    from repro.engine import ops
    from repro.engine.materialize import EngineKB, _host_state, materialize

    def norm(facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, Null) else t
                               for t in f.args)) for f in facts}

    def result(kb, st):
        return {"facts": norm(kb.decode_facts()), "rounds": st.rounds,
                "triggers": st.triggers, "derived": st.derived,
                "sort_stats": dict(vars(ops.SORT_STATS)),
                "count_pulls": ops.HOST_SYNC_STATS.count_pulls}

    cases, stream = pickle.loads(bytes.fromhex(sys.argv[2]))
    out = {"runs": {}}
    for name, (prog, gen, kw) in cases.items():
        program, facts = getattr(S, prog), getattr(S, gen)(**kw)
        for mode in ("seminaive", "tg", "tg_noopt"):
            ops.SORT_STATS.reset()
            ops.HOST_SYNC_STATS.reset()
            kb = EngineKB(program, facts)
            out["runs"][name, mode] = result(kb, materialize(kb, mode=mode))
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = EngineKB.from_stream(S.TC, S.tc_wide_chunks(**stream))
    out["stream"] = result(kb, materialize(kb, mode="tg"))
    kb = EngineKB(S.LUBM_L, S.lubm_facts(n_univ=2))
    out["host_state"] = (_host_state(kb, {})[0], kb.dict.state_dict())
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def norm(facts):
    return {(f.pred, tuple(("null", t.nid) if isinstance(t, Null) else t
                           for t in f.args)) for f in facts}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "runs.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(SRC)
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path),
                    pickle.dumps((CASES, STREAM)).hex()], check=True, env=env,
                   timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


def run_port(name, mode):
    prog, gen, kw = CASES[name]
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = EngineKB(getattr(TS, prog), getattr(TS, gen)(**kw), device="cpu")
    st = materialize(kb, mode=mode)
    return kb, st


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_reference(reference, name, mode):
    want = reference["runs"][name, mode]
    kb, st = run_port(name, mode)
    assert norm(kb.decode_facts()) == want["facts"]
    assert (st.rounds, st.triggers, st.derived) == \
        (want["rounds"], want["triggers"], want["derived"])
    assert dict(vars(ops.SORT_STATS)) == want["sort_stats"]
    assert ops.HOST_SYNC_STATS.count_pulls == want["count_pulls"]


def test_reference_counts_as_published(reference):
    """The reference numbers this slice was specified against."""
    runs = reference["runs"]
    assert [runs["lubm_l", m]["triggers"] for m in MODES] == [3038, 2948, 3004]
    assert len(runs["lubm_l", "tg"]["facts"]) == 3034
    assert [runs["tc_chain", m]["rounds"] for m in MODES] == [32, 33, 33]
    assert {runs["chasebench", m]["triggers"] for m in MODES} == {330}


# the data sources that the cases above do not run
SOURCES = {
    "lubm_li": ("LUBM_LI", "lubm_facts", {"n_univ": 2}),
    "lubm_le": ("LUBM_LE", "lubm_facts", {"n_univ": 1}),
    "tc_random": ("TC", "tc_random_facts", {"n_nodes": 50, "n_edges": 120}),
}


@pytest.mark.parametrize("name", sorted(CASES) + sorted(SOURCES))
def test_generators_match_reference(name):
    prog, gen, kw = {**CASES, **SOURCES}[name]
    ref = [(f.pred, f.args) for f in getattr(RS, gen)(**kw)]
    port = [(f.pred, f.args) for f in getattr(TS, gen)(**kw)]
    assert port == ref
    assert repr(getattr(TS, prog)) == repr(getattr(RS, prog))


@pytest.mark.parametrize("kw", [
    {"n_chains": 50, "chunk_rows": 37},
    {"n_chains": 1000, "chain_len": 6, "dtype": "int16"},
    {"n_chains": 300, "chain_len": 3, "chunk_rows": 1 << 10,
     "dtype": "int64"}])
def test_stream_generators_match_reference(kw):
    ref = list(RS.tc_wide_chunks(**kw))
    port = list(TS.tc_wide_chunks(**kw))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (_, got), (_, want) in zip(port, ref):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    args = {k: v for k, v in kw.items() if k in ("n_chains", "chain_len")}
    assert TS.tc_wide_total(**args) == RS.tc_wide_total(**args)


@pytest.mark.parametrize("name", sorted(RS.SCENARIOS))
def test_scenarios_match_reference(name):
    (rprog, rgen), (tprog, tgen) = RS.SCENARIOS[name], TS.SCENARIOS[name]
    assert repr(tprog) == repr(rprog)
    assert repr(TS.linear_subset(tprog)) == repr(RS.linear_subset(rprog))
    assert [(f.pred, f.args) for f in tgen(2)] == \
        [(f.pred, f.args) for f in rgen(2)]


@pytest.mark.parametrize("name", sorted(RS.STREAM_SCENARIOS))
def test_stream_scenarios_match_reference(name):
    (rprog, rgen), (tprog, tgen) = (RS.STREAM_SCENARIOS[name],
                                     TS.STREAM_SCENARIOS[name])
    assert repr(tprog) == repr(rprog)
    ref, port = list(rgen(5000)), list(tgen(5000))
    assert [p for p, _ in port] == [p for p, _ in ref] != []
    assert all(got.dtype == want.dtype and np.array_equal(got, want)
               for (_, got), (_, want) in zip(port, ref))


def test_random_chunks_match_reference():
    kw = dict(n_nodes=300, n_edges=1000, seed=7, chunk_rows=333,
              dtype="int16")
    ref = list(RS.tc_random_chunks(**kw))
    port = list(TS.tc_random_chunks(**kw))
    assert len(port) == len(ref) == 4
    assert all(got.dtype == want.dtype and np.array_equal(got, want)
               for (_, got), (_, want) in zip(port, ref))


def test_from_host_state_carries_a_reference_kb(reference):
    """A base KB built by the reference, carried into the port as host
    arrays, materializes to the reference's result; ``host_state`` gives
    the carried state back."""
    payload, dict_state = reference["host_state"]
    kb = EngineKB.from_host_state(TS.LUBM_L, payload, dict_state,
                                  device="cpu")
    back, back_dict = kb.host_state()
    for key, rows in back.items():
        assert (rows == payload[key]).all(), key
    assert back_dict["to_id"] == dict_state["to_id"]
    st = materialize(kb, mode="tg")
    want = reference["runs"]["lubm_l", "tg"]
    assert norm(kb.decode_facts()) == want["facts"]
    assert (st.rounds, st.triggers, st.derived) == \
        (want["rounds"], want["triggers"], want["derived"])


def test_tc_chain_matches_the_chase():
    facts = RS.tc_chain_facts(24)
    ch = chase(RS.TC, facts)
    assert ch.terminated
    kb = EngineKB(TS.TC, TS.tc_chain_facts(24), device="cpu")
    materialize(kb, mode="tg")
    assert norm(kb.decode_facts()) == norm(set(ch.facts) | set(facts))


@pytest.mark.parametrize("dtype", ["int16", "int64"])
def test_store_dtypes_agree(dtype):
    """The int16 and int64 stores derive what the int32 store derives
    (int64 arity-2 rows take the per-column search path)."""
    kb32, st32 = run_port("chasebench", "tg")
    prog, gen, kw = CASES["chasebench"]
    kb = EngineKB(getattr(TS, prog), getattr(TS, gen)(**kw), dtype=dtype,
                  device="cpu")
    st = materialize(kb, mode="tg")
    assert norm(kb.decode_facts()) == norm(kb32.decode_facts())
    assert (st.rounds, st.triggers) == (st32.rounds, st32.triggers)


def test_stream_ingest_matches_atom_ingest(reference):
    """Streamed ingest in many small chunks, then ``tg``: the reference's
    facts and counters (ingest's own sorts and pulls included)."""
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = EngineKB.from_stream(TS.TC, TS.tc_wide_chunks(**STREAM),
                              device="cpu")
    st = materialize(kb, mode="tg")
    want = reference["stream"]
    assert norm(kb.decode_facts()) == want["facts"]
    assert (st.rounds, st.triggers, st.derived) == \
        (want["rounds"], want["triggers"], want["derived"])
    assert dict(vars(ops.SORT_STATS)) == want["sort_stats"]
    assert ops.HOST_SYNC_STATS.count_pulls == want["count_pulls"]
    facts = sum(r.count for p, r in kb.rels.items() if "~" not in p)
    assert facts == TS.tc_wide_total(STREAM["n_chains"])
    with pytest.raises(ValueError):
        kb.ingest_rows("e", [[1, 2, 3]])
