"""The port's durable checkpoints, fault injection and crash recovery on
the two-phase and fused executors, on the CPU.

Ports the tests of ``tests/test_recovery.py``: the checkpoint store
(atomic save, checksums, fallback, GC), the fault primitives, the SIGTERM
guard, the run fingerprint, in-process resume, kill -9 / SIGTERM drills in
subprocesses (the fault really kills the process), and on the fused
executor the ``storm`` fault with its ``CapacityError`` diagnostic, the
spill to the two-phase executor after progress, and resume parity across
executors.  The reference checkpoints the same ``tc_chain`` run in one
subprocess (with the ``enable_x64`` shim of ``test_torch_materialize.py``);
the port must write the same files, tag for tag, and count the same.
"""
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from repro.engine import faultinject as ref_faultinject
from repro.engine import recovery as ref_recovery
from repro.data import kb_sources as RS
from repro_torch.core.terms import Null, parse_atom, parse_program
from repro_torch.data import kb_sources as TS
from repro_torch.engine import faultinject, ops, plan, recovery
from repro_torch.engine.fused import materialize_fused
from repro_torch.engine.materialize import EngineKB, materialize

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
N_CHAIN = 32

REFERENCE_RUN = textwrap.dedent("""
    import os, pickle, shutil, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    from repro.data import kb_sources as S
    from repro.engine import ops, recovery
    from repro.engine.materialize import EngineKB, materialize

    out_path, full, resume, n_chain = sys.argv[1:5]
    os.environ["REPRO_CKPT_KEEP"] = "100"

    def run(ckpt_dir):
        os.environ["REPRO_CKPT_DIR"] = ckpt_dir
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        kb = EngineKB(S.TC, S.tc_chain_facts(int(n_chain)))
        st = materialize(kb, mode="tg")
        return {"stats": (st.rounds, st.triggers, st.derived, st.mode,
                          dict(st.extra)),
                "sort_stats": dict(vars(ops.SORT_STATS)),
                "count_pulls": ops.HOST_SYNC_STATS.count_pulls,
                "facts": {(f.pred, f.args) for f in kb.decode_facts()}}

    out = {"full": run(full)}
    shutil.copytree(full, resume)
    mgr = recovery.RecoveryManager(resume, keep=100)
    tags = mgr.tags()
    out["mid"] = mid = tags[len(tags) // 2]
    for t in tags:
        if t > mid:
            mgr.drop(t)
    out["resumed"] = run(resume)
    out["finished"] = run(full)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""")


def _payload(i):
    return [{"store__e": (np.arange(6, dtype=np.int32) + i).reshape(3, 2)}]


@pytest.fixture
def ckpt_env(monkeypatch, tmp_path):
    """Checkpoints on, into ``tmp_path``, with no fault spec and a fresh
    per-spec cache (one-shot events fire once per process)."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setenv("REPRO_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CKPT_KEEP", "100")
    return tmp_path


def counters(kb, st):
    return {"stats": (st.rounds, st.triggers, st.derived, st.mode,
                      dict(st.extra)),
            "sort_stats": dict(vars(ops.SORT_STATS)),
            "count_pulls": ops.HOST_SYNC_STATS.count_pulls,
            "facts": {(f.pred, f.args) for f in kb.decode_facts()}}


def run_port(n_chain=N_CHAIN, mode="tg"):
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = EngineKB(TS.TC, TS.tc_chain_facts(n_chain), device="cpu")
    return kb, materialize(kb, mode=mode)


# ---------------------------------------------------------------------------
# RecoveryManager: atomic save, checksum validation, fallback, GC
# ---------------------------------------------------------------------------
def test_manager_save_load_roundtrip(tmp_path):
    mgr = recovery.RecoveryManager(str(tmp_path), keep=10)
    mgr.save(1, {"fingerprint": "fp", "rounds": 1}, _payload(1),
             {"dict.pkl": b"one"})
    mgr.save(2, {"fingerprint": "fp", "rounds": 2}, _payload(2),
             {"dict.pkl": b"two"})
    assert mgr.tags() == [1, 2]
    meta, shards, blobs = mgr.load("fp")
    assert meta["rounds"] == 2
    np.testing.assert_array_equal(
        shards[0]["store__e"], (np.arange(6, dtype=np.int32) + 2).reshape(3, 2))
    assert blobs["dict.pkl"] == b"two"
    # fingerprint mismatch: a different program's checkpoints never restore
    assert mgr.load("other-fp") is None


def test_manager_corrupt_payload_falls_back(tmp_path):
    mgr = recovery.RecoveryManager(str(tmp_path), keep=10)
    mgr.save(1, {"fingerprint": "fp", "rounds": 1}, _payload(1), {})
    mgr.save(2, {"fingerprint": "fp", "rounds": 2}, _payload(2), {})
    faultinject.corrupt_file(os.path.join(mgr._path(2), "shard_0.npz"))
    meta, _, _ = mgr.load("fp")
    assert meta["rounds"] == 1        # checksum catches the flip, falls back
    faultinject.corrupt_file(os.path.join(mgr._path(1), "shard_0.npz"))
    assert mgr.load("fp") is None     # nothing valid left


def test_manager_corrupt_manifest_skipped(tmp_path):
    mgr = recovery.RecoveryManager(str(tmp_path), keep=10)
    mgr.save(1, {"fingerprint": "fp", "rounds": 1}, _payload(1), {})
    mgr.save(2, {"fingerprint": "fp", "rounds": 2}, _payload(2), {})
    with open(os.path.join(mgr._path(2), "MANIFEST.json"), "w") as f:
        f.write("{ not json")
    meta, _, _ = mgr.load("fp")
    assert meta["rounds"] == 1


def test_manager_gc_and_tmp_litter(tmp_path):
    mgr = recovery.RecoveryManager(str(tmp_path), keep=2)
    for t in range(1, 5):
        mgr.save(t, {"fingerprint": "fp", "rounds": t}, _payload(t), {})
    assert mgr.tags() == [3, 4]       # GC kept the newest `keep`
    # a crashed save leaves a .tmp dir and a manifest-less dir: both ignored
    os.makedirs(tmp_path / ".tmp_ckpt_00000009")
    os.makedirs(tmp_path / "ckpt_00000010")
    assert mgr.tags() == [3, 4]
    meta, _, _ = mgr.load("fp")
    assert meta["rounds"] == 4


# ---------------------------------------------------------------------------
# fault injection primitives
# ---------------------------------------------------------------------------
def test_faultspec_parsing():
    fs = faultinject.FaultSpec("crash:round=7,sleep:round=2:secs=0.5,storm")
    assert fs.active and fs.tiny_caps()
    assert fs._round_of("crash") == 7
    assert fs.events["sleep"] == {"round": "2", "secs": "0.5"}
    empty = faultinject.FaultSpec("")
    assert not empty.active and not empty.tiny_caps()
    empty.on_boundary(10)             # all hooks are no-ops when empty


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_corrupt_file_flips_one_byte(tmp_path, seed):
    """One byte flips, the reference's byte for the same seed."""
    data = bytes(range(200))
    got = []
    for mod in (faultinject, ref_faultinject):
        p = tmp_path / f"blob_{mod is faultinject}"
        p.write_bytes(data)
        mod.corrupt_file(str(p), seed=seed)
        got.append(p.read_bytes())
    assert len(got[0]) == 200 and sum(a != b
                                      for a, b in zip(got[0], data)) == 1
    assert got[0] == got[1]
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    faultinject.corrupt_file(str(empty))
    assert empty.read_bytes() == b"\xff"


def test_ckpt_corrupt_event_one_shot(tmp_path):
    mgr = recovery.RecoveryManager(str(tmp_path), keep=10)
    for t in (1, 2, 3):
        mgr.save(t, {"fingerprint": "fp", "rounds": t}, _payload(t), {})
    spec = faultinject.FaultSpec("ckpt_corrupt:tag=2")
    spec.on_checkpoint(mgr._path(1), 1)   # below the tag threshold: no-op
    assert mgr._load_one(1, "fp") is not None
    spec.on_checkpoint(mgr._path(2), 2)   # fires exactly here
    assert mgr._load_one(2, "fp") is None
    spec.on_checkpoint(mgr._path(3), 3)   # one-shot: tag 3 stays intact
    assert mgr._load_one(3, "fp") is not None
    mgr.drop(3)
    meta, _, _ = mgr.load("fp")           # skips the corrupt tag 2
    assert meta["rounds"] == 1


def test_preemption_guard_chains_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        g = recovery.PreemptionGuard(signals=(signal.SIGUSR1,), chain=True)
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.01)
        assert g.requested
        assert seen == [signal.SIGUSR1]   # chained to the outer handler
        g.restore()
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_kb_fingerprint_identity():
    kb = EngineKB(TS.TC, TS.tc_chain_facts(4), device="cpu")
    assert recovery.kb_fingerprint(kb, "tg") == recovery.kb_fingerprint(
        EngineKB(TS.TC, TS.tc_chain_facts(8), device="cpu"), "tg")
    assert recovery.kb_fingerprint(kb, "tg") != \
        recovery.kb_fingerprint(kb, "tg_noopt")


@pytest.mark.parametrize("prog", ["TC", "LUBM_L", "RHO_DF", "CHASEBENCH"])
@pytest.mark.parametrize("dtype", ["int16", "int32", "int64"])
def test_kb_fingerprint_is_the_references(prog, dtype):
    """Same program, mode and dtype: the reference's hex string (the
    normalized programs' rules print alike)."""
    kb = EngineKB(getattr(TS, prog), (), dtype=dtype, device="cpu")
    ref_kb = types.SimpleNamespace(
        program=getattr(RS, prog).normalize(),
        dict=types.SimpleNamespace(id_dtype=np.dtype(dtype)))
    assert [repr(r) for r in kb.program.rules] == \
        [repr(r) for r in ref_kb.program.rules]
    for mode in ("seminaive", "tg", "tg_noopt"):
        assert recovery.kb_fingerprint(kb, mode) == \
            ref_recovery.kb_fingerprint(ref_kb, mode)


def test_loader_refuses_reference_classes():
    blob = pickle.dumps({"null": ref_faultinject.FaultSpec("")})
    with pytest.raises(pickle.UnpicklingError, match="reference"):
        recovery.load_dict_state(blob)
    state = {"to_id": {"a": 0}, "null": Null(3)}
    assert recovery.load_dict_state(pickle.dumps(state)) == state


# ---------------------------------------------------------------------------
# against the reference: the same counters and the same files
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    subprocess.run([sys.executable, "-c", REFERENCE_RUN,
                    str(root / "out.pkl"), str(root / "full"),
                    str(root / "resume"), str(N_CHAIN)],
                   check=True, env=env, timeout=900)
    with open(root / "out.pkl", "rb") as f:
        out = pickle.load(f)      # written by the subprocess above
    out["dir"] = root / "full"
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's checkpointed run, its resume from the middle tag, and a
    resume of the finished run, as in the reference subprocess."""
    root = tmp_path_factory.mktemp("port")
    mp = pytest.MonkeyPatch()
    try:
        mp.delenv("REPRO_FAULT_SPEC", raising=False)
        mp.setattr(faultinject, "_CACHE", {})
        mp.setenv("REPRO_CKPT_KEEP", "100")
        out = {}
        mp.setenv("REPRO_CKPT_DIR", str(root / "full"))
        out["full"] = counters(*run_port())
        shutil.copytree(root / "full", root / "resume")
        mgr = recovery.RecoveryManager(str(root / "resume"), keep=100)
        tags = mgr.tags()
        out["mid"] = mid = tags[len(tags) // 2]
        for t in tags:
            if t > mid:
                mgr.drop(t)
        mp.setenv("REPRO_CKPT_DIR", str(root / "resume"))
        out["resumed"] = counters(*run_port())
        mp.setenv("REPRO_CKPT_DIR", str(root / "full"))
        out["finished"] = counters(*run_port())
    finally:
        mp.undo()
    out["dir"] = root / "full"
    return out


@pytest.mark.parametrize("run", ["full", "resumed", "finished"])
def test_counters_match_reference(reference, port_runs, run):
    """Checkpointed, resumed and finished-resumed runs: facts, MatStats
    with ``extra`` (``checkpoints``, ``resumed_rounds``), SORT_STATS, and
    ``count_pulls`` (a save pulls nothing through the counter)."""
    assert port_runs["mid"] == reference["mid"]
    assert port_runs[run] == reference[run]


def test_counters_with_checkpoints_off_are_unchanged(reference, port_runs,
                                                     monkeypatch):
    monkeypatch.delenv("REPRO_CKPT_DIR", raising=False)
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    plain = counters(*run_port())
    full = reference["full"]
    assert plain["stats"][:4] == full["stats"][:4]
    assert plain["stats"][4] == {}
    assert (plain["sort_stats"], plain["count_pulls"], plain["facts"]) == \
        (full["sort_stats"], full["count_pulls"], full["facts"])


def _read_ckpt(path):
    with open(path / "MANIFEST.json") as f:
        manifest = json.load(f)
    with np.load(path / "shard_0.npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(path / "dict.pkl", "rb") as f:
        state = pickle.load(f)    # the test's own checkpoint files
    return manifest, arrays, state


def _norm_state(state):
    """A Dictionary state with nulls in keys named ("null", nid) and numpy
    arrays as (dtype, list) pairs."""
    def key(t):
        return ("null", t.nid) if type(t).__name__ == "Null" else t

    def val(v):
        if isinstance(v, np.ndarray):
            return (str(v.dtype), v.tolist())
        if isinstance(v, dict):
            return {key(k): val(x) for k, x in v.items()}
        return v
    return {k: val(v) for k, v in state.items()}


def test_checkpoint_files_match_reference(reference, port_runs):
    """Tag for tag: the manifest's entries (checksums aside), the meta,
    the npz keys and arrays, and the dictionary state."""
    ref_dir, port_dir = reference["dir"], port_runs["dir"]
    tags = sorted(os.listdir(ref_dir))
    assert tags == sorted(os.listdir(port_dir)) and len(tags) == N_CHAIN + 1
    for tag in tags:
        rm, ra, rs = _read_ckpt(ref_dir / tag)
        pm, pa, ps = _read_ckpt(port_dir / tag)
        assert (pm["format"], pm["tag"], pm["meta"]) == \
            (rm["format"], rm["tag"], rm["meta"]), tag
        assert pm["meta"]["executor"] == "two-phase"
        assert sorted(pm["files"]) == sorted(rm["files"]) == \
            ["dict.pkl", "shard_0.npz"]
        assert sorted(pa) == sorted(ra), tag
        for k in ra:
            assert pa[k].dtype == ra[k].dtype and \
                np.array_equal(pa[k], ra[k]), (tag, k)
        assert _norm_state(ps) == _norm_state(rs), tag


# ---------------------------------------------------------------------------
# in-process resume (two-phase)
# ---------------------------------------------------------------------------
def test_midrun_resume_exact_parity(ckpt_env):
    """Run to completion with checkpointing, rewind the checkpoint store
    to a mid-run tag, and resume with a fresh KB: the continued run must
    reach the identical closure, rounds, triggers and derived."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_CKPT_DIR")
        ref, st_ref = run_port(14)
    kb1, st1 = run_port(14)
    assert st1.extra.get("checkpoints", 0) >= 2
    assert kb1.decode_facts() == ref.decode_facts()
    mgr = recovery.RecoveryManager(str(ckpt_env), keep=100)
    tags = mgr.tags()
    mid = tags[len(tags) // 2]
    assert 0 < mid < st_ref.rounds
    for t in tags:
        if t > mid:
            mgr.drop(t)
    kb2, st2 = run_port(14)
    assert st2.extra.get("resumed_rounds") == mid
    assert st2.extra.get("resumed_from") == ("two-phase", 1)
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st_ref.rounds, st_ref.triggers, st_ref.derived)
    assert kb2.decode_facts() == ref.decode_facts()


def test_resume_of_finished_run_is_noop(ckpt_env):
    kb1, st1 = run_port(10)
    kb2, st2 = run_port(10)
    assert st2.extra.get("resumed_rounds") == st1.rounds
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st1.rounds, st1.triggers, st1.derived)    # nothing re-derived
    assert kb2.decode_facts() == kb1.decode_facts()


def test_resume_restores_nulls(ckpt_env):
    """ChaseBench has existentials: a mid-run resume gives the same null
    ids as the uninterrupted run."""
    def run():
        kb = EngineKB(TS.CHASEBENCH, TS.chasebench_facts(n=30), device="cpu")
        return kb, materialize(kb, mode="tg")
    kb1, st1 = run()
    mgr = recovery.RecoveryManager(str(ckpt_env), keep=100)
    for t in mgr.tags()[1:]:
        mgr.drop(t)
    kb2, st2 = run()
    assert st2.extra["resumed_rounds"] == 1 < st1.rounds == st2.rounds
    assert kb2.decode_facts() == kb1.decode_facts()
    assert kb2.dict.num_nulls == kb1.dict.num_nulls > 0


def test_ckpt_corrupt_falls_back_then_resumes(ckpt_env, monkeypatch):
    """``ckpt_corrupt:tag=3`` flips a byte of the checkpoint of round 3;
    the loader skips it and a resume from round 2 reaches parity."""
    monkeypatch.setenv("REPRO_CKPT_KEEP", "100")
    kb1, st1 = run_port(10)
    monkeypatch.setenv("REPRO_FAULT_SPEC", "ckpt_corrupt:tag=3")
    monkeypatch.setenv("REPRO_CKPT_DIR", str(ckpt_env / "corrupt"))
    run_port(10)
    mgr = recovery.RecoveryManager(str(ckpt_env / "corrupt"), keep=100)
    for t in mgr.tags()[3:]:
        mgr.drop(t)
    assert mgr.tags() == [1, 2, 3]
    fp = recovery.kb_fingerprint(kb1, "tg")
    assert mgr._load_one(3, fp) is None
    assert mgr.load(fp)[0]["rounds"] == 2
    kb2, st2 = run_port(10)
    assert st2.extra["resumed_rounds"] == 2
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st1.rounds, st1.triggers, st1.derived)
    assert kb2.decode_facts() == kb1.decode_facts()


def test_fault_spec_sleep_is_honoured(monkeypatch):
    """``sleep:round=3`` sleeps at every boundary from round 3 on, with
    checkpoints off: the executor's rounds plus its final boundary."""
    monkeypatch.delenv("REPRO_CKPT_DIR", raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setenv("REPRO_FAULT_SPEC", "sleep:round=3:secs=0.02")
    slept = []
    monkeypatch.setattr(faultinject.time, "sleep", slept.append)
    _, st = run_port(8)
    assert st.rounds == 9
    assert slept == [0.02] * (st.rounds - 3 + 2)


# ---------------------------------------------------------------------------
# subprocess crash drills: SIGKILL / SIGTERM
# ---------------------------------------------------------------------------
_RUN_SCRIPT = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, %r)
    from repro_torch.data.kb_sources import LUBM_L, lubm_facts
    from repro_torch.engine.materialize import EngineKB, materialize

    if sys.argv[1] == "reference":
        os.environ.pop("REPRO_CKPT_DIR")
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=2), device="cpu")
    st = materialize(kb, mode="tg")
    print(json.dumps({
        "facts": sorted(map(str, kb.decode_facts())),
        "stats": [st.rounds, st.triggers, st.derived],
        "resumed_rounds": st.extra.get("resumed_rounds", 0)}))
""" % SRC)


def _run(arg, env):
    full = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    full.update(env)
    return subprocess.run([sys.executable, "-c", _RUN_SCRIPT, arg],
                          capture_output=True, text=True, timeout=600,
                          env=full)


@pytest.mark.parametrize("fault", ["crash", "sigterm"])
def test_fault_then_resume_subprocess(tmp_path, fault):
    """``crash:round=2`` dies by SIGKILL, ``sigterm:round=2`` saves and
    exits 143 at the next boundary; a fresh process resumes from the
    newest checkpoint to the uninterrupted run's facts and counts."""
    env = {"REPRO_CKPT_DIR": str(tmp_path), "REPRO_CKPT_KEEP": "100"}
    r = _run("run", {**env, "REPRO_FAULT_SPEC": f"{fault}:round=2"})
    want_rc = -signal.SIGKILL if fault == "crash" else 143
    assert r.returncode == want_rc, (r.returncode, r.stderr[-2000:])
    assert not r.stdout
    loaded = recovery.RecoveryManager(str(tmp_path)).load()
    assert loaded is not None, "no valid checkpoint left behind"
    saved = loaded[0]["rounds"]
    assert saved == (2 if fault == "crash" else 3)

    ref = _run("reference", env)
    r = _run("run", env)
    assert ref.returncode == 0 and r.returncode == 0, r.stderr[-2000:]
    want, got = json.loads(ref.stdout), json.loads(r.stdout)
    assert got["resumed_rounds"] == saved
    assert (got["facts"], got["stats"]) == (want["facts"], want["stats"])


# ---------------------------------------------------------------------------
# the fused executor: storm, spill, resume across executors
# ---------------------------------------------------------------------------
def _chain(n, extra=0, seed=0):
    rng = np.random.default_rng(seed)
    edges = [(i, i + 1) for i in range(n)]
    edges += [tuple(e) for e in rng.integers(0, n, (extra, 2))]
    return [parse_atom(f"e(v{a}, v{b})") for a, b in edges]


def _kb(prog, facts):
    return EngineKB(prog, facts, device="cpu")


@pytest.fixture
def fused_env(monkeypatch):
    """No checkpoints, no faults, an empty capacity memo."""
    for var in ("REPRO_FUSED", "REPRO_CKPT_DIR", "REPRO_FAULT_SPEC",
                "REPRO_MAX_RETRIES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    return monkeypatch


def test_storm_exhausts_budget_with_diagnostic(fused_env):
    """Under a forced-overflow storm with a 1-attempt budget the fused
    executor raises a diagnostic CapacityError (spill=False), returns None
    (spill=True, no progress yet), and ``materialize`` still reaches the
    closure on the two-phase executor."""
    fused_env.setenv("REPRO_FAULT_SPEC", "storm")
    fused_env.setenv("REPRO_MAX_RETRIES", "1")
    # the planner's cold-start floor is 64 delta rows (one doubling: 128);
    # a >128-row extensional delta exhausts a 1-attempt ladder for certain
    B = _chain(200, extra=50, seed=1)
    with pytest.raises(plan.CapacityError) as ei:
        materialize_fused(_kb(TS.TC, B), mode="tg", spill=False)
    assert ei.value.requested_bytes > 0 and ei.value.label is not None
    assert "REPRO_MAX_RETRIES=1" in str(ei.value)
    assert materialize_fused(_kb(TS.TC, B), mode="tg") is None
    fused_env.setenv("REPRO_FUSED", "1")
    kb = _kb(TS.TC, B)
    st = materialize(kb, mode="tg")
    assert st.extra.get("fused") is not True
    fused_env.delenv("REPRO_FUSED")
    fused_env.delenv("REPRO_FAULT_SPEC")
    fused_env.setattr(faultinject, "_CACHE", {})
    ref = _kb(TS.TC, B)
    materialize(ref, mode="tg")
    assert kb.decode_facts() == ref.decode_facts()


def test_midrun_capacity_spill_to_two_phase(fused_env):
    """A capacity ladder that diverges AFTER committed progress keeps that
    progress: the fused executor writes back its last good state and the
    two-phase executor finishes the fixpoint."""
    prog = parse_program("""
        s(X) -> t(X)
        t(X) & e(X, Y) -> t(Y)
    """)
    B = [parse_atom("s(v0)")] + \
        [parse_atom(f"e(v0, w{i})") for i in range(100)]
    ref = _kb(prog, B)
    materialize(ref, mode="tg")
    fused_env.setenv("REPRO_MAX_RETRIES", "2")

    # t's delta bucket fits round 1 (1 fresh row) but the 100-row fan-out
    # round overflows past the 2-attempt ladder (8 -> 16 -> 32)
    def small_delta(self, pred):
        if pred not in self.delta:
            self.delta[pred] = 8 if pred == "t" else 256
        return self.delta[pred]
    fused_env.setattr(plan._Caps, "delta_cap", small_delta)
    kb = _kb(prog, B)
    st = materialize_fused(kb, mode="tg")
    assert st is not None
    assert "capacity bucket" in st.extra["spilled"]
    assert kb.decode_facts() == ref.decode_facts()
    assert all(rel.is_lexsorted for rel in kb.rels.values())


def _rewind_to_middle(path, rounds):
    mgr = recovery.RecoveryManager(str(path), keep=100)
    tags = mgr.tags()
    mid = tags[len(tags) // 2]
    assert 0 < mid < rounds
    for t in tags:
        if t > mid:
            mgr.drop(t)
    return mid


def test_midrun_resume_exact_parity_fused(fused_env, ckpt_env):
    """A fused run checkpoints at its pull boundaries (with its capacity
    plan); rewound to a middle tag, a fresh KB resumes on the fused
    executor to the uninterrupted closure and counts."""
    B = _chain(14, extra=6, seed=5)
    fused_env.delenv("REPRO_CKPT_DIR", raising=False)
    ref = _kb(TS.TC, B)
    st_ref = materialize(ref, mode="tg")
    fused_env.setenv("REPRO_CKPT_DIR", str(ckpt_env))
    fused_env.setenv("REPRO_FUSED", "1")
    kb1 = _kb(TS.TC, B)
    st1 = materialize(kb1, mode="tg")
    assert st1.extra.get("fused") is True
    assert st1.extra.get("checkpoints", 0) >= 2
    assert kb1.decode_facts() == ref.decode_facts()
    files = os.listdir(recovery.RecoveryManager(str(ckpt_env))._path(
        st1.rounds))
    assert "caps.pkl" in files
    mid = _rewind_to_middle(ckpt_env, st_ref.rounds)
    kb2 = _kb(TS.TC, B)
    st2 = materialize(kb2, mode="tg")
    assert st2.extra.get("resumed_rounds") == mid
    assert st2.extra.get("resumed_from") == ("fused", 1)
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st_ref.rounds, st_ref.triggers, st_ref.derived)
    assert kb2.decode_facts() == ref.decode_facts()


def test_resume_of_finished_fused_run_is_noop(fused_env, ckpt_env):
    fused_env.setenv("REPRO_FUSED", "1")
    B = _chain(10, extra=4, seed=2)
    kb1 = _kb(TS.TC, B)
    st1 = materialize(kb1, mode="tg")
    kb2 = _kb(TS.TC, B)
    st2 = materialize(kb2, mode="tg")
    assert st2.extra.get("resumed_rounds") == st1.rounds
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st1.rounds, st1.triggers, st1.derived)
    assert kb2.decode_facts() == kb1.decode_facts()


@pytest.mark.parametrize("first", ["fused", "two-phase"])
def test_cross_executor_restore(fused_env, ckpt_env, first):
    """Checkpoints are executor-neutral host state: one written mid-run by
    either executor resumes on the other."""
    B = _chain(14, extra=6, seed=5)
    fused_env.delenv("REPRO_CKPT_DIR", raising=False)
    ref = _kb(TS.TC, B)
    st_ref = materialize(ref, mode="tg")
    fused_env.setenv("REPRO_CKPT_DIR", str(ckpt_env))
    fused_env.setenv("REPRO_FUSED", "1" if first == "fused" else "0")
    materialize(_kb(TS.TC, B), mode="tg")
    mid = _rewind_to_middle(ckpt_env, st_ref.rounds)
    fused_env.setenv("REPRO_FUSED", "0" if first == "fused" else "1")
    kb2 = _kb(TS.TC, B)
    st2 = materialize(kb2, mode="tg")
    assert st2.extra.get("resumed_rounds") == mid
    assert st2.extra.get("resumed_from", (None,))[0] == first
    assert (st2.extra.get("fused") is True) == (first == "two-phase")
    assert (st2.rounds, st2.triggers, st2.derived) == \
        (st_ref.rounds, st_ref.triggers, st_ref.derived)
    assert kb2.decode_facts() == ref.decode_facts()
