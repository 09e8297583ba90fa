"""The port's sharded executor (``backend="dist"``) on the CPU against the
JAX reference's own sharded runs.

The reference runs in ONE module-scoped subprocess on eight virtual CPU
devices (``--xla_force_host_platform_device_count=8``), with the shims this
tree's jax needs (``jax.experimental.enable_x64`` and ``shard_map`` without
its ``check_vma`` pass).  The scenarios are one piece of source
(``SCENARIOS``) run against either package, the same cases in the same
order: each starts from reset counters, an empty capacity memo and no
built programs, because the reference's counters depend on ndev, on
``REPRO_DIST_FIXPOINT`` and on the memo.  Each run hands back the facts,
``rounds``, ``triggers``, ``derived``, ``MatStats.extra``, ``SORT_STATS``,
``count_pulls`` and the fused and sharded host-sync counters; the port
must reproduce all of them.  The hashes, the bucketizer and the run merge
are held against the reference in-process.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import types
from collections import defaultdict

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import distributed as RD
from repro_torch.core import terms as TT
from repro_torch.data import kb_sources as TS
from repro_torch.engine import distributed as D
from repro_torch.engine import faultinject, ops, plan
from repro_torch.engine import recovery
from repro_torch.engine.materialize import EngineKB, materialize

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))

# One piece of source, run against either package: ``E`` carries the
# package's modules, a ``kb(program, facts)`` factory, ``set_ndev(n)`` (the
# shard count ``materialize(backend="dist")`` takes when none is named),
# ``dist(kb, ndev, **kw)`` (``materialize_distributed``) and ``tc(edges,
# ndev)`` (``run_distributed_tc``).
SCENARIOS = textwrap.dedent('''
    import os
    import shutil

    EXIST = "p(X, Y) -> Q(X, Y)\\nQ(X, Y) & Q(Y, Z) -> exists W. Q(Z, W)"
    FLAGS = ("REPRO_DIST", "REPRO_DIST_FIXPOINT", "REPRO_FUSED",
             "REPRO_FAULT_SPEC", "REPRO_MAX_RETRIES", "REPRO_CKPT_DIR",
             "REPRO_CKPT_KEEP")

    def norm(E, facts):
        return {(f.pred, tuple(("null", t.nid) if isinstance(t, E.Null)
                               else t for t in f.args)) for f in facts}

    def reset(E, **env):
        for k in FLAGS:
            os.environ.pop(k, None)
        os.environ.update(env)
        E.faultinject._CACHE.clear()
        E.plan._CAP_MEMO.clear()
        E.clear_programs()
        E.ops.HOST_SYNC_STATS.reset()
        E.ops.SORT_STATS.reset()

    def result(E, kb, st):
        h = E.ops.HOST_SYNC_STATS
        out = {"facts": norm(E, kb.decode_facts()),
               "sort_stats": dict(vars(E.ops.SORT_STATS))}
        out.update({k: getattr(h, k) for k in (
            "count_pulls", "fused_pulls", "fused_retries", "dist_pulls",
            "dist_retries", "dist_fixpoint_pulls", "dist_fixpoint_iters")})
        if st is not None:
            out.update(rounds=st.rounds, triggers=st.triggers,
                       derived=st.derived, extra=dict(st.extra),
                       mode=st.mode)
        return out

    def run(E, prog, facts, ndev, entry="backend", mode="tg", env=None,
            **kw):
        reset(E, **(env or {}))
        kb = E.kb(prog, facts)
        E.set_ndev(ndev)
        if entry == "backend":
            st = E.materialize(kb, mode=mode, backend="dist", **kw)
        elif entry == "env":
            os.environ["REPRO_DIST"] = "1"
            st = E.materialize(kb, mode=mode, **kw)
        else:
            st = E.dist(kb, ndev, mode=mode, **kw)
        return result(E, kb, st)

    def chain(E, n):
        return E.S.tc_chain_facts(n)

    def read_tag(path):
        import json
        import numpy as np
        with open(os.path.join(path, "MANIFEST.json")) as f:
            meta = json.load(f)["meta"]
        files = {}
        for fn in sorted(os.listdir(path)):
            if fn.endswith(".npz"):
                with np.load(os.path.join(path, fn)) as z:
                    files[fn] = {k: (str(z[k].dtype), z[k].shape,
                                     z[k].tolist()) for k in z.files}
        return meta, files

    def checkpoints(E, tmp):
        """A checkpointed ndev-4 run, rewound to a mid-run tag and resumed
        at ndev 4, at ndev 2, on the fused and on the two-phase
        executor."""
        base = os.path.join(tmp, "ckpt")
        shutil.rmtree(base, ignore_errors=True)
        full_dir = os.path.join(base, "full")
        B, P = chain(E, 24), E.S.TC
        env = {"REPRO_CKPT_KEEP": "1000", "REPRO_DIST_FIXPOINT": "0"}
        plain = run(E, P, B, 4, entry="dist", env=env)
        full = run(E, P, B, 4, entry="dist",
                   env=dict(env, REPRO_CKPT_DIR=full_dir))
        tags = sorted(d for d in os.listdir(full_dir)
                      if d.startswith("ckpt_"))
        mid = tags[len(tags) // 2]
        files = read_tag(os.path.join(full_dir, mid))
        out = {"plain": plain, "full": full, "mid": mid, "files": files}
        resumes = [("ndev4", 4, "dist", {}), ("ndev2", 2, "dist", {}),
                   ("fused", 4, "local", {"REPRO_FUSED": "1"}),
                   ("two_phase", 4, "local", {})]
        for name, ndev, entry, extra_env in resumes:
            d = os.path.join(base, name)
            shutil.copytree(full_dir, d)
            for t in tags:
                if t > mid:
                    shutil.rmtree(os.path.join(d, t))
            renv = dict(env, REPRO_CKPT_DIR=d, **extra_env)
            if entry == "local":
                reset(E, **renv)
                kb = E.kb(P, B)
                out[name] = result(E, kb, E.materialize(kb, mode="tg"))
            else:
                out[name] = run(E, P, B, ndev, entry="dist", env=renv)
        return out

    def oracle_tc(E, ndev):
        import numpy as np
        rng = np.random.default_rng(7)
        edges = np.unique(rng.integers(0, 40, (100, 2)).astype(np.int32),
                          axis=0)
        reset(E)
        rows, count, triggers, rounds = E.tc(edges, ndev)
        return {"edges": edges.tolist(), "rows": rows.tolist(),
                "count": count, "triggers": triggers, "rounds": rounds,
                "dist_pulls": E.ops.HOST_SYNC_STATS.dist_pulls}

    def scenario(E, name, tmp):
        kind, _, arg = name.partition("-")
        if kind == "chain":                  # chain-<ndev>-<on|off>
            ndev, fix = arg.split("-")
            env = {"REPRO_DIST_FIXPOINT": "1" if fix == "on" else "0"}
            entry = {"1": "backend", "2": "env", "4": "dist",
                     "8": "dist"}[ndev]
            return [run(E, E.S.TC, chain(E, 48), int(ndev), entry=entry,
                        env=env)]
        if kind == "noopt":
            return [run(E, E.S.TC, chain(E, 48), 2, mode="tg_noopt")]
        if kind == "random":                 # random-<on|off>, ndev 4
            env = {"REPRO_DIST_FIXPOINT": "1" if arg == "on" else "0"}
            return [run(E, E.S.TC, E.S.tc_random_facts(200, 600), 4,
                        env=env)]
        if kind == "lubm":                   # lubm-<on|off>, ndev 2
            env = {"REPRO_DIST_FIXPOINT": "1" if arg == "on" else "0"}
            return [run(E, E.S.LUBM_L, E.S.lubm_facts(n_univ=2, scale=2), 2,
                        entry="dist", env=env)]
        if kind == "overflow":
            cfg = E.DistConfig(shard_cap=16, delta_cap=16, bucket_cap=8)
            return [run(E, E.S.TC, E.S.tc_random_facts(60, 150), 4,
                        entry="dist", env={"REPRO_FAULT_SPEC": "storm"},
                        cfg=cfg)]
        if kind == "spill":
            env = {"REPRO_FAULT_SPEC": "storm", "REPRO_MAX_RETRIES": "0"}
            out = [run(E, E.S.TC, chain(E, 48), 4, entry="dist", env=env)]
            try:
                run(E, E.S.TC, chain(E, 48), 4, entry="dist", env=env,
                    spill=False)
                out.append("no error")
            except E.CapacityError as e:
                out.append(str(e))
            return out
        if kind == "fallback":
            B = [E.parse_atom("p(a, b)"), E.parse_atom("p(b, c)")]
            prog = E.parse_program(EXIST)
            return [run(E, prog, B, 2, max_rounds=5),
                    run(E, prog, B, 2, env={"REPRO_FUSED": "1"},
                        max_rounds=5),
                    run(E, prog, B, 2, entry="dist", max_rounds=5)]
        if kind == "seminaive":
            return [run(E, E.S.TC, chain(E, 8), 2, mode="seminaive")]
        if kind == "delta":
            out = []
            reset(E, REPRO_DIST="1")
            E.set_ndev(2)
            kb = E.kb(E.S.TC, chain(E, 16))
            out.append(result(E, kb, E.materialize(kb)))
            calls = [dict(insertions=[E.parse_atom("e(v16, v90)"),
                                      E.parse_atom("e(v90, v91)")]),
                     dict(deletions=[E.parse_atom("e(v5, v6)")])]
            for kw in calls:
                E.ops.HOST_SYNC_STATS.reset()
                E.ops.SORT_STATS.reset()
                out.append(result(E, kb, kb.materialize_delta(**kw)))
            return out
        if kind == "ckpt":
            return [checkpoints(E, tmp)]
        if kind == "tc":
            return [oracle_tc(E, 4)]
        raise KeyError(name)
''')

NAMES = ("chain-1-on", "chain-1-off", "chain-2-on", "chain-2-off",
         "chain-4-on", "chain-4-off", "chain-8-on",
         "noopt", "random-on", "random-off", "lubm-on", "lubm-off",
         "overflow", "spill", "fallback", "seminaive", "delta", "ckpt", "tc")

REFERENCE_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import functools, pickle, types
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
    from repro.core.terms import Null, parse_atom, parse_program
    from repro.data import kb_sources as S
    from repro.engine import distributed as D
    from repro.engine import faultinject, ops, plan
    from repro.engine.materialize import EngineKB, materialize
    from repro.launch import mesh as M

    make_mesh = M.make_data_mesh

    def set_ndev(n):
        M.make_data_mesh = lambda ndev=None: make_mesh(
            n if ndev is None else ndev)

    E = types.SimpleNamespace(
        Null=Null, parse_atom=parse_atom, parse_program=parse_program, S=S,
        ops=ops, plan=plan, faultinject=faultinject, materialize=materialize,
        kb=EngineKB, clear_programs=plan._COMPILE_CACHE.clear,
        set_ndev=set_ndev, DistConfig=D.DistConfig,
        CapacityError=plan.CapacityError,
        dist=lambda kb, n, **kw: D.materialize_distributed(
            kb, mesh=make_mesh(n), **kw),
        tc=lambda edges, n: D.run_distributed_tc(edges, make_mesh(n)))
    src, names, tmp = pickle.loads(bytes.fromhex(sys.argv[2]))
    ns = {}
    exec(src, ns)
    out = {name: ns["scenario"](E, name, tmp) for name in names}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reference_dist")
    path = tmp / "dist.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["PYTHONPATH"] = SRC
    # XLA's persistent cache: every case starts from no built programs, so
    # the cases compile many of the same programs again
    env.update(JAX_COMPILATION_CACHE_DIR=str(tmp / "jax_cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
               TF_CPP_MIN_LOG_LEVEL="3")
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path),
                    pickle.dumps((SCENARIOS, NAMES, str(tmp))).hex()],
                   check=True, env=env, timeout=900)
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Runs each scenario on the port once (its own flags, an empty memo)
    and hands the same result to every test of the module that asks."""
    tmp = tmp_path_factory.mktemp("port_dist")
    ns = {}
    exec(SCENARIOS, ns)
    ndev = [1]
    env = types.SimpleNamespace(
        Null=TT.Null, parse_atom=TT.parse_atom,
        parse_program=TT.parse_program, S=TS, ops=ops, plan=plan,
        faultinject=faultinject, materialize=materialize,
        kb=lambda prog, facts: EngineKB(prog, facts, device="cpu"),
        clear_programs=plan.clear_programs,
        set_ndev=lambda n: ndev.__setitem__(0, n),
        DistConfig=D.DistConfig, CapacityError=plan.CapacityError,
        dist=lambda kb, n, **kw: D.materialize_distributed(kb, ndev=n, **kw),
        tc=lambda edges, n: D.run_distributed_tc(edges, ndev=n,
                                                 device="cpu"))
    done = {}

    def run(name):
        if name in done:
            return done[name]
        with pytest.MonkeyPatch.context() as mp:
            for var in ns["FLAGS"] + ("REPRO_MAX_RESIDENT_MB",):
                mp.delenv(var, raising=False)
            mp.setattr(faultinject, "_CACHE", {})
            mp.setattr(plan, "_CAP_MEMO", {})
            mp.setattr(D, "default_ndev", lambda device: ndev[0])
            try:
                done[name] = ns["scenario"](env, name, str(tmp))
            finally:
                for var in ns["FLAGS"]:
                    os.environ.pop(var, None)
        return done[name]
    return run


def _diff(got, want):
    if isinstance(got, dict) and isinstance(want, dict):
        return {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if k != "facts" and got.get(k) != want.get(k)}
    return (got, want)


def _closure(edges):
    """The transitive closure of ``edges`` (pairs), by a frontier loop."""
    adj = defaultdict(set)
    for a, b in edges:
        adj[a].add(b)
    closure = {tuple(e) for e in edges}
    frontier = set(closure)
    while frontier:
        new = {(x, z) for x, y in frontier for z in adj[y]} - closure
        closure |= new
        frontier = new
    return closure


def _tc_holds(facts):
    """``T`` is the transitive closure of ``e`` in a run's decoded facts."""
    rel = defaultdict(set)
    for pred, args in facts:
        rel[pred].add(args)
    return rel["T"] == _closure(rel["e"])


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_reference(reference, port, name):
    """Facts, rounds, triggers, derived, ``extra``, SORT_STATS,
    count_pulls and every fused / sharded host-sync counter, run for run
    (checkpoint files array for array)."""
    want = reference[name]
    got = port(name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (name, i, _diff(g, w))


def test_bench_dist_counts_at_smoke_size(port):
    """Every entry, ndev and fixpoint setting gives the transitive closure
    and the same rounds, triggers and derived (``REPRO_DIST_FIXPOINT`` and
    the shard count move the pulls, never the result); without the
    fixpoint every round is one pull, plus one per retry."""
    runs = {n: port(n)[0] for n in NAMES if n.startswith("chain-")}
    assert len({frozenset(r["facts"]) for r in runs.values()}) == 1
    assert _tc_holds(runs["chain-1-on"]["facts"])
    assert len({(r["rounds"], r["triggers"], r["derived"])
                for r in runs.values()}) == 1
    for name, r in runs.items():
        assert r["extra"] == {"dist": True, "ndev": int(name.split("-")[1])}
        if name.endswith("-on"):
            assert r["dist_fixpoint_iters"] > 0, name
        else:
            assert r["dist_fixpoint_pulls"] == 0, name
            assert r["dist_pulls"] == r["rounds"] + r["dist_retries"], name


def test_fixpoint_cuts_host_pulls(port):
    on, off = port("random-on")[0], port("random-off")[0]
    assert on["facts"] == off["facts"] and _tc_holds(on["facts"])
    assert on["dist_fixpoint_iters"] > 0 and off["dist_fixpoint_iters"] == 0
    assert on["dist_pulls"] < off["dist_pulls"]


def test_spill_and_fallbacks(port):
    spilled, raised = port("spill")
    assert "spilled" in spilled["extra"]
    assert "exhausted its retry budget" in raised
    two, fus, direct = port("fallback")
    assert "dist" not in two["extra"] and "dist" not in fus["extra"]
    assert "rounds" not in direct and two["facts"] == fus["facts"]
    (semi,) = port("seminaive")
    assert "dist" not in semi["extra"] and semi["dist_pulls"] == 0
    mat, ins, dele = port("delta")
    assert mat["extra"] == {"dist": True, "ndev": 2}
    for st in (ins, dele):
        assert "dist" not in st["extra"] and st["dist_pulls"] == 0


def test_elastic_restore(port):
    (ck,) = port("ckpt")
    full = ck["full"]
    assert full["facts"] == ck["plain"]["facts"]
    meta, files = ck["files"]
    assert meta["executor"] == "dist" and meta["ndev"] == 4
    assert sorted(files) == [f"shard_{i}.npz" for i in range(4)]
    assert all(k.startswith("base__") for k in files["shard_0.npz"]
               if k not in files["shard_1.npz"])
    for name in ("ndev4", "ndev2", "fused", "two_phase"):
        r = ck[name]
        assert r["facts"] == full["facts"], name
        assert (r["rounds"], r["triggers"], r["derived"]) == \
            (full["rounds"], full["triggers"], full["derived"]), name
        assert r["extra"]["resumed_from"] == ("dist", 4), name
    assert ck["ndev2"]["extra"]["ndev"] == 2
    assert ck["fused"]["extra"].get("fused") is True


def test_run_distributed_tc_against_a_closure_oracle(port):
    (out,) = port("tc")
    closure = _closure(out["edges"])
    assert {tuple(r) for r in out["rows"]} == closure
    assert out["count"] == len(closure)
    assert out["triggers"] > 0 and out["rounds"] > 1


# ---------------------------------------------------------------------------
# the exchange pieces against the reference, in-process
# ---------------------------------------------------------------------------
def _rows(rng, n, ar, dtype):
    info = np.iinfo(dtype)
    rows = rng.integers(info.min, info.max, (n, ar), dtype=np.int64)
    rows[: n // 4] = rng.integers(-50, 50, (n // 4, ar))
    rows[n // 4: n // 3] = info.max                 # PAD rows
    rows[-3:] = np.array([-1, 0, info.max])[:, None]
    return rows.astype(dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ar", [1, 2, 3])
def test_tuple_hash_is_bit_exact(dtype, ar):
    rows = _rows(np.random.default_rng(ar), 4096, ar, dtype)
    want = RD.np_tuple_hash(rows)
    assert np.array_equal(D.np_tuple_hash(rows), want)
    got = D._tuple_hash(torch.from_numpy(rows)).numpy()
    assert got.dtype == np.int64 and np.array_equal(got, want.astype(np.int64))
    for cols in ([0], list(range(ar))[::-1]):
        got = D._cols_hash(torch.from_numpy(rows), cols).numpy()
        ref = RD._cols_hash(jnp.asarray(rows.astype(np.int32)), cols)
        if dtype == np.int32:
            assert np.array_equal(got, np.asarray(ref).astype(np.int64))
    if dtype == np.int32:
        ref = np.asarray(RD._tuple_hash(jnp.asarray(rows)))
        assert np.array_equal(D._tuple_hash(torch.from_numpy(rows)).numpy(),
                              ref.astype(np.int64))


@pytest.mark.parametrize("sort_cols", [None, (0, 1), (1, 0)])
@pytest.mark.parametrize("bucket_cap", [4, 16, 64])
def test_route_to_buckets_matches_reference(sort_cols, bucket_cap):
    rng = np.random.default_rng(bucket_cap)
    rows = rng.integers(0, 12, (128, 2)).astype(np.int32)
    rows[rng.random(128) < 0.2] = np.iinfo(np.int32).max
    target = rng.integers(0, 4, 128).astype(np.int32)
    want_b, want_o = RD._route_to_buckets(jnp.asarray(rows),
                                          jnp.asarray(target), 4,
                                          bucket_cap, sort_cols=sort_cols)
    got_b, got_o = D._route_to_buckets(torch.from_numpy(rows),
                                       torch.from_numpy(target).long(), 4,
                                       bucket_cap, sort_cols=sort_cols)
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_o) == int(want_o)
    assert (int(got_o) > 0) == (bucket_cap < 64)


def _sorted_runs(rng, ndev, cap, ar, perm, dtype):
    pad = np.iinfo(dtype).max
    blk = np.full((ndev, cap, ar), pad, dtype)
    for i in range(ndev):
        n = int(rng.integers(0, cap + 1))
        rows = rng.integers(0, 6, (n, ar)).astype(dtype)
        keys = [rows[:, c] for c in reversed(perm)]
        blk[i, :n] = rows[np.lexsort(keys)] if n else rows
    return blk.reshape(ndev * cap, ar)


@pytest.mark.parametrize("ndev", [2, 3, 4, 5])
@pytest.mark.parametrize("ar,perm", [(1, (0,)), (2, (0, 1)), (2, (1, 0)),
                                     (3, (2, 0, 1))])
def test_merge_runs_matches_reference(ndev, ar, perm, monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    blk = _sorted_runs(np.random.default_rng(ndev * 10 + ar), ndev, 16, ar,
                       perm, np.int32)
    want = np.asarray(RD._merge_runs(jnp.asarray(blk), ndev, perm))
    got = D._merge_runs(torch.from_numpy(blk), ndev, perm).numpy()
    assert np.array_equal(got, want)


def test_lockstep_checks_sites_and_sums():
    def body(d, site):
        got = yield D._psum("a", torch.tensor(d + 1))
        recv = yield D._Collective(
            "all_to_all", site,
            torch.full((3, 2, 1), d, dtype=torch.int32))
        return int(got), recv[:, 0, 0].tolist()

    assert D._lockstep([body(d, "x") for d in range(3)]) == \
        [(6, [0, 1, 2])] * 3
    with pytest.raises(RuntimeError, match="reached"):
        D._lockstep([body(d, "x" if d else "y") for d in range(3)])


def test_default_ndev_follows_the_device():
    # one shard on either device until shards are placed on several cards
    assert D.default_ndev(torch.device("cpu")) == 1
    assert D.default_ndev(torch.device("cuda")) == 1


def test_caps_bucket_guess_matches_reference(monkeypatch):
    from repro.engine import plan as rplan
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    out = []
    for mod in (rplan, plan):
        monkeypatch.setattr(mod, "_CAP_MEMO", {})
        caps = mod._Caps(("fp",), {"T": (None, 700), "e": (None, 3)},
                         ndev=4)
        caps.bucket_cap(("absorb", "T"))
        caps.double(("bucket", ("absorb", "T")))
        caps.memoize()
        again = mod._Caps(("fp",), {"T": (None, 1)}, ndev=4)
        out.append((caps.state(), again.bucket_cap(("absorb", "T")),
                    again.bucket_cap("x"), caps.planned_rows()))
    assert out[0] == out[1]


def test_lower_distributed_tc_is_not_ported():
    """``lower_distributed_tc`` counts one sharded TC round for ``ndev``
    lockstep shards (``tests/test_torch_analysis.py`` holds it against the
    reference's): 3 bucket exchanges, each one shard's (ndev, bucket, 2)
    int32 buckets, and 3 psums; the work grows with the shards."""
    cfg = D.DistConfig(shard_cap=1 << 8, delta_cap=1 << 6, bucket_cap=1 << 4)
    got = {n: D.lower_distributed_tc(n, cfg, device="cpu") for n in (1, 2)}
    for n, rec in got.items():
        assert rec["coll"]["all-to-all"] == 3 * n * (1 << 4) * 2 * 4
        assert rec["coll_count"] == 6
    assert got[2]["bytes"] > got[1]["bytes"] > 0


def test_checkpoint_loader_reads_shard_lists(tmp_path):
    """A four-shard dist checkpoint restores as global relations on a
    single-shard KB (the loader concatenates and re-sorts the shards)."""
    kb = EngineKB(TS.TC, TS.tc_chain_facts(8), device="cpu")
    rows = kb.rels["e"].np_rows()
    h = D.np_tuple_hash(rows) % 4
    shards = [{"store__e": rows[h == s], "base__e": rows} if s == 0
              else {"store__e": rows[h == s]} for s in range(4)]
    mgr = recovery.RecoveryManager(str(tmp_path))
    ck = recovery.EngineCheckpointer(kb, "tg", "dist")
    meta = {"fingerprint": ck.fingerprint, "executor": "dist", "mode": "tg",
            "rounds": 1, "triggers": 0, "derived": 0, "ndev": 4,
            "done": False}
    mgr.save(1, meta, shards, {"dict.pkl": pickle.dumps(
        kb.dict.state_dict())})
    os.environ["REPRO_CKPT_DIR"] = str(tmp_path)
    try:
        kb2 = EngineKB(TS.TC, TS.tc_chain_facts(8), device="cpu")
        st = types.SimpleNamespace(rounds=0, triggers=0, derived=0, extra={})
        recovery.EngineCheckpointer(kb2, "tg", "dist").maybe_resume(st)
    finally:
        del os.environ["REPRO_CKPT_DIR"]
    assert np.array_equal(kb2.rels["e"].np_rows(), rows)
    assert st.extra["resumed_from"] == ("dist", 4)
