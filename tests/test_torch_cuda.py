"""The port on the card: each CUDA kernel against its plain version, the
slice on ``cuda`` against the same run on the CPU (``tg_linear`` too), the
fused executor's captured rounds and device loop against their eager
runs, and the LM layers (MoE and MLA included) against the CPU.  These
tests need a CUDA card and skip without one; on the machine with the card
run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.terms import Atom, parse_program
from repro_torch.core.tg_linear import min_linear, tglinear
from repro_torch.data.kb_sources import LUBM_L, LUBM_LI, TC, lubm_facts
from repro_torch.engine import faultinject, fused, ops, plan, recovery
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.engine.relation import host_order
from repro_torch.kernels import bitonic_sort as BS
from repro_torch.kernels import build
from repro_torch.kernels import ops as KO
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda
DTYPES = [torch.int16, torch.int32, torch.int64]
# inputs of the sort kernels' sweeps: "a_above" / "b_above" put the first /
# second half of every block wholly above the other
CASES = ["random", "equal", "pad", "max", "a_above", "b_above"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n", [1, 100, 1 << 12, 1 << 16])
def test_kernels_match_plain_versions(card, n, dt):
    g = torch.Generator().manual_seed(n)
    hi = min(1 << 20, torch.iinfo(dt).max)
    keys = torch.randint(0, hi, (n,), generator=g).to(dt).to(card)
    pos = torch.arange(n, dtype=torch.int32, device=card)
    ks, vs = KO.sort_with_payload(keys, pos, tile=256)
    wk, wv = ref.sort_with_payload_ref(keys, pos)
    assert torch.equal(ks, wk) and torch.equal(vs, wv)
    rows = torch.randint(0, 4, (n, 2), generator=g).to(dt).to(card)
    rows = ops.lexsort_core(rows)
    assert torch.equal(KO.unique_mask(rows), ref.unique_mask_ref(rows))
    hay = torch.sort(keys[: max(1, n // 2)]).values
    assert torch.equal(KO.probe_sorted(keys, hay),
                       ref.probe_sorted_ref(keys, hay))
    if n >= 1 << 12:
        m = 1 << 13 if n > 1 << 12 else n
        hk, hv = ref.sort_tiles_ref(keys[:m], pos[:m], m // 2)
        mk, mv = BS.bitonic_merge_pairs(hk, hv, m)
        wk, wv = ref.merge_pairs_ref(hk, hv, m)
        assert torch.equal(mk, wk) and torch.equal(mv, wv)


def test_slice_on_the_card_matches_the_cpu(card):
    facts = lubm_facts(n_univ=4)
    results = []
    for device in (card, "cpu"):
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        KO.reset_launch_counts()
        kb = EngineKB(LUBM_L, facts, device=device)
        st = materialize(kb, mode="tg")
        rows = {p: r.np_rows() for p, r in kb.rels.items()}
        results.append(({p: v[host_order(v)] for p, v in rows.items()},
                        (st.rounds, st.triggers, st.derived,
                         dict(vars(ops.SORT_STATS)),
                         ops.HOST_SYNC_STATS.count_pulls),
                        KO.launch_counts()))
    (rg, sg, lg), (rc, sc, lc) = results
    assert sg == sc
    assert rg.keys() == rc.keys()
    assert all(np.array_equal(rg[p], rc[p]) for p in rg)
    assert all(v > 0 for v in lg.values()), lg
    assert set(lc.values()) == {0}


def case_inputs(n, width, dt, case, seed):
    """(keys, payload) on the card for one of CASES, made with numpy."""
    rng = np.random.default_rng(seed)
    pad = torch.iinfo(dt).max
    pos = rng.permutation(n).astype(np.int32)
    if case == "random":
        keys = rng.integers(0, 1 << 12, n)
    elif case == "equal":             # ties across the halves, equal pairs
        keys = np.full(n, 7)
        pos %= 5
    elif case == "pad":
        keys = np.full(n, pad)
    elif case == "max":               # the dtype's max beside real keys
        keys = np.where(rng.random(n) < 0.25, pad, rng.integers(0, 64, n))
    else:
        upper = np.arange(n) % width >= width // 2
        keys = rng.integers(0, 1000, n) + 1000 * (
            ~upper if case == "a_above" else upper)
    return (torch.from_numpy(keys).to(dt).cuda(),
            torch.from_numpy(pos).cuda())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_tile_sort_every_tile(card, dt, case):
    """Every tile, at a length of many CTAs and at three tiles (one CTA
    with a short span for tiles below a thread's items)."""
    smem_block = build.library().rt_smem_block()
    tile = 1
    while tile <= smem_block:
        for n in (4 * smem_block, 3 * tile):
            keys, pos = case_inputs(n, tile, dt, case, tile + n)
            ks, vs = BS.bitonic_sort_tiles(keys, pos, tile)
            wk, wv = ref.sort_tiles_ref(keys, pos, tile)
            assert torch.equal(ks, wk) and torch.equal(vs, wv), (tile, n)
        tile *= 2


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_merge_every_width_class(card, dt, case):
    """Widths below, at and above the merge kernel's span, including the
    widths 2 and 4 whose blocks a thread's items cross, and lengths that
    leave the last span short."""
    span = BS.merge_span()
    for width in (2, 4, 8, span, 2 * span, 1 << 16):
        for n in sorted({max(1 << 17, 2 * width), 3 * width}):
            keys, pos = ref.sort_tiles_ref(
                *case_inputs(n, width, dt, case, width + n), width // 2)
            mk, mv = BS.bitonic_merge_pairs(keys, pos, width)
            wk, wv = ref.merge_pairs_ref(keys, pos, width)
            assert torch.equal(mk, wk) and torch.equal(mv, wv), (width, n)


def probe_inputs(kind, nq, nh, dt, seed):
    """(queries, sorted haystack) on the card, made with numpy: "distinct"
    keys (every 7th query PAD), "runs" of one key (the longest over the
    middle of the haystack), a "pad_tail" of a third of the haystack,
    "all_pad", or every query "below" the first key / "above" the last."""
    rng = np.random.default_rng(seed)
    pad = torch.iinfo(dt).max
    hi = min(4 * nh, pad - 64)  # room for "below" to shift it up
    if kind == "all_pad":
        hay = np.full(nh, pad)
    elif kind == "runs":
        hay = np.sort(rng.integers(0, 8, nh))
        hay[nh // 2 - nh // 8: nh // 2 + nh // 8 + 1] = 9
        hay = np.sort(hay)
    elif kind == "distinct" and nh <= hi:
        hay = np.sort(rng.choice(hi, nh, replace=False))
    else:
        hay = np.sort(rng.integers(0, hi, nh))
        if kind == "pad_tail":
            hay[nh - nh // 3:] = pad
    if kind == "below":
        hay = hay + 64
        q = np.minimum(rng.integers(-64, 64, nq), hay[0] - 1)
    elif kind == "above":
        q = np.minimum(int(hay[-1]) + 1 + rng.integers(0, 64, nq), pad)
    elif kind == "runs":
        q = rng.integers(-1, 12, nq)
    else:
        q = rng.integers(0, hi, nq)
        q[::7] = pad
    return (torch.from_numpy(q).to(dt).cuda(),
            torch.from_numpy(hay).to(dt).cuda())


PROBE_KINDS = ["distinct", "runs", "pad_tail", "all_pad", "below", "above"]


def probe_edge_sizes(dt):
    """Haystack lengths around the kernel's table: 2^L - 1, 2^L and
    2^L + 1 keys for L = 8, 10, 12; one key; and, since the table holds
    heads of 128-byte lines (u keys each), 2^L - 1, 2^L and 2^L + 1 heads
    for L = 8 (narrow grid) and 12 (wide), each a key short, exact and a
    key over."""
    u = 128 // torch.tensor([], dtype=dt).element_size()
    sizes = [(1 << lv) + d for lv in (8, 10, 12) for d in (-1, 0, 1)]
    sizes += [((1 << lv) + d) * u + e for lv in (8, 12)
              for d in (-1, 0, 1) for e in (-1, 0, 1)]
    return [1] + sizes


@pytest.mark.parametrize("kind", PROBE_KINDS)
@pytest.mark.parametrize("dt", DTYPES)
def test_probe_table_edges(card, dt, kind):
    """Every ``probe_edge_sizes`` length, with few queries (the narrow
    grid) and with 2^19 (the wide grid)."""
    for nq in (1 << 12, 1 << 19):
        for nh in probe_edge_sizes(dt):
            q, hay = probe_inputs(kind, nq, nh, dt, nh)
            assert torch.equal(KO.probe_sorted(q, hay),
                               ref.probe_sorted_ref(q, hay)), (nq, nh)
    for nh in (9 << 12, (81 << 12) + 5, (729 << 12) - 1):
        q, hay = probe_inputs(kind, 1 << 14, nh, dt, nh)
        assert torch.equal(KO.probe_sorted(q, hay),
                           ref.probe_sorted_ref(q, hay)), nh


@pytest.mark.parametrize("dt", DTYPES)
def test_probe_haystack_view_inside_a_line(card, dt):
    """The kernel reads 128-byte lines of memory: a haystack that starts
    or ends inside one (a view at an offset) reads only its own keys."""
    q, hay = probe_inputs("distinct", 1 << 14, 5000, dt, 5)
    for off in (1, 3, 7, 9):
        for view in (hay[off:], hay[:-off], hay[off:off + 40]):
            assert torch.equal(KO.probe_sorted(q, view),
                               ref.probe_sorted_ref(q, view)), off


@pytest.mark.parametrize("dt", [torch.int32, torch.int64])
def test_probe_past_l2(card, dt):
    """A haystack of 2^24 keys (64 MB at int32, 128 MB at int64) does not
    fit the 50 MB L2."""
    for kind in ("distinct", "pad_tail"):
        q, hay = probe_inputs(kind, 1 << 20, 1 << 24, dt, 24)
        assert torch.equal(KO.probe_sorted(q, hay),
                           ref.probe_sorted_ref(q, hay)), kind


def _counted_rows(kb, st):
    rows = {p: r.np_rows() for p, r in kb.rels.items()}
    return ({p: v[host_order(v)] for p, v in rows.items()},
            (st.rounds, st.triggers, st.derived, st.mode, dict(st.extra),
             dict(vars(ops.SORT_STATS)), ops.HOST_SYNC_STATS.count_pulls))


def test_delta_on_the_card_matches_the_cpu(card):
    """Delete base facts of every predicate (the arity-1 ones reach the
    probe through ``merge_diff``), reinsert them, then a mixed call: the
    card's rows and counters equal the CPU's after every call, and every
    kernel launches on the card."""
    facts = lubm_facts(n_univ=4)
    rng = np.random.default_rng(0)
    by_pred = {}
    for f in facts:
        by_pred.setdefault(f.pred, []).append(f)
    dels = [fs[i] for _, fs in sorted(by_pred.items())
            for i in rng.choice(len(fs), min(len(fs), 8), replace=False)]
    calls = [([], dels), (dels, []), (dels[:10], dels[10:30])]
    results = []
    for device in (card, "cpu"):
        kb = EngineKB(LUBM_L, facts, device=device)
        materialize(kb, mode="tg")
        KO.reset_launch_counts()
        steps = []
        for ins, gone in calls:
            ops.SORT_STATS.reset()
            ops.HOST_SYNC_STATS.reset()
            st = kb.materialize_delta(insertions=ins, deletions=gone)
            steps.append(_counted_rows(kb, st))
        results.append((steps, KO.launch_counts()))
    (steps_g, lg), (steps_c, lc) = results
    for (rg, sg), (rc, sc) in zip(steps_g, steps_c):
        assert sg == sc
        assert rg.keys() == rc.keys()
        assert all(np.array_equal(rg[p], rc[p]) for p in rg)
    assert all(v > 0 for v in lg.values()), lg
    assert set(lc.values()) == {0}


def test_checkpoint_resume_on_the_card_matches_the_cpu(card, tmp_path,
                                                       monkeypatch):
    """A checkpointed run on the card writes the CPU run's files; rewound
    to round 2, it resumes on the card to the CPU run's rows and
    counters."""
    monkeypatch.delenv("REPRO_FAULT_SPEC", raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setenv("REPRO_CKPT_KEEP", "100")
    facts = lubm_facts(n_univ=4)
    out = []
    for i, device in enumerate((card, "cpu")):
        d = tmp_path / f"run{i}"
        monkeypatch.setenv("REPRO_CKPT_DIR", str(d))
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        kb = EngineKB(LUBM_L, facts, device=device)
        full = _counted_rows(kb, materialize(kb, mode="tg"))
        mgr = recovery.RecoveryManager(str(d), keep=100)
        shards = [mgr._load_one(t, None)[1] for t in mgr.tags()]
        for t in mgr.tags()[2:]:
            mgr.drop(t)
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        kb = EngineKB(LUBM_L, facts, device=device)
        st = materialize(kb, mode="tg")
        assert st.extra["resumed_rounds"] == 2
        assert kb.rels["subOrg"].data.device.type == torch.device(
            device).type
        out.append((full, _counted_rows(kb, st), shards))
    (full_g, res_g, sh_g), (full_c, res_c, sh_c) = out
    for (rg, sg), (rc, sc) in ((full_g, full_c), (res_g, res_c)):
        assert sg == sc
        assert all(np.array_equal(rg[p], rc[p]) for p in rc)
    assert len(sh_g) == len(sh_c)
    for a, b in zip(sh_g, sh_c):
        assert a[0].keys() == b[0].keys()
        assert all(np.array_equal(a[0][k], b[0][k]) for k in a[0])


# ---------------------------------------------------------------------------
# the fused executor on the card: captured rounds, the device loop
# ---------------------------------------------------------------------------
DEEP_TC = "e(X, Y) -> T(Y, X)\nT(Y, X) & e(Y, Z) -> T(Z, X)"


def _deep_facts(n_chain=192, n_extra=16, seed=0):
    """``benchmarks/bench_fused.py``'s deep chain (``tc_facts(192, 16)``)."""
    rng = np.random.default_rng(seed)
    edges = [(i, i + 1) for i in range(n_chain)]
    edges += [tuple(e) for e in rng.integers(0, n_chain, (n_extra, 2))]
    return [Atom("e", (f"v{a}", f"v{b}")) for a, b in edges]


WORKLOADS = {"lubm": lambda: (LUBM_L, lubm_facts(n_univ=4)),
             "deep": lambda: (parse_program(DEEP_TC), _deep_facts())}


@pytest.fixture
def fused_card(card, monkeypatch):
    """``REPRO_FUSED=1``, no checkpoints or faults, an empty capacity memo
    and program cache."""
    monkeypatch.setenv("REPRO_FUSED", "1")
    for var in ("REPRO_CKPT_DIR", "REPRO_FAULT_SPEC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    fused.clear_programs()
    yield card
    fused.clear_programs()


def _fused_run(prog, facts, device):
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    KO.reset_launch_counts()
    kb = EngineKB(prog, facts, device=device)
    st = materialize(kb, mode="tg")
    h = ops.HOST_SYNC_STATS
    rows, counted = _counted_rows(kb, st)
    return rows, counted + (h.fused_pulls, h.fused_retries), \
        KO.launch_counts()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fused_on_the_card_matches_the_cpu(fused_card, name, monkeypatch):
    """Cold, then warm on a fresh KB: the card's rows and counters
    (MatStats with ``extra``, SORT_STATS, count_pulls, fused_pulls,
    fused_retries) equal the CPU's from the same capacity memo; the warm
    run retries nothing."""
    prog, facts = WORKLOADS[name]()
    out = {}
    for device in (fused_card, "cpu"):
        monkeypatch.setattr(plan, "_CAP_MEMO", {})
        out[str(device)] = [_fused_run(prog, facts, device)
                            for _ in range(2)]
    for (rg, cg, lg), (rc, cc, lc) in zip(out["cuda"], out["cpu"]):
        assert cg == cc
        assert cg[4] == {"fused": True}
        assert all(np.array_equal(rg[p], rc[p]) for p in rc)
        assert set(lc.values()) == {0}
    assert out["cuda"][1][1][-1] == 0
    if name == "lubm":
        assert all(v > 0 for v in out["cuda"][0][2].values())


def _captured_rounds():
    return [p for p in plan._COMPILE_CACHE.values()
            if isinstance(p.run, fused._Replay) and p.run.graph is not None]


def test_captured_round_equals_its_eager_run(fused_card):
    """Every captured round program of LUBM-L, replayed on its last inputs,
    gives what its function gives run eagerly on them, and its recorded
    launches are the eager run's."""
    prog, facts = WORKLOADS["lubm"]()
    _fused_run(prog, facts, fused_card)
    rounds = _captured_rounds()
    assert rounds
    for p in rounds:
        KO.reset_launch_counts()
        want = [t.clone() for t in p.run.fn(*p.run.static)]
        eager = KO.launch_counts()
        KO.reset_launch_counts()
        got = p.run(*p.run.static)
        assert KO.launch_counts() == eager == {
            k: p.run.launches.get(k, 0) for k in eager}
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_device_loop_equals_host_loop_phase_by_phase(fused_card,
                                                     monkeypatch):
    """On the deep chain, every device-loop phase ends in the state the
    host loop (the loop's plain version) reaches from the same inputs on
    the card, and launches per iteration what the host loop launches."""
    phases = []
    call = fused._DeviceLoop.__call__

    def checked(self, consts, state, enter=True):
        consts = [c.clone() for c in consts]
        state = [s.clone() for s in state]
        KO.reset_launch_counts()
        want = fused._HostLoop(self.step, self.cond)(consts, state)
        host = KO.launch_counts()
        got = [t.clone() for t in call(self, consts, state, enter)]
        torch.cuda.synchronize()
        n = (len(got) - 1) // 2       # tails, deltas, then scal
        iters = int(got[-1][2 * n + 3].item())
        phases.append((want, got, host, iters, self))
        return got

    monkeypatch.setattr(fused._DeviceLoop, "__call__", checked)
    prog, facts = WORKLOADS["deep"]()
    _fused_run(prog, facts, fused_card)
    assert len(phases) > 1
    for want, got, host, iters, loop in phases:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert iters >= 1
        assert host == {k: loop.launches.get(k, 0) * iters for k in host}


def test_replayed_round_makes_no_host_sync(fused_card):
    """Under ``torch.cuda.set_sync_debug_mode("error")``: a captured round
    replayed, a device-loop launch, and a round's function run eagerly."""
    prog, facts = WORKLOADS["lubm"]()
    _fused_run(prog, facts, fused_card)
    loops = [p for p in plan._COMPILE_CACHE.values()
             if isinstance(p.run, fused._DeviceLoop)
             and p.run.loop is not None]
    p = _captured_rounds()[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p.run(*p.run.static)
        p.run.fn(*p.run.static)
        for lp in loops:
            lp.run(lp.run.consts, lp.run.state, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_failed_capture_raises(card):
    """A function that syncs the host cannot be captured: the program
    raises instead of running eagerly, and the next capture works."""
    x = torch.arange(8, device=card)
    bad = fused._Replay(lambda t: t + int(t.sum().item()))
    with pytest.raises(RuntimeError, match="capture"):
        bad(x)
    good = fused._Replay(lambda t: t * 2)
    assert torch.equal(good(x), x * 2)
    assert torch.equal(good(x + 1), (x + 1) * 2)


def test_fused_delta_hand_off_on_the_card_matches_the_cpu(fused_card,
                                                          monkeypatch):
    """Prepending an edge to a TC chain cascades past the hand-off: the
    card's delta call runs fused and equals the CPU's."""
    base = [Atom("e", (f"n{i}", f"n{i + 1}")) for i in range(16)]
    out = []
    for device in (fused_card, "cpu"):
        monkeypatch.setattr(plan, "_CAP_MEMO", {})
        kb = EngineKB(TC, base, device=device)
        materialize(kb, mode="tg")
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        st = kb.materialize_delta(insertions=[Atom("e", ("w1", "n0"))])
        out.append(_counted_rows(kb, st) + (
            ops.HOST_SYNC_STATS.fused_pulls,
            ops.HOST_SYNC_STATS.fused_retries))
    (rg, sg, pg, tg), (rc, sc, pc, tc) = out
    assert sg[4].get("fused") is True
    assert (sg, pg, tg) == (sc, pc, tc)
    assert all(np.array_equal(rg[p], rc[p]) for p in rc)


@pytest.mark.parametrize("cleaning", [True, False])
def test_tg_linear_on_the_card_matches_the_cpu(card, cleaning):
    """``materialize(mode="tg_linear")`` over the TG
    ``min_linear(tglinear(LUBM_LI))``: the card's rows and counters equal
    the CPU's; with cleaning the sort kernels and the first-of-run mask
    launch on the card."""
    eg = min_linear(tglinear(LUBM_LI))
    facts = lubm_facts(n_univ=8)
    out = []
    for device in (card, "cpu"):
        kb = EngineKB(LUBM_LI, facts, device=device)
        ops.SORT_STATS.reset()
        ops.HOST_SYNC_STATS.reset()
        KO.reset_launch_counts()
        st = materialize(kb, mode="tg_linear", tg_eg=eg, cleaning=cleaning)
        out.append(_counted_rows(kb, st) + (KO.launch_counts(),))
    (rg, sg, lg), (rc, sc, lc) = out
    assert sg == sc
    assert rg.keys() == rc.keys()
    assert all(np.array_equal(rg[p], rc[p]) for p in rg)
    assert set(lc.values()) == {0}
    if cleaning:
        assert all(lg[k] > 0 for k in ("bitonic_sort_tiles",
                                        "bitonic_merge_pairs",
                                        "unique_mask")), lg


# ---------------------------------------------------------------------------
# the sharded executor on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", DTYPES)
def test_dist_hash_on_the_card(card, dt):
    """The device tuple hash on the card equals the CPU's and its host
    mirror bit for bit, with negative ids and PAD."""
    from repro_torch.engine import distributed as D
    g = torch.Generator().manual_seed(3)
    info = torch.iinfo(dt)
    rows = torch.randint(info.min, info.max, (4096, 2), generator=g,
                         dtype=torch.int64).to(dt)
    rows[:64] = -1
    rows[64:128] = info.max
    want = D.np_tuple_hash(rows.numpy()).astype(np.int64)
    assert np.array_equal(D._tuple_hash(rows).numpy(), want)
    assert np.array_equal(D._tuple_hash(rows.to(card)).cpu().numpy(), want)


def test_dist_lockstep_exchange_on_the_card(card):
    """Four shard bodies route their rows to the tuple-hash home shard with
    the sorted exchange and merge the received runs: the card's blocks
    equal the CPU's."""
    from repro_torch.engine import distributed as D
    g = torch.Generator().manual_seed(4)
    rows = torch.randint(0, 500, (4, 256, 2), generator=g).to(torch.int32)
    rows[:, 200:] = torch.iinfo(torch.int32).max

    def body(block):
        tgt = D._shard_of(D._tuple_hash(block), 4)
        out, dropped = yield from D._exchange(block, tgt, 4, 128,
                                              ("absorb", "T"),
                                              sort_cols=(0, 1))
        return D._merge_runs(out, 4, (0, 1)), dropped

    out = {}
    for dev in (card, torch.device("cpu")):
        res = D._lockstep([body(rows[d].to(dev)) for d in range(4)])
        out[dev.type] = [(b.cpu(), int(n)) for b, n in res]
    for (bg, ng), (bc, nc) in zip(out["cuda"], out["cpu"]):
        assert ng == nc == 0 and torch.equal(bg, bc)
    got = torch.cat([b for b, _ in out["cpu"]])
    valid = got[got[:, 0] != torch.iinfo(torch.int32).max]
    assert sorted(map(tuple, valid.tolist())) == sorted(
        map(tuple, rows[rows[..., 0] != torch.iinfo(torch.int32).max]
            .tolist()))


@pytest.fixture
def dist_card(card, monkeypatch):
    for var in ("REPRO_DIST", "REPRO_DIST_FIXPOINT", "REPRO_FUSED",
                "REPRO_CKPT_DIR", "REPRO_FAULT_SPEC", "REPRO_MAX_RETRIES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(faultinject, "_CACHE", {})
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    plan.clear_programs()
    yield card
    plan.clear_programs()


@pytest.mark.parametrize("fix", ["1", "0"])
@pytest.mark.parametrize("name,ndev", [("tc", 4), ("lubm", 2)])
def test_dist_on_the_card_matches_the_cpu(dist_card, name, ndev, fix,
                                          monkeypatch):
    """Cold, then warm: the card's sharded runs give the CPU's rows and
    counters (MatStats with ``extra``, SORT_STATS, count_pulls and the
    sharded pulls, retries and fixpoint iterations) from the same memo;
    the card's rounds are captured graphs and, with the fixpoint on, its
    linear phases run in the device loop."""
    from repro_torch.engine import distributed as D
    from repro_torch.kernels import graph_loop as GL
    from repro_torch.data.kb_sources import tc_chain_facts
    monkeypatch.setenv("REPRO_DIST_FIXPOINT", fix)
    prog, facts = ((TC, tc_chain_facts(48)) if name == "tc"
                   else (LUBM_L, lubm_facts(n_univ=1)))
    out = {}
    for device in (dist_card, "cpu"):
        monkeypatch.setattr(plan, "_CAP_MEMO", {})
        fused.CAPTURES.update(dist_round=0, dist_prologue=0,
                              dist_fixpoint=0)
        GL.LAUNCHES["graph_loop"] = 0
        runs = []
        for _ in range(2):
            ops.SORT_STATS.reset()
            ops.HOST_SYNC_STATS.reset()
            kb = EngineKB(prog, facts, device=device)
            st = D.materialize_distributed(kb, ndev=ndev)
            h = ops.HOST_SYNC_STATS
            rows, counted = _counted_rows(kb, st)
            runs.append((rows, counted + (h.dist_pulls, h.dist_retries,
                                          h.dist_fixpoint_pulls,
                                          h.dist_fixpoint_iters)))
        out[str(device)] = (runs, dict(fused.CAPTURES),
                            GL.LAUNCHES["graph_loop"])
    (card_runs, caps, loops), (cpu_runs, _, _) = out["cuda"], out["cpu"]
    for (rg, cg), (rc, cc) in zip(card_runs, cpu_runs):
        assert cg == cc
        assert cg[4] == {"dist": True, "ndev": ndev}
        assert all(np.array_equal(rg[p], rc[p]) for p in rc)
    assert caps["dist_round"] > 0
    if fix == "1":
        assert caps["dist_fixpoint"] > 0 and loops > 0
    else:
        assert caps["dist_fixpoint"] == 0 and loops == 0


# ---------------------------------------------------------------------------
# the LM serving path on the card (no kernel of its own: plain torch ops,
# held against the same functions on the CPU; TF32 off)
# ---------------------------------------------------------------------------
LM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=5e-2, rtol=0)}


@pytest.fixture
def lm_card(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return card


def _smoke_cfg(dtype, **kw):
    from repro_torch.configs.base import get_smoke_config
    return get_smoke_config("stablelm_12b").with_(
        dtype=str(dtype).removeprefix("torch."), **kw)


def _same_on_card(fn, args, dtype, card, tol=None):
    """``fn`` on the CPU tensors / mappings in ``args`` and on their card
    copies: equal within ``tol`` (default: the dtype's tolerance)."""
    def to(x, dev):
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        return x.to(dev) if torch.is_tensor(x) else x
    want = fn(*args)
    got = fn(*(to(a, card) for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g.cpu().float(), w.float(),
                                   **(tol or LM_TOL[dtype]))


def _params(cfg, make):
    """``make(cfg, generator)``'s parameters, biases and scales moved away
    from their initial 0 and 1."""
    g = torch.Generator().manual_seed(0)
    p = dict(make(cfg, g))
    for k, v in p.items():
        if k.startswith("b") or "norm" in k or k == "scale":
            p[k] = (v.float() + 0.1 * torch.randn(v.shape, generator=g)).to(
                v.dtype)
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["norm_rms", "norm_layer", "rope", "swiglu",
                                "squared_relu", "gelu_bias", "flash_causal",
                                "flash_full", "attention_fwd", "decode_inside",
                                "decode_at_end", "embed_logits", "mla_fwd",
                                "mla_decode_inside", "mla_decode_at_end"])
def test_lm_layers_on_the_card_match_the_cpu(lm_card, fn, dtype):
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(1)

    def x(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dtype)

    if fn.startswith("norm"):
        cfg = _smoke_cfg(dtype, norm_type="rmsnorm" if fn == "norm_rms"
                         else "layernorm")
        p = _params(cfg, lambda c, g: L.init_norm(c, "cpu"))
        args = (p, x(3, 7, cfg.d_model, scale=2.0))
        _same_on_card(lambda p, h: L.apply_norm(p, h, cfg), args, dtype,
                      lm_card)
    elif fn == "rope":
        # angles reach 5,000 rad, whose float32 ulp is 2^-11: the card's and
        # the CPU's pow / cos may each be an ulp apart there, so float32
        # holds to two ulps of the angle times the largest |x1| + |x2|
        pos = torch.randint(0, 5000, (2, 40), generator=g)
        h = x(2, 40, 4, 160)
        tol = None
        if dtype == torch.float32:
            pair = sum(h.abs().chunk(2, dim=-1)).max().item()
            tol = dict(atol=2 * 2.0 ** -11 * pair, rtol=0)
        _same_on_card(lambda h, q: L.apply_rope(h, q, 1e4), (h, pos), dtype,
                      lm_card, tol)
    elif fn in ("swiglu", "squared_relu", "gelu_bias"):
        cfg = _smoke_cfg(dtype, mlp_type=fn.removesuffix("_bias"),
                         use_bias=fn.endswith("_bias"))
        p = _params(cfg, L.init_mlp)
        _same_on_card(lambda p, h: L.apply_mlp(p, h, cfg),
                      (p, x(2, 9, cfg.d_model)), dtype, lm_card)
    elif fn.startswith("flash"):
        q, k, v = (x(2, 37, 4, 16, scale=2.0) for _ in range(3))
        _same_on_card(lambda q, k, v: L.flash_attention(
            q, k, v, causal=fn == "flash_causal", chunk=16), (q, k, v),
            dtype, lm_card)
    elif fn == "attention_fwd":
        cfg = _smoke_cfg(dtype, use_bias=True, use_qk_norm=True)
        p = _params(cfg, L.init_attention)
        pos = torch.arange(24).expand(2, 24)
        _same_on_card(lambda p, h, pos: L.attention_fwd(
            p, h, cfg, positions=pos, return_kv=True)[0],
            (p, x(2, 24, cfg.d_model), pos), dtype, lm_card)
    elif fn.startswith("mla"):
        cfg = _smoke_cfg(dtype).with_(**{k: getattr(_moe_cfg(
            "deepseek_v3_671b", dtype), k) for k in (
                "attn_type", "q_lora_rank", "kv_lora_rank", "qk_nope_dim",
                "qk_rope_dim", "v_head_dim")})
        p = _params(cfg, L.init_mla)
        if fn == "mla_fwd":
            pos = torch.arange(24).expand(2, 24)
            _same_on_card(lambda p, h, pos: L.mla_fwd(
                p, h, cfg, positions=pos, return_kv=True)[1],
                (p, x(2, 24, cfg.d_model), pos), dtype, lm_card)
        else:
            cache = {"c_kv": x(2, 20, cfg.kv_lora_rank),
                     "k_rope": x(2, 20, cfg.qk_rope_dim)}
            pos = 12 if fn == "mla_decode_inside" else 20

            def step(p, h, cache):
                y, c = L.mla_decode_attention(p, h, {
                    k: v.clone() for k, v in cache.items()}, pos, cfg)
                return y, c["c_kv"], c["k_rope"]
            _same_on_card(step, (p, x(2, 1, cfg.d_model), cache), dtype,
                          lm_card)
    elif fn.startswith("decode"):
        cfg = _smoke_cfg(dtype, use_bias=True)
        p = _params(cfg, L.init_attention)
        cache = {"k": x(2, 20, 2, 16), "v": x(2, 20, 2, 16)}
        pos = 12 if fn == "decode_inside" else 20

        def step(p, h, cache):
            y, c = L.gqa_decode_attention(p, h, {k: v.clone() for k, v in
                                                 cache.items()}, pos, cfg)
            return y, c["k"], c["v"]
        _same_on_card(step, (p, x(2, 1, cfg.d_model), cache), dtype,
                      lm_card)
    else:
        cfg = _smoke_cfg(dtype, vocab_size=250)
        table = x(256, cfg.d_model, scale=0.5)
        tok = torch.randint(0, 250, (3, 1), generator=g)
        _same_on_card(lambda t, tab: M.logits_fn(M.embed(t, tab), tab, cfg),
                      (tok, table), dtype, lm_card)


def _moe_cfg(arch, dtype, **kw):
    from repro_torch.configs.base import get_smoke_config
    return get_smoke_config(arch).with_(
        dtype=str(dtype).removeprefix("torch."), **kw)


def _moe_params(cfg, device):
    """``init_moe``'s parameters, the router 5x its init scale so that
    routing is decisive."""
    from repro_torch.models import moe as MOE
    p = dict(MOE.init_moe(cfg, torch.Generator().manual_seed(0)))
    p["router"] = p["router"] * 5.0
    return {k: v.to(device) for k, v in p.items()}


NEAR_TIE = 1e-6


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v3_671b"])
def test_moe_fwd_on_the_card_matches_the_cpu(lm_card, arch,
                                             capacity_factor):
    """Float32, TF32 off: a token may reach another expert on the card
    only at a near-tie of the CPU's own probabilities (at the first rank
    where its experts differ, that probability and the next within
    ``NEAR_TIE``, relative); the tokens routed and kept alike are equal
    within 1e-4."""
    from repro_torch.models import moe as MOE
    cfg = _moe_cfg(arch, torch.float32, capacity_factor=capacity_factor)
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in ("cpu", lm_card):
        p = _moe_params(cfg, dev)
        xd = x.to(dev)
        _, top_e, probs, aux = MOE.route(p["router"], xd.reshape(
            -1, cfg.d_model), cfg)
        kept, _ = MOE.assign_slots(top_e, cfg.num_experts,
                                   MOE.capacity(len(top_e), cfg))
        y, aux_y = MOE.moe_fwd(p, xd, cfg)
        assert torch.equal(aux, aux_y)
        runs.append([t.cpu() for t in (top_e, probs, kept, y, aux)])
    (e_c, p_c, k_c, y_c, a_c), (e_g, _, k_g, y_g, a_g) = runs
    differ = (e_g != e_c).any(1)
    for t in differ.nonzero().flatten().tolist():
        j = int((e_g[t] != e_c[t]).nonzero()[0])
        ps = p_c[t].double().sort(descending=True).values
        assert ps[j] - ps[j + 1] <= NEAR_TIE * ps[j], (t, e_g[t], e_c[t])
    same = ~differ & (k_g.view(len(e_c), -1) == k_c.view(len(e_c), -1)).all(1)
    torch.testing.assert_close(y_g.reshape(len(e_c), -1)[same],
                               y_c.reshape(len(e_c), -1)[same], atol=1e-4,
                               rtol=1e-4)
    if not differ.any():
        torch.testing.assert_close(a_g, a_c, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v3_671b"])
def test_moe_fwd_bfloat16_repeats_bit_for_bit_on_the_card(card, arch):
    """The combine adds each token's contributions in a fixed order, so a
    bfloat16 run repeats to the bit (a scatter-add with atomics would
    not)."""
    from repro_torch.models import moe as MOE
    cfg = _moe_cfg(arch, torch.bfloat16, top_k=4)
    p = _moe_params(cfg, card)
    x = torch.randn((8, 512, cfg.d_model), generator=torch.Generator(
        ).manual_seed(2)).to(torch.bfloat16).to(card)
    y1, _ = MOE.moe_fwd(p, x, cfg)
    y2, _ = MOE.moe_fwd(p, x, cfg)
    assert torch.equal(y1, y2)


def test_stablelm_two_layers_full_width_on_the_card_matches_the_cpu(lm_card):
    """``stablelm_12b`` at full width, 2 layers, float32: prefill over two
    attention chunks (1040 tokens) and 3 decode steps on padded caches,
    the CPU fed the card's tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("stablelm_12b").with_(num_layers=2, dtype="float32")
    mdl = M.build(cfg, lm_card, torch.Generator(device=lm_card).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 1040),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for dev in (lm_card, "cpu"):
        mdl.to(dev)
        logits, caches = mdl.prefill({"tokens": tokens})
        caches = M.pad_caches(caches, 1043)
        out = [logits.cpu()]
        for t in range(3):
            tok = runs[0][t].argmax(-1) if runs else out[-1].argmax(-1)
            logits, caches = mdl.decode(caches, tok, 1040 + t)
            out.append(logits.cpu())
        runs.append(out)
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_kb_linearizer_on_a_card_kb_matches_the_cpu(card):
    from repro_torch.data.pipeline import KBLinearizer
    streams = []
    for device in (card, "cpu"):
        kb = EngineKB(LUBM_L, lubm_facts(n_univ=2), device=device)
        materialize(kb, mode="tg")
        lin = KBLinearizer(kb, 4, 64, seed=1)
        streams.append((lin.vocab_size, lin.stream, lin.next()["tokens"]))
    (vg, sg, bg), (vc, sc, bc) = streams
    assert vg == vc
    assert np.array_equal(sg, sc) and np.array_equal(bg, bc)


# ---------------------------------------------------------------------------
# the cost walk (``repro_torch.analysis``) on the card
# ---------------------------------------------------------------------------
def test_counts_on_the_card_equal_the_cpus(card, monkeypatch):
    """One count on both devices: the sorted-store cores at 2^12 rows
    (arity 1 reaches the sort kernel, arity 2 the packed-key argsort) and
    the fused programs of LUBM-L ``n_univ=1`` from one memo, every field
    equal, kernel formulas included."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.engine.fused import lower_fused_programs
    for arity in (1, 2):
        assert RL.engine_op_roofline(1 << 12, arity, device=card) == \
            RL.engine_op_roofline(1 << 12, arity, device="cpu")
    monkeypatch.setenv("REPRO_FUSED", "1")
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    kbs = []
    for device in (card, "cpu"):
        kb = EngineKB(LUBM_L, lubm_facts(n_univ=1), device=device)
        materialize(kb, mode="tg")
        kbs.append(kb)
    got, want = (lower_fused_programs(kb) for kb in kbs)
    assert got == want and set(got) == {"round", "fixpoint"}
    assert "probe_sorted" in got["round"]["kernels"]


def test_a_replayed_graph_adds_its_capture_count(card):
    """A captured program's count (kept apart at capture, as its launches
    are) is added once per replay: three calls of a ``_Replay`` count
    three runs of the function and the first call's copy of its input."""
    from repro_torch.analysis import cost
    n = 1 << 12
    keys = torch.randint(0, 1 << 20, (n,), device=card, dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=card)
    w = torch.randn(64, 64, device=card)

    def fn(k):
        ks, _ = KO.sort_with_payload(k, pos, tile=256)
        return ks, w @ w

    with cost.Recorder() as one:
        fn(keys)
    rep = fused._Replay(fn)
    with cost.Recorder() as r:
        rep(keys)
        rep(*rep.static)
        rep(*rep.static)
    torch.cuda.synchronize()
    got, once = r.as_dict(), one.as_dict()
    assert got.get("unrecorded", 0) == 0
    for field in ("flops", "dot_flops", "sorts"):
        assert got[field] == 3 * once[field], field
    assert got["kernels"] == {k: {f: 3 * v for f, v in c.items()}
                              for k, c in once["kernels"].items()}
    assert got["bytes"] == 3 * once["bytes"] + 2 * keys.nbytes   # the clone


def test_a_fused_materialization_counts_on_the_card(fused_card):
    """LUBM-L ``n_univ=4`` materialized cold under a ``cost.Recorder``, on
    the card (its rounds and fixpoint captured while counting) and on the
    CPU, each from an empty memo and program cache: the rows of both
    equal, every replay counted, the same kernel and sort calls and kernel
    FLOPs; the sort and mask bytes equal, and the card's probe bytes, a
    captured probe counting its bound, no fewer than the CPU's."""
    from repro_torch.analysis import cost
    prog, facts = WORKLOADS["lubm"]()
    out = {}
    for device in (fused_card, "cpu"):
        plan._CAP_MEMO.clear()
        fused.clear_programs()
        with cost.Recorder() as r:
            rows, counted, _ = _fused_run(prog, facts, device)
        torch.cuda.synchronize()
        out[str(device)] = rows, counted, r.as_dict()
    (rg, cg, got), (rc, cc, want) = out["cuda"], out["cpu"]
    assert cg == cc and cg[4] == {"fused": True}
    assert all(np.array_equal(rg[p], rc[p]) for p in rc)
    assert "unrecorded" not in got and got["sorts"] == want["sorts"]
    assert set(got["kernels"]) == set(want["kernels"]) >= {
        "bitonic_sort_tiles", "unique_mask", "probe_sorted"}
    for name, k in want["kernels"].items():
        g = got["kernels"][name]
        assert (g["calls"], g["flops"]) == (k["calls"], k["flops"]), name
        if name == "probe_sorted":
            assert g["bytes"] >= k["bytes"]
        else:
            assert g["bytes"] == k["bytes"], name


def test_counted_cores_at_phase5_shapes_leave_the_card_sound(card):
    """The steps of the smoke's phase 16 alone, each followed by a
    synchronize that would raise a CUDA error left by any launch:
    ``engine_op_roofline`` at phase 5's largest shapes (2^22 int32 keys at
    arity 1, 2^23 rows of two int32 columns), then one counted
    ``unique_mask`` call on rows of that shape, whose mask equals its
    plain version and whose count is its formula."""
    from repro_torch.analysis import cost
    from repro_torch.analysis import roofline as RL
    for n, arity in ((1 << 22, 1), (1 << 23, 2)):
        got = RL.engine_op_roofline(n, arity, np.int32, device=card)
        torch.cuda.synchronize()
        assert got["sort"]["bytes"] > 0, (n, arity)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 20, (1 << 23, 2)).astype(np.int32)
    rows = torch.from_numpy(rows[np.lexsort(rows.T[::-1])]).to(card)
    with cost.Recorder() as r:
        mask = KO.unique_mask(rows)
    torch.cuda.synchronize()
    assert torch.equal(mask.cpu(), ref.unique_mask_ref(rows.cpu()))
    assert r.as_dict()["bytes"] == rows.numel() * 4 + 4 * rows.shape[0]


def _mesh_serve(mcx, cfg, tokens, gen):
    """Prefill ``tokens`` and ``gen`` greedy decode steps as the rank
    ``mcx`` (or without a mesh): the rank's logits of every step."""
    from repro_torch.models import model as M
    dev = tokens.device
    mdl = M.build(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                  mesh=mcx)
    logits, caches = mdl.prefill({"tokens": tokens})
    out = [logits]
    caches = M.pad_caches(caches, tokens.shape[1] + gen, mcx)
    tok = mdl._tokens(logits, mdl._mesh_for(len(tokens)))
    for t in range(gen):
        logits, caches = mdl.decode(caches, tok, tokens.shape[1] + t)
        tok = mdl._tokens(logits, mdl._mesh_for(len(tokens)))
        out.append(logits)
    return out


@pytest.mark.parametrize("arch,more,shape", [
    ("stablelm_12b", {}, (1, 2)), ("stablelm_12b", {}, (1, 4)),
    ("deepseek_v3_671b", {"capacity_factor": 4.0}, (2, 2)),
    ("qwen3_moe_30b_a3b", {"moe_dispatch": "a2a", "capacity_factor": 4.0},
     (2, 2))])
def test_thread_ranks_on_the_card_equal_one_device(card, arch, more, shape):
    """Smoke configs in float32 (TF32 off): thread ranks sharing the card
    give the run without a mesh, rank by rank (its rows)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).with_(dtype="float32", **more)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    want = _mesh_serve(None, cfg, tokens, 4)
    dp, tp = shape
    for r, got in enumerate(make_host_mesh(dp, tp).run(
            _mesh_serve, cfg, tokens, 4)):
        rows = slice(r // tp * 2 // dp, (r // tp + 1) * 2 // dp)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w[rows], atol=1e-4, rtol=1e-4)


def test_an_nccl_world_of_one_serves_as_no_mesh(card):
    """The process path at tp = 1: an in-process NCCL world of one gives
    the bfloat16 smoke model's run without a mesh to the bit."""
    import socket

    import torch.distributed as dist
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import mesh as MESH
    cfg = get_smoke_config("stablelm_12b")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    want = _mesh_serve(None, cfg, tokens, 4)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        got = _mesh_serve(MESH.make_mesh_ctx(MESH.make_process_mesh()), cfg,
                          tokens, 4)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# training on a mesh on the card
# ---------------------------------------------------------------------------
def _train_step_on(mcx, cfg, batch, device):
    """One ``train_step`` of ``cfg`` (seed 0) as the rank ``mcx`` on
    ``device``: its metrics and its weights gathered whole."""
    from repro_torch.models.model import build
    mdl = build(cfg, device, torch.Generator(device).manual_seed(0),
                training=True, mesh=mcx)
    _, met = mdl.train_step(mdl.init_opt_state(), batch, 0)
    return {k: float(v) for k, v in met.items()}, mdl.global_weights()


def _smoke_batch(cfg, device, rows=4, seq=32):
    tok = torch.randint(0, cfg.vocab_size, (rows, seq + 1), device=device,
                        generator=torch.Generator(device).manual_seed(1))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _held_against(got, want):
    met, w = got
    for k in ("loss", "ce", "grad_norm"):
        assert met[k] == pytest.approx(want[0][k], rel=1e-5), k
    for n, t in want[1].items():
        torch.testing.assert_close(w[n], t, atol=1e-6, rtol=0)


def test_thread_ranks_raise_at_once_for_a_backward_on_the_card(card):
    """Thread ranks at tp = 2 on the card: the backward's first collective
    raises at once (autograd runs every thread's device nodes on one
    worker thread, so a rank waiting there would stall the others until
    ``WAIT_S``)."""
    import time

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_smoke_config("stablelm_12b").with_(dtype="float32")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="thread ranks cannot run"):
        make_host_mesh(1, 2).run(_train_step_on, cfg,
                                 _smoke_batch(cfg, card), card)
    assert time.perf_counter() - t0 < 60


def test_data_parallel_thread_ranks_train_on_the_card(card):
    """At (2, 1) no collective runs inside the backward: thread ranks
    train on the card, equal to one device (float32, TF32 off)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("zamba2_1p2b").with_(dtype="float32")
    batch = _smoke_batch(cfg, card)
    want = _train_step_on(None, cfg, batch, card)
    _held_against(make_host_mesh(2, 1).run(_train_step_on, cfg, batch,
                                           card)[0], want)


def _gloo_rank_on_the_card(rank, port, out, card):
    import pickle

    import torch.distributed as dist
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import mesh as MESH
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    cfg = get_smoke_config("stablelm_12b").with_(dtype="float32")
    from torch_card_comm import CardComm
    mesh = MESH.ProcessMesh(1, 2, comm=CardComm if card else None)
    got = _train_step_on(MESH.make_mesh_ctx(mesh), cfg,
                         _smoke_batch(cfg, "cuda"), "cuda")
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump((got[0], {n: t.cpu() for n, t in got[1].items()}),
                        f)
    dist.destroy_process_group()


@pytest.mark.parametrize("through_card", [False, True],
                         ids=["gloo", "card_buffers"])
def test_gloo_processes_train_at_tp_2_on_one_card(card, tmp_path,
                                                  through_card):
    """tp > 1 on one card: two processes of a gloo group (NCCL refuses two
    ranks on one device) share the card and give one device's step, their
    collectives carried by gloo (which takes CUDA tensors) or through
    staging buffers on the card (``ProcessMesh(..., comm=CardComm)``)."""
    import pickle
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "step.pkl"
    torch.multiprocessing.start_processes(
        _gloo_rank_on_the_card, args=(port, str(out), through_card),
        nprocs=2, join=True, start_method="spawn")
    from repro_torch.configs.base import get_smoke_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("stablelm_12b").with_(dtype="float32")
    met, w = _train_step_on(None, cfg, _smoke_batch(cfg, card), card)
    with open(out, "rb") as f:
        got = pickle.load(f)     # written by the processes above
    _held_against(got, (met, {n: t.cpu() for n, t in w.items()}))
