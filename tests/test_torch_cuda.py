"""The port on the card: each CUDA kernel against its plain version, the
slice on ``cuda`` against the same run on the CPU (``tg_linear`` too), and
the fused executor's captured rounds and device loop against their eager
runs.  These tests need a CUDA
card and skip without one; on the machine with the card run

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
