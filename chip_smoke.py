"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and print the build time;
2. hold every kernel against its plain PyTorch version on the card, at
   int16/int32/int64, at engine shapes 2^10 .. 2^24 and at the edge shapes
   (empty, non-pow-2, all-PAD, all-duplicate, PAD-valued keys, haystack of
   length 1), the probe around its shared search table and past L2
   (haystacks of 2^22 and 2^24 keys), and the sort kernels over every
   tile, merge widths from 2 up past the merge's span, ties across the
   halves and one half wholly above the other; results are integers, so
   any mismatch fails;
3. materialize LUBM-L (``lubm_facts(n_univ=2000)``, about 1.08 M base
   facts) with ``mode="tg"`` on the card and hold the result against the
   same run on the CPU: per-predicate row sets, rounds, triggers, derived,
   SORT_STATS and count_pulls; every kernel must have launched;
4. ingest and materialize wide TC (1,000,000 chains, 14,000,000 facts
   without the ``e~aux`` twin of ``e``) on the card, check the fact count
   and hold the result against the same run on the CPU as in phase 3;
5. time each kernel at the largest shape the main path gave it (CUDA
   events around back-to-back calls, and the kernels' device time from a
   torch.profiler trace), beside its plain version, a PyTorch library call
   where one computes the same function, and its bound; and break a whole
   2^22 int32 sort down into its tile sort and its merge at every width,
   beside ``torch.sort(keys, stable=True)``; and time the probe over a
   grid of shapes (``PROBE_GRID``), haystacks past L2 included;
6. profile warm re-runs of both materializations: wall time, the device's
   busy time, and the kernels that took it;
7. maintain both materialized KBs incrementally on the card
   (``materialize_delta``): on LUBM-L delete 1,000 base facts drawn from
   every base predicate, reinsert them, then delete 500 others and insert
   the first 500 again in one call; on wide TC delete 1,000 edges from the
   middle of chains and reinsert them.  Every call is held against the
   same call on the CPU (rows, MatStats with ``extra``, SORT_STATS,
   count_pulls) and against a from-scratch materialization of the updated
   base on the card (fact sets); every kernel must launch in the card's
   delta calls;
8. crash recovery on the card, each run a child process building its own
   KB with ``REPRO_CKPT_DIR`` set: LUBM-L ``n_univ=2000`` killed by
   ``crash:round=2`` (SIGKILL) and resumed to phase 3's result; at
   ``n_univ=200``, ``sigterm:round=2`` (exit 143, then resume), and
   ``ckpt_corrupt:tag=2`` with ``crash:round=2`` (the resume falls back to
   round 1); each save's time and bytes are printed.
9. the fused executor (``REPRO_FUSED=1``) on the card: LUBM-L
   ``n_univ=2000``, wide TC at 1,000,000 chains and the deep chain of
   ``benchmarks/bench_fused.py`` (``tc_facts(192, 16)``, its generator
   copied here), each cold and then warm on a fresh ``EngineKB``.  Every
   run is held against the fused run on the CPU from the same capacity
   memo (rows, MatStats with ``extra``, SORT_STATS, count_pulls,
   fused_pulls, fused_retries) and against the two-phase run on the card
   (rows, rounds, triggers, derived); it must be fused and not spilled,
   the warm run must retry nothing, and the deep chain must give 128
   rounds, 39,546 triggers, 36,314 derived and 21 fused pulls warm.  A
   third run is profiled (wall and device busy time).  Then phase 7's
   first two calls on each of LUBM-L and wide TC (delete, reinsert) run
   under ``REPRO_FUSED=1`` on the warm fused KBs, on the card and on the
   CPU (equal counters and rows), and must equal the same calls on the
   two-phase executor in rows, triggers, derived and ``extra``; one of
   them must hand off to the fused executor and run rounds there.  The
   device loop (``csrc/graph_loop.cu``) is held against the host loop on
   the deep chain's longest phase and timed.
10. ``tg_linear`` on the card: the TG ``min_linear(tglinear(LUBM_LI))`` is
   built on the host and timed (the paper's "Comp" column), then phase 3's
   facts are materialized under LUBM-LI with ``mode="tg_linear"``, with
   and without cleaning, on the card and on the CPU (rows, dictionary,
   rounds, triggers, derived, mode, SORT_STATS and count_pulls equal); the
   card's facts must equal its ``tg`` and ``seminaive`` runs of the same
   KB; the two settings, ``tg`` and ``seminaive`` are timed warm on fresh
   copies of the KB, in turns, and one setting is profiled.  The sort
   kernels and the first-of-run mask must launch with cleaning.
11. the sharded executor (``backend="dist"``, shards run in lockstep on
   the card): ``benchmarks/bench_dist.py``'s three workloads at full size
   (``tc_chain_facts(128)``, ``tc_random_facts(500, 1500)`` and LUBM-L
   ``lubm_facts(n_univ=2, scale=2)``) at 1, 2, 4 and 8 shards, warmed as
   its ``steady`` does, each held to its ``BENCH_dist.json`` row (facts,
   rounds, triggers, derived, warm pulls, retries, fixpoint exits and
   iterations); at 4 shards each also runs on the CPU from the same
   capacity memo (rows and every counter equal).  Then phase 3's facts
   under ``backend="dist"`` at 1 and 4 shards, warm: rows, rounds,
   triggers and derived equal to the card's two-phase run, with the warm
   wall (median of 3), a profiled run's device busy time, peak memory,
   pulls and retries.  Every kernel and the device loop must launch, and
   round and fixpoint programs must be captured; it adds the ``dist``
   line and a ``launches_dist`` key to each kernel row.
12. serving dense LMs (``repro_torch.models``; no kernel of its own):
   LUBM-L ``n_univ=2000`` materialized on the card with ``tg`` (phase 3's
   facts and counts; every kernel must launch), linearized by the port's
   ``KBLinearizer(kb, 8, 256)`` and served by ``examples/kb_to_lm.py``'s
   ``lm_100m`` at the linearizer's vocabulary: prefill and 32 greedy
   tokens on caches padded to 256 + 32, in float32 (TF32 off) on the card
   and on the CPU fed the card's tokens (tokens equal where the margin
   exceeds ``F32_TOL``, logits within it), then in bfloat16 on the card,
   timed.  ``stablelm_12b``'s ``CONFIG`` at full width and depth in
   bfloat16: prefill 8 x 2048 (two attention chunks) cold and warm, 64
   greedy tokens on caches padded to 2048 + 64, finite logits, and the
   first decode step against a re-prefill of the extended prompt (the
   K/V row it wrote and its logits within ``BF16_REL`` in rms, and a
   planted decode that drops its own K/V above it);
   a 2-layer copy at full width in float32 on the card against the CPU
   (each float32 run's decode also within ``F32_RMS`` of its
   re-prefill, and its planted fault above it).  It adds the ``serve``
   line and a ``launches_serve`` key to each kernel row.
13. serving MoE and MLA LMs (``models/moe.py`` and MLA; no kernel of
   their own): phase 12's KB materialized and linearized again (every
   kernel must launch, the tokens equal phase 12's), served by
   ``kb_moe_mla`` (deepseek's layer pattern at ``lm_100m``'s width: MLA,
   1 dense layer, then 16 routed experts top-4 and 1 shared), float32 on
   the card against the CPU fed the card's tokens (every routing
   difference a near-tie on the CPU's probabilities, the rows without one
   held as in phase 12), then bfloat16, timed.  ``qwen3_moe_30b_a3b``'s
   ``CONFIG`` at full width and depth and ``deepseek_v3_671b``'s at full
   width and 4 layers (3 dense, 1 MoE; no MTP head), in bfloat16: prefill
   8 x 2048 cold and warm, 32 greedy tokens on caches padded to 2048 +
   32, finite logits, peak memory, one decode step profiled, and the
   first decode step's cache rows against a re-prefill's within
   ``BF16_REL`` in the layers capacity does not reach (qwen3: layer 0;
   deepseek: all 4), with the planted fault above it; the logits' ratio
   is printed, not held.  Then each at capacity factor E / k, where no
   expert overflows, over 8 x 128: decode against a re-prefill in every
   layer's cache row and the logits, within ``BF16_REL``, the planted
   fault above it (a row whose token a bfloat16 near-tie routes to other
   experts in the two is held up to that layer).  A 2-layer float32 copy
   of qwen3 at full width on the card against the CPU.  It adds the ``serve_moe`` line and a
   ``launches_serve_moe`` key to each kernel row.

It prints a ``{"profile": [...]}`` line, a ``{"sort_2^22": {...}}`` line,
a ``{"probe_grid": {...}}`` line, a ``{"deltas": [...]}`` line, a
``{"recovery": [...]}`` line, a ``{"fused": [...]}`` line, a
``{"tg_linear": {...}}`` line, a ``{"dist": {...}}`` line, a
``{"serve": {...}}`` line, a ``{"serve_moe": {...}}`` line, a
``{"kernels": [...]}`` line,
the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  It needs a CUDA card and the
repository's ``src/`` beside it, and exits non-zero without a result
otherwise.  ``chip_smoke.py --child ...`` is phase 8's child process.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LUBM_UNIV = 2000
TC_CHAINS = 1_000_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
DTYPES = (torch.int16, torch.int32, torch.int64)

KERNELS = {
    "bitonic_sort_tiles": ("src/repro_torch/kernels/csrc/bitonic_sort.cu",
                           "src/repro/kernels/bitonic_sort.py:83"),
    "bitonic_merge_pairs": ("src/repro_torch/kernels/csrc/bitonic_sort.cu",
                            "src/repro/kernels/bitonic_sort.py:102"),
    "unique_mask": ("src/repro_torch/kernels/csrc/unique_mask.cu",
                    "src/repro/kernels/unique_mask.py:42"),
    "probe_sorted": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                     "src/repro/kernels/hash_probe.py:45"),
}
# the device loop of the fused executor: it replaces the reference's
# ``lax.while_loop`` over whole rounds, not a Pallas kernel
GRAPH_LOOP = ("src/repro_torch/kernels/csrc/graph_loop.cu",
              "src/repro/engine/fused.py:250")


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def mismatches(got, want) -> int:
    if got.shape != want.shape:
        return max(got.numel(), want.numel(), 1)
    return int((got != want).sum().item())


def max_abs_err(pairs) -> float:
    err = 0.0
    for got, want in pairs:
        if got.numel():
            err = max(err, float((got.double() - want.double()).abs().max()))
    return err


def time_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls,
    divided by ``reps``; the median of ``runs`` such runs, after warm-up.
    The wrapper's host work between launches is included where the card
    finishes a call before the host has issued the next one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _device_events(prof):
    """The trace's device-side entries (kernels, copies, memsets); the
    host ops that launched them carry the same time and are left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call: the kernels' own time in a torch.profiler
    trace of ``reps`` calls, divided by ``reps`` (host work excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in _device_events(prof)) / 1e3 / reps


def profile_run(name: str, fn) -> dict:
    """Wall time of ``fn`` (ending in a synchronize), the device's busy
    time in it from a torch.profiler trace, the number of device entries
    (kernels, copies, memsets) and the ones that took the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = _device_events(prof)
    busy = sum(e.self_device_time_total for e in ka) / 1e3
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    return {"workload": name, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "kernels": sum(e.count for e in ka),
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def rand_keys(rng, n, dtype, lo=0, hi=1 << 20):
    """n random keys in [lo, hi), hi clipped below the dtype's PAD."""
    hi = min(hi, torch.iinfo(dtype).max)
    return torch.from_numpy(rng.integers(lo, hi, n)).to(dtype).cuda()


def lexsorted_rows(rng, n, c, dt, hi):
    """(n, c) random rows with values in [0, hi), lexsorted."""
    rows = rand_keys(rng, n * c, dt, 0, hi).reshape(n, c)
    weights = hi ** torch.arange(c - 1, -1, -1, device="cuda")
    return rows[torch.argsort((rows.long() * weights).sum(1))].contiguous()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def check_kernels(BS, UM, HP, KO, ref, rng):
    bad = {}

    def record(name, got, want):
        m = mismatches(got, want)
        if m:
            bad[name] = bad.get(name, 0) + m

    for dt in DTYPES:
        pad = torch.iinfo(dt).max
        for lg in (10, 14, 18, 22, 24):
            n = 1 << lg
            keys = rand_keys(rng, n, dt)
            pos = torch.arange(n, dtype=torch.int32, device="cuda")
            tile = min(1024, n)
            ks, vs = BS.bitonic_sort_tiles(keys, pos, tile)
            wk, wv = ref.sort_tiles_ref(keys, pos, tile)
            record("bitonic_sort_tiles", ks, wk)
            record("bitonic_sort_tiles", vs, wv)
            for width in sorted({2 * tile, min(1 << 13, n), n}):
                if width <= tile or width > n:
                    continue
                hk, hv = ref.sort_tiles_ref(keys, pos, width // 2)
                mk, mv = BS.bitonic_merge_pairs(hk, hv, width)
                wk, wv = ref.merge_pairs_ref(hk, hv, width)
                record("bitonic_merge_pairs", mk, wk)
                record("bitonic_merge_pairs", mv, wv)
            # the full sort through kernels.ops, with engine-like PAD tails
            keys_p = keys.clone()
            keys_p[n - n // 8:] = pad
            ks, vs = KO.sort_with_payload(keys_p, pos, tile=1024)
            wk, wv = ref.sort_with_payload_ref(keys_p, pos)
            record("bitonic_sort_tiles", ks, wk)
            record("bitonic_sort_tiles", vs, wv)
            for c in (1, 2, 3):
                rows = lexsorted_rows(rng, n, c, dt, 64)
                rows[n - n // 8:] = pad
                record("unique_mask", UM.unique_mask(rows),
                       ref.unique_mask_ref(rows))
            hay = torch.sort(rand_keys(rng, n // 2, dt, 0, 4 * n)).values
            hay[-(n // 16):] = pad
            q = rand_keys(rng, n, dt, 0, 4 * n)
            q[: n // 16] = pad
            record("probe_sorted", HP.probe_sorted(q, hay),
                   ref.probe_sorted_ref(q, hay))
        # edge shapes through kernels.ops (the engine's entry points)
        for n in (0, 1, 3, 96, 300, 1000):
            keys = rand_keys(rng, n, dt, 0, 50)
            if n >= 3:
                keys[::3] = pad
            pos = torch.arange(n, dtype=torch.int32, device="cuda")
            ks, vs = KO.sort_with_payload(keys, pos, tile=64)
            wk, wv = ref.sort_with_payload_ref(keys, pos)
            record("sort_with_payload", ks, wk)
            record("sort_with_payload", vs, wv)
            if sorted(vs.tolist()) != list(range(n)):
                bad["sort_with_payload"] = bad.get("sort_with_payload", 0) + 1
        for n in (64, 100):
            allpad = torch.full((n,), pad, dtype=dt, device="cuda")
            pos = torch.arange(n, dtype=torch.int32, device="cuda")
            ks, vs = KO.sort_with_payload(allpad, pos)
            record("bitonic_sort_tiles", ks, allpad)
            record("bitonic_sort_tiles", vs, pos)
        dup = torch.full((256,), 7, dtype=dt, device="cuda")
        pos = torch.arange(256, dtype=torch.int32, device="cuda")
        ks, vs = KO.sort_with_payload(dup, pos, tile=64)
        record("sort_with_payload", vs, pos)
        for n, c in ((0, 2), (1, 1), (96, 2), (300, 3), (1000, 2)):
            rows = lexsorted_rows(rng, n, c, dt, 5)
            got = KO.unique_mask(rows)
            want = (ref.unique_mask_ref(rows) if n else
                    torch.zeros(0, dtype=torch.int32, device="cuda"))
            record("unique_mask", got, want)
        allpad = torch.full((128, 2), pad, dtype=dt, device="cuda")
        record("unique_mask", KO.unique_mask(allpad),
               torch.zeros(128, dtype=torch.int32, device="cuda"))
        dups = torch.tensor([[3, 4]], dtype=dt, device="cuda").repeat(256, 1)
        got = KO.unique_mask(dups)
        record("unique_mask", got, ref.unique_mask_ref(dups))
        if int(got.sum()) != 1:
            bad["unique_mask"] = bad.get("unique_mask", 0) + 1
        for nq, nh in ((0, 4), (64, 0), (1, 1), (100, 37), (300, 3),
                       (1024, 1)):
            hay = torch.unique(rand_keys(rng, nh, dt, 0, 4 * max(nh, 1)))
            q = rand_keys(rng, nq, dt, 0, 4 * max(nh, 1))
            got = KO.probe_sorted(q, hay)
            want = (ref.probe_sorted_ref(q, hay) if hay.numel() else
                    torch.zeros(nq, dtype=torch.int32, device="cuda"))
            record("probe_sorted", got, want)
        q = torch.full((64,), pad, dtype=dt, device="cuda")
        record("probe_sorted",
               KO.probe_sorted(q, torch.arange(16, device="cuda").to(dt)),
               torch.zeros(64, dtype=torch.int32, device="cuda"))
        q = torch.tensor([4, 5, 6], dtype=dt, device="cuda")
        record("probe_sorted",
               KO.probe_sorted(q, torch.full((32,), 5, dtype=dt,
                                             device="cuda")),
               torch.tensor([0, 1, 0], dtype=torch.int32, device="cuda"))
    check_probe_edges(HP, ref, rng, record)
    check_sort_sweep(BS, ref, rng, record)
    torch.cuda.synchronize()
    return bad


PROBE_KINDS = ("distinct", "runs", "pad_tail", "all_pad", "below", "above")


def probe_inputs(rng, kind, nq, nh, dt):
    """(queries, sorted haystack) on the card: "distinct" keys (every 7th
    query PAD), "runs" of one key (the longest over the middle of the
    haystack), a "pad_tail" of a third of the haystack, "all_pad", or
    every query "below" the first key / "above" the last."""
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


def check_probe_edges(HP, ref, rng, record):
    """The probe around its shared search table: haystacks of 2^L - 1, 2^L
    and 2^L + 1 keys for L = 8, 10, 12, and (the table holds heads of
    128-byte lines, u keys each) of 2^L - 1, 2^L and 2^L + 1 heads for
    L = 8 and 12, each a key short, exact and a key over, with 2^14
    queries (the narrow grid) and 2^19 (the wide one); one key; lengths
    that leave the search below the table several steps; 2^22 and 2^24
    keys (past the 50 MB L2 at int32 and int64); each of ``PROBE_KINDS``
    at int16/int32/int64; and haystacks that are views starting inside a
    128-byte line."""
    for dt in DTYPES:
        u = 128 // torch.tensor([], dtype=dt).element_size()
        sizes = [(1 << lv) + d for lv in (8, 10, 12) for d in (-1, 0, 1)]
        sizes += [((1 << lv) + d) * u + e for lv in (8, 12)
                  for d in (-1, 0, 1) for e in (-1, 0, 1)]
        sizes += [1, 9 << 12, (81 << 12) + 5, (729 << 12) - 1]
        for kind in PROBE_KINDS:
            for nh in sizes:
                for nq in (1 << 14, 1 << 19):
                    q, hay = probe_inputs(rng, kind, nq, nh, dt)
                    record("probe_sorted", HP.probe_sorted(q, hay),
                           ref.probe_sorted_ref(q, hay))
        for nh in (1 << 22, 1 << 24):
            for kind in ("distinct", "pad_tail"):
                q, hay = probe_inputs(rng, kind, 1 << 16, nh, dt)
                record("probe_sorted", HP.probe_sorted(q, hay),
                       ref.probe_sorted_ref(q, hay))
        # haystacks that start inside a 128-byte line: views at an offset
        q, hay = probe_inputs(rng, "distinct", 1 << 14, 5000, dt)
        for off in (1, 3, 7, 9):
            view = hay[off:]
            record("probe_sorted", HP.probe_sorted(q, view),
                   ref.probe_sorted_ref(q, view))


def sweep_inputs(rng, n, width, dt, case):
    """(keys, payload) of length n for one case of ``check_sort_sweep``;
    "a_above" / "b_above" put the first / second half of every width-block
    wholly above the other."""
    pad = torch.iinfo(dt).max
    pos = torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()
    if case == "random":
        keys = rand_keys(rng, n, dt, 0, 1 << 12)
    elif case == "equal":        # ties across the halves; payload orders
        keys = torch.full((n,), 7, dtype=dt, device="cuda")
        pos = pos % 5            # and equal pairs too
    elif case == "pad":
        keys = torch.full((n,), pad, dtype=dt, device="cuda")
    elif case == "max":          # the dtype's max beside real keys
        keys = rand_keys(rng, n, dt, 0, 64)
        keys[torch.from_numpy(rng.random(n) < 0.25).cuda()] = pad
    else:
        keys = rand_keys(rng, n, dt, 0, 1000)
        upper = (torch.arange(n, device="cuda") % width) >= width // 2
        keys = keys + 1000 * (~upper if case == "a_above" else upper).to(dt)
    return keys, pos


def check_sort_sweep(BS, ref, rng, record):
    """Every power-of-two tile up to the shared-memory block (at 4 blocks
    and at 3 tiles), and merges at widths 2, 4, 8, the merge kernel's span,
    twice the span and 2^16 (plus ragged lengths that leave the last span
    short), each at int16/int32/int64 with random, all-equal, all-PAD,
    max-beside-real and one-half-above-the-other keys."""
    from repro_torch.kernels import build
    smem_block, span = build.library().rt_smem_block(), BS.merge_span()
    cases = ("random", "equal", "pad", "max", "a_above", "b_above")
    for dt in DTYPES:
        tile = 1
        while tile <= smem_block:
            for n in (4 * smem_block, 3 * tile):
                for case in cases:
                    keys, pos = sweep_inputs(rng, n, tile, dt, case)
                    got = BS.bitonic_sort_tiles(keys, pos, tile)
                    want = ref.sort_tiles_ref(keys, pos, tile)
                    record("bitonic_sort_tiles", got[0], want[0])
                    record("bitonic_sort_tiles", got[1], want[1])
            tile *= 2
        for width in (2, 4, 8, 16, span, 2 * span, 1 << 16):
            lengths = {max(1 << 17, 2 * width), 3 * width}
            if width < span:
                lengths.add(span + span // 2)
            for n in sorted(lengths):
                for case in cases:
                    keys, pos = ref.sort_tiles_ref(
                        *sweep_inputs(rng, n, width, dt, case), width // 2)
                    got = BS.bitonic_merge_pairs(keys, pos, width)
                    want = ref.merge_pairs_ref(keys, pos, width)
                    record("bitonic_merge_pairs", got[0], want[0])
                    record("bitonic_merge_pairs", got[1], want[1])


# ---------------------------------------------------------------------------
# phase 3/4: the slice through the user's entry points
# ---------------------------------------------------------------------------
def rows_by_pred(kb):
    """Each predicate's rows, in the engine's lexsort order."""
    from repro_torch.engine.relation import host_order
    out = {}
    for p, rel in kb.rels.items():
        rows = rel.np_rows()
        out[p] = rows[host_order(rows)]
    return out


def run_lubm(device, facts):
    """EngineKB + materialize(tg) of LUBM-L on ``device``: the KB, its
    stats, (EngineKB s, materialize s) and (SORT_STATS, count_pulls)."""
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import LUBM_L
    from repro_torch.engine import ops
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kb = EngineKB(LUBM_L, facts, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = materialize(kb, mode="tg")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return kb, st, (t1 - t0, t2 - t1), (dict(vars(ops.SORT_STATS)),
                                        ops.HOST_SYNC_STATS.count_pulls)


def run_tc_wide(device):
    """EngineKB.from_stream + materialize(tg) of wide TC on ``device``: the
    KB, its stats, (ingest s, materialize s) and (SORT_STATS,
    count_pulls)."""
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import TC, tc_wide_chunks
    from repro_torch.engine import ops
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kb = EngineKB.from_stream(TC, tc_wide_chunks(TC_CHAINS), device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = materialize(kb, mode="tg")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return kb, st, (t1 - t0, t2 - t1), (dict(vars(ops.SORT_STATS)),
                                        ops.HOST_SYNC_STATS.count_pulls)


class ShapeLog:
    """Records the largest call each kernel wrapper gets during the main
    path (the launch counts themselves live in the wrappers)."""

    def __init__(self, BS, UM, HP):
        self.largest = {}
        self.mods = []
        for mod, names in ((BS, ("bitonic_sort_tiles", "bitonic_merge_pairs")),
                           (UM, ("unique_mask",)), (HP, ("probe_sorted",))):
            for name in names:
                self.mods.append((mod, name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def wrapped(*args):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            best = self.largest.get(name)
            if args[0].is_cuda and (best is None or size >= best[0]):
                self.largest[name] = (size, args)
            return fn(*args)
        return wrapped

    def __enter__(self):
        for mod, name, fn in self.mods:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.mods:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# phase 5: times at the main path's largest shapes
# ---------------------------------------------------------------------------
def kernel_rows(largest, launches, BS, UM, HP, ref):
    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name not in largest:
            fail(f"{name} got no call on the main path")
        _, args = largest[name]
        if name in ("bitonic_sort_tiles", "bitonic_merge_pairs"):
            keys, vals, block = args
            keys, vals = keys.clone(), vals.clone()
            fn = BS.bitonic_sort_tiles if name == "bitonic_sort_tiles" \
                else BS.bitonic_merge_pairs
            plain = ref.sort_tiles_ref if name == "bitonic_sort_tiles" \
                else ref.merge_pairs_ref
            kern = lambda: fn(keys, vals, block)  # noqa: E731
            base = lambda: plain(keys, vals, block)  # noqa: E731
            lib = lambda: torch.sort(keys.view(-1, block), dim=1)  # noqa: E731
            n = keys.numel()
            nbytes = 2 * n * (keys.element_size() + 4)
            shape = {"n": n, "dtype": str(keys.dtype), "block": block}
        elif name == "unique_mask":
            (data,) = args
            data = data.clone()
            kern = lambda: UM.unique_mask(data)  # noqa: E731
            base = lambda: ref.unique_mask_ref(data)  # noqa: E731
            lib = None
            n, c = data.shape
            nbytes = data.numel() * data.element_size() + 4 * n
            shape = {"n": n, "cols": c, "dtype": str(data.dtype)}
        else:
            q, hay = (a.clone() for a in args)
            kern = lambda: HP.probe_sorted(q, hay)  # noqa: E731
            base = lambda: ref.probe_sorted_ref(q, hay)  # noqa: E731

            def lib():
                idx = torch.searchsorted(hay, q).clamp_(max=hay.numel() - 1)
                return hay[idx] == q
            n, h = q.numel(), hay.numel()
            nbytes = probe_bytes(q, hay)
            shape = {"n": n, "hay": h, "dtype": str(q.dtype)}
        got, want = kern(), base()
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        mism = sum(mismatches(g, w) for g, w in pairs)
        err = max_abs_err(pairs)
        if mism:
            fail(f"{name} disagrees with its plain version at {shape}")
        ms = time_ms(kern)
        dev_ms = device_ms(kern)
        plain_ms = time_ms(base)
        library_ms = time_ms(lib) if lib is not None else None
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "mismatches": mism, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms, "shape": shape})
    return rows


def probe_bytes(q, hay) -> int:
    """Bytes the membership probe must move on these inputs: the queries
    read and the flags written once, and of the haystack the 32-byte
    sectors that hold the queries' lower bounds (an answer rests on
    the key there; no search needs to read the rest)."""
    sector = 32 // hay.element_size()
    pos = torch.searchsorted(hay, q).clamp_(max=hay.numel() - 1)
    return (q.numel() * (q.element_size() + 4)
            + torch.unique(pos // sector).numel() * 32)


# (queries, haystack keys, key type) of the probe's shape grid
PROBE_GRID = [(n, h, dt) for dt in (torch.int32, torch.int64)
              for n in (1 << 16, 1 << 20)
              for h in (1 << 12, 1 << 18, 1 << 22, 1 << 24)]


def probe_grid(HP, ref, rng) -> dict:
    """The probe over ``PROBE_GRID``: random keys in [0, 4H), so about a
    fifth of the queries are found; mismatches against the plain version,
    device time, time per call, and the byte bound (``probe_bytes``).  At
    2^24 keys the haystack (64 MB at int32, 128 MB at int64) is larger
    than the 50 MB L2."""
    out = {}
    for n, h, dt in PROBE_GRID:
        hay = torch.sort(rand_keys(rng, h, dt, 0, 4 * h)).values
        q = rand_keys(rng, n, dt, 0, 4 * h)
        kern = functools.partial(HP.probe_sorted, q, hay)
        out[f"{n}/{h}/{str(dt).split('.')[-1]}"] = {
            "mismatches": mismatches(kern(), ref.probe_sorted_ref(q, hay)),
            "device_ms": device_ms(kern), "ms": time_ms(kern),
            "bound_ms": probe_bytes(q, hay) / HBM_BYTES_PER_S * 1e3}
        del hay, q
    return out


def sort_breakdown(BS, KO, rng) -> dict:
    """A whole 2^22 int32 ``sort_with_payload`` (tile 1024): the device
    time of its tile sort and of its merge at each width, of the whole sort,
    and of ``torch.sort(keys, stable=True)`` as a yardstick the port never
    calls.  The bound counts one read and one write of every key and
    payload per kernel call."""
    n, tile = 1 << 22, 1024
    keys = rand_keys(rng, n, torch.int32, 0, 1 << 30)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    cur = BS.bitonic_sort_tiles(keys, pos, tile)
    merge_ms = {}
    width = 2 * tile
    while width <= n:
        merge = functools.partial(BS.bitonic_merge_pairs, *cur, width)
        merge_ms[str(width)] = device_ms(merge)
        cur = merge()
        width *= 2
    full = lambda: KO.sort_with_payload(keys, pos, tile=tile)  # noqa: E731
    lib = lambda: torch.sort(keys, stable=True)  # noqa: E731
    calls = 1 + len(merge_ms)
    return {"n": n, "tile": tile, "kernel_calls": calls,
            "tile_device_ms": device_ms(
                lambda: BS.bitonic_sort_tiles(keys, pos, tile)),
            "merge_device_ms": merge_ms,
            "sort_ms": time_ms(full), "sort_device_ms": device_ms(full),
            "bound_ms": calls * 2 * n * 8 / HBM_BYTES_PER_S * 1e3,
            "torch_sort_ms": time_ms(lib), "torch_sort_device_ms":
            device_ms(lib)}


# ---------------------------------------------------------------------------
# phase 7: incremental maintenance at full size
# ---------------------------------------------------------------------------
DELTA_LUBM = 1000       # base facts deleted and reinserted (then 500 + 500)
DELTA_TC = 1000         # mid-chain edges deleted and reinserted
DRILL_UNIV = 200        # LUBM-L size of the SIGTERM and corruption drills


def sync():
    torch.cuda.synchronize()


def draw_facts(facts, n, rng, taken=()):
    """``n`` distinct base facts outside ``taken``, drawn with ``rng`` from
    every predicate in turn (each predicate's facts in a random order), so
    that the arity-1 predicates are among them."""
    taken = set(taken)
    pools = {}
    for f in dict.fromkeys(facts):
        if f not in taken:
            pools.setdefault(f.pred, []).append(f)
    order = {p: rng.permutation(len(pools[p])) for p in sorted(pools)}
    out, k = [], 0
    while len(out) < n and any(k < len(v) for v in order.values()):
        for p, perm in order.items():
            if k < len(perm) and len(out) < n:
                out.append(pools[p][perm[k]])
        k += 1
    return out


def id_translation(src, dst) -> np.ndarray:
    """``dst``'s id of each of ``src``'s term ids (dense from 0)."""
    out = np.full(len(src), -1, np.int64)
    if src._from_id:
        ids = np.fromiter(src._from_id.keys(), np.int64, len(src._from_id))
        terms = np.empty((len(ids), 1), dtype=object)
        terms[:, 0] = list(src._from_id.values())
        out[ids] = dst.encode_columns(terms)[:, 0]
    if len(src._dec_ids):
        out[src._dec_ids] = dst.encode_columns(
            src._dec_vals.reshape(-1, 1))[:, 0]
    return out


def same_facts(kb, other) -> bool:
    """Whether two KBs hold the same facts, whatever their dictionaries'
    ids (no nulls: LUBM-L and TC have no existentials)."""
    from repro_torch.engine.relation import host_order
    trans = id_translation(other.dict, kb.dict)
    for p in set(kb.rels) | set(other.rels):
        a = kb.rels[p].np_rows() if p in kb.rels else np.zeros((0, 1))
        b = other.rels[p].np_rows() if p in other.rels else np.zeros((0, 1))
        if len(a) != len(b):
            return False
        if not len(a):
            continue
        b = trans[b].astype(a.dtype)
        if not np.array_equal(a[host_order(a)], b[host_order(b)]):
            return False
    return True


def counters_of(st):
    from repro_torch.engine import ops
    return ((st.rounds, st.triggers, st.derived, st.mode, dict(st.extra)),
            dict(vars(ops.SORT_STATS)), ops.HOST_SYNC_STATS.count_pulls)


def delta_call(kb, ins, dels):
    """One ``materialize_delta`` call: its counters, wall s and launches."""
    from repro_torch.engine import ops
    from repro_torch.kernels import ops as KO
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    sync()
    KO.reset_launch_counts()
    t0 = time.perf_counter()
    st = kb.materialize_delta(insertions=ins, deletions=dels)
    sync()
    wall = time.perf_counter() - t0
    return counters_of(st), wall, KO.launch_counts()


def run_deltas(name, kb_g, kb_c, calls, scratch):
    """Each of ``calls`` ((label, insertions, deletions, base after)) on the
    card's KB and the CPU's, held against each other and against
    ``scratch(base after)``, a from-scratch KB materialized on the card.
    Returns one record per call and the card's launches summed."""
    from repro_torch import materialize
    out, launches = [], {k: 0 for k in KERNELS}
    for label, ins, dels, base in calls:
        cnt_g, wall_g, lc = delta_call(kb_g, ins, dels)
        for k in launches:
            launches[k] += lc[k]
        cnt_c, wall_c, _ = delta_call(kb_c, ins, dels)
        if cnt_g != cnt_c:
            fail(f"{name} {label}: card {cnt_g} vs cpu {cnt_c}")
        rg, rc = rows_by_pred(kb_g), rows_by_pred(kb_c)
        if rg.keys() != rc.keys() or any(
                not np.array_equal(rg[p], rc[p]) for p in rg):
            fail(f"{name} {label}: fact rows differ between cuda and cpu")
        sync()
        t0 = time.perf_counter()
        kb_s = scratch(base)
        sync()
        t1 = time.perf_counter()
        materialize(kb_s, mode="tg")
        sync()
        t2 = time.perf_counter()
        if not same_facts(kb_g, kb_s):
            fail(f"{name} {label}: maintained facts differ from a "
                 "from-scratch materialization of the updated base")
        rec = {"workload": name, "call": label, "inserted": len(ins),
               "deleted": len(dels), "stats": cnt_g[0][:3],
               "extra": cnt_g[0][4], "count_pulls": cnt_g[2],
               "delta_ms": wall_g * 1e3, "cpu_delta_ms": wall_c * 1e3,
               "scratch_ingest_ms": (t1 - t0) * 1e3,
               "scratch_materialize_ms": (t2 - t1) * 1e3,
               "facts": kb_g.num_facts(), "launches": lc}
        log(f"[delta] {json.dumps(rec)}")
        out.append(rec)
        del kb_s
    return out, launches


def lubm_delta_calls(facts, rng):
    """Delete 1,000 base facts, reinsert them, then one mixed call that
    deletes 500 others and inserts the first 500 again; each with the base
    it leaves."""
    first = draw_facts(facts, DELTA_LUBM, rng)
    second = draw_facts(facts, DELTA_LUBM // 2, rng, taken=first)
    gone1, gone2 = set(first), set(second)
    after1 = [f for f in facts if f not in gone1]
    after3 = [f for f in facts if f not in gone2]
    return [(f"delete {len(first)}", [], first, after1),
            (f"reinsert {len(first)}", first, [], facts),
            (f"delete {len(second)} + insert {DELTA_LUBM // 2}",
             first[:DELTA_LUBM // 2], second, after3)]


def tc_delta_calls(rng, chain_len=4):
    """Delete 1,000 edges from the middle of distinct chains (offset 1 or
    2 of 4, so each deletion cascades through the closure), then reinsert
    them; each with the base edges it leaves."""
    from repro_torch.core.terms import Atom
    from repro_torch.data.kb_sources import tc_wide_chunks
    edges = np.concatenate([c for _, c in tc_wide_chunks(TC_CHAINS)])
    chains = rng.choice(TC_CHAINS, DELTA_TC, replace=False)
    idx = chains * chain_len + rng.integers(1, chain_len - 1, DELTA_TC)
    dels = [Atom("e", (int(a), int(b))) for a, b in edges[idx]]
    keep = np.ones(len(edges), bool)
    keep[idx] = False
    return [(f"delete {DELTA_TC} mid-chain edges", [], dels, edges[keep]),
            (f"reinsert {DELTA_TC}", dels, [], edges)]


# ---------------------------------------------------------------------------
# phase 8: crash recovery on the card, in child processes
# ---------------------------------------------------------------------------
def child(out_path: str, n_univ: int) -> int:
    """One checkpointed LUBM-L materialization on the card (the settings
    come from the environment): prints a JSON line per save (the device to
    host pull and the write, timed apart, and the bytes written) and, if
    it survives, its counters; writes its rows to ``out_path``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import LUBM_L, lubm_facts
    from repro_torch.engine import materialize as M
    from repro_torch.engine import recovery
    from repro_torch.kernels import ops as KO
    host_state, save = M._host_state, recovery.EngineCheckpointer._save
    pulled = {}

    def timed_host_state(kb, deltas):
        t0 = time.perf_counter()
        out = host_state(kb, deltas)
        pulled["s"] = time.perf_counter() - t0
        return out

    def timed_save(self, st, shards, caps, done):
        t0 = time.perf_counter()
        save(self, st, shards, caps, done)
        path = self.mgr._path(st.rounds)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        log(json.dumps({"save": st.rounds, "host_state_ms":
                        pulled.pop("s") * 1e3, "write_ms":
                        (time.perf_counter() - t0) * 1e3, "bytes": size}))

    M._host_state = timed_host_state
    recovery.EngineCheckpointer._save = timed_save
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=n_univ), device="cuda")
    KO.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    st = materialize(kb, mode="tg")
    sync()
    wall = time.perf_counter() - t0
    np.savez(out_path, **rows_by_pred(kb))
    log(json.dumps({"stats": [st.rounds, st.triggers, st.derived],
                    "extra": st.extra, "materialize_ms": wall * 1e3,
                    "launches": KO.launch_counts()}))
    return 0


def run_child(ckpt_dir, n_univ, fault):
    """Phase 8's child with checkpoints in ``ckpt_dir`` and ``fault`` as
    ``REPRO_FAULT_SPEC``: (exit code, its JSON lines, its rows or None)."""
    out = os.path.join(ckpt_dir, "rows.npz")
    if os.path.exists(out):
        os.remove(out)
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(REPRO_CKPT_DIR=os.path.join(ckpt_dir, "ckpt"),
               REPRO_CKPT_KEEP="3")
    if fault:
        env["REPRO_FAULT_SPEC"] = fault
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", out, str(n_univ)], env=env,
                         capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    rows = None
    if os.path.exists(out):
        with np.load(out) as z:
            rows = {k: z[k] for k in z.files}
    return res.returncode, lines, rows, res.stderr[-3000:]


def recovery_drills(tmp, lubm_rows, lubm_stats):
    """Phase 8: (label, n_univ, fault, expected exit code, expected
    resumed round).  Each faulted run is resumed by a fresh child, which
    must reach the uninterrupted run's rows and counters."""
    import signal
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import LUBM_L, lubm_facts
    from repro_torch.engine import recovery
    small = EngineKB(LUBM_L, lubm_facts(n_univ=DRILL_UNIV), device="cuda")
    st = materialize(small, mode="tg")
    want = {LUBM_UNIV: (lubm_rows, lubm_stats),
            DRILL_UNIV: (rows_by_pred(small),
                         [st.rounds, st.triggers, st.derived])}
    del small
    drills = [("crash", LUBM_UNIV, "crash:round=2", -signal.SIGKILL, 2),
              ("sigterm", DRILL_UNIV, "sigterm:round=2", 143, 3),
              ("ckpt_corrupt", DRILL_UNIV, "ckpt_corrupt:tag=2,crash:round=2",
               -signal.SIGKILL, 1)]
    out = []
    for label, n_univ, fault, rc_want, resumed_want in drills:
        d = os.path.join(tmp, label)
        os.makedirs(d)
        rc, lines, _, err = run_child(d, n_univ, fault)
        if rc != rc_want:
            fail(f"{label}: exit {rc}, expected {rc_want}: {err}")
        loaded = recovery.RecoveryManager(os.path.join(d, "ckpt")).load()
        if loaded is None or loaded[0]["rounds"] != resumed_want:
            fail(f"{label}: no valid checkpoint of round {resumed_want}")
        rc2, lines2, rows, err = run_child(d, n_univ, "")
        if rc2 != 0 or rows is None:
            fail(f"{label}: the resume failed ({rc2}): {err}")
        res = lines2[-1]
        want_rows, want_stats = want[n_univ]
        if res["extra"].get("resumed_rounds") != resumed_want or \
                res["stats"] != list(want_stats):
            fail(f"{label}: resumed {res}, expected round {resumed_want} "
                 f"and {want_stats}")
        if rows.keys() != want_rows.keys() or any(
                not np.array_equal(rows[p], want_rows[p]) for p in rows):
            fail(f"{label}: the resumed facts differ")
        rec = {"drill": label, "n_univ": n_univ, "fault": fault,
               "exit": rc, "saves": [x for x in lines if "save" in x],
               "resume": res,
               "resume_saves": [x for x in lines2 if "save" in x]}
        log(f"[recovery] {json.dumps(rec)}")
        out.append(rec)
    return out



# ---------------------------------------------------------------------------
# phase 9: the fused executor at full size
# ---------------------------------------------------------------------------
# benchmarks/bench_datalog.py's TC layout: the recursive join is on the
# primary column of both the delta and the edge store
DEEP_TC = "e(X, Y) -> T(Y, X)\nT(Y, X) & e(Y, Z) -> T(Z, X)"
DEEP_COUNTS = (128, 39546, 36314)   # rounds, triggers, derived
DEEP_PULLS = 21                     # BENCH_tc.json, tc.fused (warm)


def deep_tc_facts(n_chain: int = 192, n_extra: int = 16, seed: int = 0):
    """benchmarks/bench_datalog.py's ``tc_facts``: a long path (deep
    fixpoint, many rounds) plus random chords; ``benchmarks/bench_fused.py``
    runs it at (192, 16)."""
    from repro_torch.core.terms import parse_atom
    rng = np.random.default_rng(seed)
    edges = [(i, i + 1) for i in range(n_chain)]
    edges += [tuple(e) for e in rng.integers(0, n_chain, (n_extra, 2))]
    return [parse_atom(f"e(v{a}, v{b})") for a, b in edges]


def fused_run(make_kb, device):
    """One ``materialize(kb, "tg")`` of a fresh KB under the current
    ``REPRO_FUSED``: the KB, its counters (counted from before the KB is
    built, as the reference's benchmarks count), the materialize wall s,
    and on the card the launches, captures, device loops and peak bytes."""
    from repro_torch import materialize
    from repro_torch.engine import fused, ops
    from repro_torch.kernels import graph_loop as GL
    from repro_torch.kernels import ops as KO
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = make_kb(device)
    KO.reset_launch_counts()
    GL.LAUNCHES["graph_loop"] = 0
    fused.CAPTURES.update(round=0, fixpoint=0)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = materialize(kb, mode="tg")
    sync()
    wall = time.perf_counter() - t0
    h = ops.HOST_SYNC_STATS
    rec = {"rounds": st.rounds, "triggers": st.triggers,
           "derived": st.derived, "extra": dict(st.extra),
           "count_pulls": h.count_pulls, "fused_pulls": h.fused_pulls,
           "fused_retries": h.fused_retries,
           "sort_stats": dict(vars(ops.SORT_STATS))}
    card = {"wall_ms": wall * 1e3, "launches": KO.launch_counts(),
            "captures": {k: fused.CAPTURES[k] for k in ("round",
                                                         "fixpoint")},
            "graph_loops": GL.LAUNCHES["graph_loop"],
            "peak_bytes": torch.cuda.max_memory_allocated()}
    return kb, rec, card


def same_rows(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[p], b[p])
                                        for p in a)


class LoopRecorder:
    """Keeps a copy of the inputs of every device-loop call (for the loop's
    check against the host loop) while it is entered."""

    def __init__(self):
        from repro_torch.engine import fused
        self.fused = fused
        self.calls = []

    def __enter__(self):
        call = self.orig = self.fused._DeviceLoop.__call__
        calls = self.calls

        def recorded(loop, consts, state, enter=True):
            calls.append((loop, [c.clone() for c in consts],
                          [x.clone() for x in state], enter))
            return call(loop, consts, state, enter)
        self.fused._DeviceLoop.__call__ = recorded
        return self

    def __exit__(self, *exc):
        self.fused._DeviceLoop.__call__ = self.orig


def graph_loop_row(calls, launches):
    """The device loop against its plain version (the host loop) on the
    recorded phase with the most iterations: final states, the time of one
    call (staging copies and the launch, CUDA events), the host loop's time,
    and the bound: the constants read and the state read and written once
    each, over the memory rate."""
    from repro_torch.engine import fused
    best = None
    for loop, consts, state, enter in calls:
        if not enter:
            continue
        out = loop(consts, state, True)
        n = (len(out) - 1) // 2
        iters = int(out[-1][2 * n + 3].item())
        if best is None or iters > best[0]:
            best = (iters, loop, consts, state)
    if best is None:
        fail("the deep chain entered no device loop")
    iters, loop, consts, state = best
    got = [t.clone() for t in loop(consts, state, True)]
    plain = fused._HostLoop(loop.step, loop.cond)
    want = plain(consts, state)
    pairs = list(zip(got, want))
    mism = sum(mismatches(g, w) for g, w in pairs)
    if mism:
        fail(f"graph_loop: the device loop disagrees with the host loop "
             f"({mism} values)")
    nbytes = sum(c.numel() * c.element_size() for c in consts) + 2 * sum(
        x.numel() * x.element_size() for x in state)
    return {"name": "graph_loop", "route": "cuda", "source": GRAPH_LOOP[0],
            "replaces": GRAPH_LOOP[1], "launches": launches,
            "mismatches": mism, "max_abs_err": max_abs_err(pairs),
            "ms": time_ms(lambda: loop(consts, state, True)),
            "plain_ms": time_ms(lambda: plain(consts, state), reps=3,
                                runs=3),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "shape": {"iterations": iters, "state": [list(x.shape)
                                                     for x in state]}}


def fused_workload(name, make_kb, checks):
    """Phase 9 for one workload: two-phase on the card, fused cold and warm
    on the card and on the CPU from the same capacity memo, a profiled
    third run.  Returns (record, summed card launches, device loops, and
    the KBs: warm fused on the card and on the CPU, two-phase on the
    card)."""
    from repro_torch import materialize
    from repro_torch.engine import fused, plan
    os.environ["REPRO_FUSED"] = "0"
    kb_t, two, two_card = fused_run(make_kb, "cuda")
    rows_t = rows_by_pred(kb_t)
    os.environ["REPRO_FUSED"] = "1"
    fused.clear_programs()
    runs = {}
    for device in ("cuda", "cpu"):
        plan._CAP_MEMO.clear()
        runs[device] = [fused_run(make_kb, device) for _ in range(2)]
        log(f"[fused] {name} {device}: {[r[1:] for r in runs[device]]}")
    launches = {k: 0 for k in KERNELS}
    loops = 0
    for (kb_g, rg, cg), (kb_c, rc, _) in zip(runs["cuda"], runs["cpu"]):
        if rg != rc:
            fail(f"{name} fused: card {rg} vs cpu {rc}")
        if rg["extra"] != {"fused": True}:
            fail(f"{name}: not fused, or spilled: {rg['extra']}")
        rows = rows_by_pred(kb_g)
        if not same_rows(rows, rows_by_pred(kb_c)):
            fail(f"{name} fused: rows differ between card and cpu")
        if not same_rows(rows, rows_t) or [rg[k] for k in (
                "rounds", "triggers", "derived")] != [two[k] for k in (
                "rounds", "triggers", "derived")]:
            fail(f"{name}: fused {rg} differs from two-phase {two}")
        for k in KERNELS:
            launches[k] += cg["launches"][k]
        loops += cg["graph_loops"]
    cold, warm = (r[1] for r in runs["cuda"])
    if warm["fused_retries"]:
        fail(f"{name}: the warm fused run retried {warm['fused_retries']}")
    checks(cold, warm)
    kb = make_kb("cuda")
    prof = profile_run(f"{name} fused warm", lambda: materialize(kb))
    rec = {"workload": name, "two_phase": {**two, **two_card},
           "cold": {**cold, **runs["cuda"][0][2]},
           "warm": {**warm, **runs["cuda"][1][2]},
           "profiled_warm": prof,
           "cpu_wall_ms": [r[2]["wall_ms"] for r in runs["cpu"]]}
    log(f"[fused] {json.dumps(rec)}")
    kbs = (runs["cuda"][1][0], runs["cpu"][1][0], kb_t)
    del kb, runs
    return rec, launches, loops, kbs


def fused_deltas(name, kbs, calls):
    """Delta calls under ``REPRO_FUSED=1`` on the warm fused KBs of the card
    and of the CPU, and without it on the two-phase KB of the card.  The
    card's fused call must equal the CPU's (rows, MatStats with ``extra``,
    SORT_STATS, count_pulls, fused_pulls, fused_retries) and the two-phase
    call in rows, triggers, derived and ``extra`` (without the ``fused``
    flag).  Rounds may differ there: a hand-off counts no round in which
    no rule has a live body atom, as on the reference.  Returns the records
    and whether a call handed off to the fused executor and ran rounds
    there (pulled from it)."""
    from repro_torch.engine import ops, plan
    kb_f, kb_c, kb_t = kbs
    out, handed = [], False
    for label, ins, dels, _ in calls:
        got = []
        memo = dict(plan._CAP_MEMO)
        for kb, flag in ((kb_f, "1"), (kb_c, "1"), (kb_t, "0")):
            os.environ["REPRO_FUSED"] = flag
            if kb is kb_c:      # the CPU plans from the card's memo
                plan._CAP_MEMO.clear()
                plan._CAP_MEMO.update(memo)
            cnt, wall, lc = delta_call(kb, ins, dels)
            got.append((cnt + (ops.HOST_SYNC_STATS.fused_pulls,
                               ops.HOST_SYNC_STATS.fused_retries), wall, lc))
        (cnt_f, wall_f, lc), (cnt_c, wall_c, _), (cnt_t, wall_t, _) = got
        if cnt_f != cnt_c or not same_rows(rows_by_pred(kb_f),
                                           rows_by_pred(kb_c)):
            fail(f"{name} {label}: card {cnt_f} vs cpu {cnt_c}")
        extra = dict(cnt_f[0][4])
        flag = extra.pop("fused", False)
        if (cnt_f[0][1:4], extra) != (cnt_t[0][1:4], cnt_t[0][4]):
            fail(f"{name} {label}: fused {cnt_f} vs two-phase {cnt_t}")
        if not same_rows(rows_by_pred(kb_f), rows_by_pred(kb_t)):
            fail(f"{name} {label}: fused rows differ from two-phase")
        handed |= bool(flag) and cnt_f[3] > 0
        rec = {"workload": name, "call": label, "stats": cnt_f[0][:3],
               "two_phase_stats": cnt_t[0][:3], "extra": cnt_f[0][4],
               "count_pulls": cnt_f[2], "fused_pulls": cnt_f[3],
               "fused_retries": cnt_f[4],
               "two_phase_count_pulls": cnt_t[2],
               "fused_delta_ms": wall_f * 1e3, "cpu_delta_ms": wall_c * 1e3,
               "two_phase_delta_ms": wall_t * 1e3, "launches": lc}
        log(f"[fused delta] {json.dumps(rec)}")
        out.append(rec)
    return out, handed


# ---------------------------------------------------------------------------
# phase 10: reasoning over a precomputed linear TG
# ---------------------------------------------------------------------------
# With cleaning, each head predicate's node outputs are deduped: the sorts
# and the first-of-run mask must launch.  The antijoin that follows meets
# LUBM-LI's derived stores while they are still empty, so whether the probe
# launches is recorded, not required.
TG_LINEAR_KERNELS = ("bitonic_sort_tiles", "bitonic_merge_pairs",
                     "unique_mask")
TG_LINEAR_WARM = 5   # warm timed runs of each setting


def same_dictionary(a, b) -> bool:
    """Whether two KBs' dictionaries assign the same ids (so equal rows
    decode to equal facts)."""
    sa, sb = a.dict.state_dict(), b.dict.state_dict()
    return all(np.array_equal(sa[k], sb[k]) if isinstance(sa[k], np.ndarray)
               else sa[k] == sb[k] for k in sa)


def distinct_rows(kb):
    """Each predicate's distinct rows (a store absorbed without cleaning
    keeps the duplicate rows of its node outputs)."""
    return {p: np.unique(rel.np_rows(), axis=0) for p, rel in kb.rels.items()}


def timed_materialize(kb, eg, **kw):
    """One ``materialize`` of ``kb`` (``tg_linear`` over ``eg`` unless
    ``mode`` says otherwise): counters (``counters_of``), wall s and
    launches, counted from just before the call to just after it."""
    from repro_torch import materialize
    from repro_torch.engine import ops
    from repro_torch.kernels import ops as KO
    kw.setdefault("mode", "tg_linear")
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    sync()
    KO.reset_launch_counts()
    t0 = time.perf_counter()
    st = materialize(kb, tg_eg=eg, **kw)
    sync()
    wall = time.perf_counter() - t0
    return counters_of(st), wall, KO.launch_counts()


def tg_linear_phase(facts):
    """Phase 10: ``min_linear(tglinear(LUBM_LI))`` on the host (the paper's
    "Comp" column), then ``materialize(mode="tg_linear")`` of phase 3's
    facts under LUBM-LI with and without cleaning, on the card and on the
    CPU (counters, rows and dictionaries equal), against the card's
    ``tg`` and ``seminaive`` runs (the same facts), warm timed runs of
    the four settings in turns and one profiled run.  Every KB after the first is a copy
    of the first one's base state (``from_host_state``), so all share one
    dictionary.  Returns the record and the launches of the compared card
    runs per setting."""
    from repro_torch import EngineKB, materialize
    from repro_torch.core.tg_linear import min_linear, tglinear
    from repro_torch.data.kb_sources import LUBM_LI
    t0 = time.perf_counter()
    eg = min_linear(tglinear(LUBM_LI))
    comp = time.perf_counter() - t0
    log(f"[tg_linear] EG {eg.stats()}, comp {comp:.6f} s")
    kb0 = EngineKB(LUBM_LI, facts, device="cuda")
    state = kb0.host_state()

    def fresh(device):
        return EngineKB.from_host_state(LUBM_LI, *state, device=device)

    rec = {"eg": eg.stats(), "comp_s": comp, "base_facts": len(facts),
           "runs": {}}
    launches, results = {}, {}
    for cleaning in (True, False):
        tag = f"{'w' if cleaning else 'wo'}-cleaning"
        kb_g = kb0 if cleaning else fresh("cuda")
        cnt_g, wall_g, lc = timed_materialize(kb_g, eg, cleaning=cleaning)
        kb_c = fresh("cpu")
        cnt_c, wall_c, _ = timed_materialize(kb_c, eg, cleaning=cleaning)
        if cnt_g != cnt_c:
            fail(f"tg_linear {tag}: card {cnt_g} vs cpu {cnt_c}")
        if not same_rows(rows_by_pred(kb_g), rows_by_pred(kb_c)) or \
                not same_dictionary(kb_g, kb_c):
            fail(f"tg_linear {tag}: facts differ between card and cpu")
        if cnt_g[0][3] != f"tg_linear[{tag}]":
            fail(f"tg_linear {tag}: mode {cnt_g[0][3]}")
        launches[tag] = lc
        results[tag] = (distinct_rows(kb_g), kb_g)
        (rounds, trg, derived, mode, _), sorts, pulls = cnt_g
        rec["runs"][tag] = {
            "rounds": rounds, "triggers": trg, "derived": derived,
            "mode": mode, "sort_stats": sorts, "count_pulls": pulls,
            "launches": lc, "first_ms": wall_g * 1e3,
            "cpu_ms": wall_c * 1e3}
        log(f"[tg_linear] {tag}: {json.dumps(rec['runs'][tag])}")
        del kb_c
    del kb0
    rows_w, kb_w = results["w-cleaning"]
    rec["facts"] = sum(len(r) for r in rows_w.values())
    if not same_rows(rows_w, results["wo-cleaning"][0]):
        fail("tg_linear: w-cleaning and wo-cleaning facts differ")
    for mode in ("tg", "seminaive"):
        kb = fresh("cuda")
        (stats, sorts, pulls), wall, _ = timed_materialize(kb, None, mode=mode)
        if not same_rows(rows_w, distinct_rows(kb)) or \
                not same_dictionary(kb, kb_w):
            fail(f"tg_linear facts differ from the card's {mode} run")
        rec[mode] = {"rounds": stats[0], "triggers": stats[1],
                     "derived": stats[2], "count_pulls": pulls,
                     "first_ms": wall * 1e3}
        del kb
    del results, rows_w, kb_w
    # Warm runs: every setting has run once above; each is timed
    # TG_LINEAR_WARM times on a fresh KB, in turns, so host drift falls on
    # all four alike.
    warm = [(eg, {"cleaning": True}, rec["runs"]["w-cleaning"]),
            (eg, {"cleaning": False}, rec["runs"]["wo-cleaning"]),
            (None, {"mode": "tg"}, rec["tg"]),
            (None, {"mode": "seminaive"}, rec["seminaive"])]
    for _ in range(TG_LINEAR_WARM):
        for g, kw, out in warm:
            _, wall, _ = timed_materialize(fresh("cuda"), g, **kw)
            out.setdefault("warm_ms_runs", []).append(wall * 1e3)
    for _, _, out in warm:
        out["warm_ms"] = float(np.median(out["warm_ms_runs"]))
    kb = fresh("cuda")
    rec["profiled_w-cleaning"] = profile_run(
        "lubm_li tg_linear w-cleaning",
        lambda: materialize(kb, mode="tg_linear", tg_eg=eg))
    del kb
    missing = [k for k in TG_LINEAR_KERNELS
               if launches["w-cleaning"][k] == 0]
    if missing:
        fail(f"tg_linear: {missing} never launched: {launches}")
    rec["probe_launched"] = launches["w-cleaning"]["probe_sorted"] > 0
    return rec, launches


# ---------------------------------------------------------------------------
# phase 11: the sharded executor
# ---------------------------------------------------------------------------
DIST_NDEVS = (1, 2, 4, 8)
DIST_WARM = 5        # benchmarks/bench_dist.py's steady(): warm-up runs
DIST_TIMED = 3       # warm timed runs of each full-width setting


def dist_workloads():
    """``benchmarks/bench_dist.py``'s full-size scenarios: name, program,
    base facts."""
    from repro_torch.data.kb_sources import (LUBM_L, TC, lubm_facts,
                                             tc_chain_facts, tc_random_facts)
    return [("tc_chain", TC, tc_chain_facts(128)),
            ("tc_rand", TC, tc_random_facts(500, 1500)),
            ("LUBM-L", LUBM_L, lubm_facts(n_univ=2, scale=2))]


def bench_dist_rows() -> dict:
    """``BENCH_dist.json``'s sharded rows (the reference's warm runs on 1,
    2, 4 and 8 virtual devices) by (workload, ndev)."""
    with open(os.path.join(HERE, "BENCH_dist.json")) as f:
        results = json.load(f)["results"]
    return {(r["name"].split(".")[1], r["ndev"]): r for r in results
            if "ndev" in r}


def dist_run(make_kb, device, ndev):
    """One sharded materialization of a fresh KB (``materialize(kb,
    backend="dist")`` at the default shard count, else
    ``materialize_distributed``), counters reset before the KB is built
    (as ``benchmarks/bench_dist.py`` counts): the KB, its record and the
    wall s of the materialization."""
    from repro_torch import materialize
    from repro_torch.engine import distributed, ops
    ops.SORT_STATS.reset()
    ops.HOST_SYNC_STATS.reset()
    kb = make_kb(device)
    sync()
    t0 = time.perf_counter()
    if ndev == distributed.default_ndev(kb.device):
        st = materialize(kb, mode="tg", backend="dist")
    else:
        st = distributed.materialize_distributed(kb, mode="tg", ndev=ndev)
    sync()
    wall = time.perf_counter() - t0
    h = ops.HOST_SYNC_STATS
    rec = {"facts": kb.num_facts(), "rounds": st.rounds,
           "triggers": st.triggers, "derived": st.derived,
           "extra": dict(st.extra), "sort_stats": dict(vars(ops.SORT_STATS)),
           "count_pulls": h.count_pulls, "dist_pulls": h.dist_pulls,
           "dist_retries": h.dist_retries,
           "dist_fixpoint_pulls": h.dist_fixpoint_pulls,
           "dist_fixpoint_iters": h.dist_fixpoint_iters}
    return kb, rec, wall


def dist_steady(make_kb, ndev):
    """``bench_dist.steady`` on the card: warm until no planned capacity
    moved on the last run (at most ``DIST_WARM`` runs), then one more run.
    Returns that run's (kb, record, wall s) and the runs it took."""
    from repro_torch.engine import plan
    prev, runs = None, 0
    for _ in range(DIST_WARM):
        dist_run(make_kb, "cuda", ndev)
        runs += 1
        snap = sorted((str(k), v) for k, v in plan._CAP_MEMO.items())
        if snap == prev:
            break
        prev = snap
    return (*dist_run(make_kb, "cuda", ndev), runs)


def dist_phase(lubm_facts_full, lubm_rows, lubm_stats):
    """Phase 11: the sharded executor on the card.  ``BENCH_dist.json``'s
    three workloads at 1, 2, 4 and 8 shards, warm, each held to its row
    (facts, rounds, triggers, derived, and warm pulls 3, retries 0, one
    fixpoint exit and the row's fixpoint iterations); at 4 shards each
    also runs on the CPU from the same capacity memo and must give the
    card's rows and counters.  Then LUBM-L ``n_univ=2000`` (phase 3's
    facts) at 1 and 4 shards, warm: the card's two-phase rows, rounds,
    triggers and derived, with the warm wall (median of
    ``DIST_TIMED``), a profiled run's device busy time, peak memory,
    pulls and retries.  Returns the record and the launches of the card's
    runs (the four kernels and the device loop)."""
    from repro_torch import EngineKB
    from repro_torch.data.kb_sources import LUBM_L
    from repro_torch.engine import distributed, fused, plan
    from repro_torch.kernels import graph_loop as GL
    from repro_torch.kernels import ops as KO
    want = bench_dist_rows()
    plan.clear_programs()
    plan._CAP_MEMO.clear()
    fused.CAPTURES.update(dist_round=0, dist_prologue=0, dist_fixpoint=0)
    KO.reset_launch_counts()
    GL.LAUNCHES["graph_loop"] = 0
    rec = {"bench_dist": [], "full_width": []}
    for name, prog, facts in dist_workloads():
        def make_kb(device, prog=prog, facts=facts):
            return EngineKB(prog, facts, device=device)
        for ndev in DIST_NDEVS:
            kb, got, wall, runs = dist_steady(make_kb, ndev)
            row = want[(name, ndev)]
            expect = {k: row[k] for k in ("facts", "rounds", "triggers",
                                          "derived", "dist_pulls",
                                          "dist_retries",
                                          "dist_fixpoint_pulls",
                                          "dist_fixpoint_iters")}
            if {k: got[k] for k in expect} != expect or \
                    got["extra"] != {"dist": True, "ndev": ndev}:
                fail(f"dist {name} ndev={ndev}: {got}, BENCH_dist.json "
                     f"{expect}")
            entry = {"workload": name, "ndev": ndev, "warm_ms": wall * 1e3,
                     "warm_up_runs": runs, **got}
            if ndev == 4:
                kb_c, got_c, wall_c = dist_run(make_kb, "cpu", ndev)
                if got_c != got:
                    fail(f"dist {name} ndev=4: card {got} vs cpu {got_c}")
                if not same_rows(rows_by_pred(kb), rows_by_pred(kb_c)):
                    fail(f"dist {name} ndev=4: rows differ between card and "
                         "cpu")
                entry["cpu_ms"] = wall_c * 1e3
                del kb_c
            rec["bench_dist"].append(entry)
            log(f"[dist] {json.dumps(entry)}")
            del kb
        plan.clear_programs()
        torch.cuda.empty_cache()
    kb0 = EngineKB(LUBM_L, lubm_facts_full, device="cuda")
    state = kb0.host_state()
    del kb0

    def fresh(device):
        return EngineKB.from_host_state(LUBM_L, *state, device=device)

    for ndev in (1, 4):
        kb, got, wall, runs = dist_steady(fresh, ndev)
        if [got[k] for k in ("rounds", "triggers", "derived")] != \
                list(lubm_stats) or got["extra"] != {"dist": True,
                                                     "ndev": ndev}:
            fail(f"dist lubm_l n_univ={LUBM_UNIV} ndev={ndev}: {got} vs "
                 f"two-phase {lubm_stats}")
        if not same_rows(rows_by_pred(kb), lubm_rows):
            fail(f"dist lubm_l ndev={ndev}: rows differ from the card's "
                 "two-phase run")
        del kb
        walls = [wall]
        for _ in range(DIST_TIMED - 1):
            walls.append(dist_run(fresh, "cuda", ndev)[2])
        kb = fresh("cuda")
        sync()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_run(
            f"lubm_l dist ndev={ndev}",
            lambda: distributed.materialize_distributed(kb, ndev=ndev))
        entry = {"workload": f"lubm_l n_univ={LUBM_UNIV}", "ndev": ndev,
                 "warm_ms": statistics.median(walls) * 1e3,
                 "warm_ms_runs": [w * 1e3 for w in walls],
                 "warm_up_runs": runs, "profiled": prof,
                 "peak_bytes": torch.cuda.max_memory_allocated(), **got}
        rec["full_width"].append(entry)
        log(f"[dist] {json.dumps(entry)}")
        del kb
        plan.clear_programs()
        torch.cuda.empty_cache()
    launches = KO.launch_counts()
    launches["graph_loop"] = GL.LAUNCHES["graph_loop"]
    rec["captures"] = {k: v for k, v in fused.CAPTURES.items()
                       if k.startswith("dist_")}
    rec["launches"] = launches
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"dist: {missing} never launched on the sharded path: "
             f"{launches}")
    if not rec["captures"]["dist_round"] or \
            not rec["captures"]["dist_fixpoint"]:
        fail(f"dist: no captured round or fixpoint program: "
             f"{rec['captures']}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 12: serving dense LMs over tokens of a KB the port materialized
# ---------------------------------------------------------------------------
KB_LM = {"batch": 8, "seq": 256, "gen": 32}     # examples/kb_to_lm.py's
FULL = {"batch": 8, "prompt": 2048, "gen": 64}  # stablelm_12b, full width
FULL_CPU = {"batch": 2, "prompt": 1040, "gen": 4}   # 2 layers, card vs CPU
F32_TOL = 1e-3    # card against CPU, float32: |a - b| <= tol * (1 + |b|)
F32_RMS = 1e-4    # decode against re-prefill, float32: rms(a - b) <= tol *
                  # rms(b), for the logits and the K/V row decode wrote
BF16_REL = 0.1    # the same, bfloat16 through 40 random layers; set
                  # between a sound step (logits 0.054, K/V row 0.036) and
                  # the planted fault (logits 0.18) on the H100


def lm_100m(vocab: int):
    """``examples/kb_to_lm.py``'s ``lm_100m`` (its line 24), copied."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name="kb-lm-100m", family="dense", num_layers=8, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2304,
        vocab_size=vocab, mlp_type="swiglu", norm_type="rmsnorm",
        attn_chunk=128, loss_chunk=128, remat="none")


def serve_run(mdl, tokens, gen, feed=None, keep=()):
    """Prefill ``tokens`` (B, S), pad the caches to S + ``gen`` positions
    and decode ``gen`` tokens: greedily, or fed the tokens of ``feed``.  The
    host clock times the prefill and each decode step, each ending in a
    synchronize (the reference's serve loop reads every token back).
    Returns the tokens chosen (B, gen + 1) and their top-2 margins, the
    logits of the positions in ``keep`` (0: the prefill's, t + 1: decode
    step t's; float32 on the CPU), whether every logit was finite, and the
    seconds of the prefill and of each decode step, and the caches."""
    from repro_torch.models.model import pad_caches
    card = mdl.device.type == "cuda"

    def clock():
        if card:
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = clock()
    logits, caches = mdl.prefill({"tokens": tokens.to(mdl.device)})
    t_prefill = clock() - t0
    S = tokens.shape[1]
    caches = pad_caches(caches, S + gen)
    toks, margins, kept, finite, steps = [], [], {}, True, []
    for t in range(gen + 1):
        top2 = logits.topk(2, dim=-1).values
        toks.append(logits.argmax(-1).cpu())
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        finite = finite and bool(torch.isfinite(logits).all())
        if t in keep:
            kept[t] = logits.float().cpu()
        if t == gen:
            break
        tok = toks[-1] if feed is None else feed[:, t]
        t0 = clock()
        logits, caches = mdl.decode(caches, tok.to(mdl.device), S + t)
        steps.append(clock() - t0)
    return {"tokens": torch.stack(toks, 1),
            "margins": torch.stack(margins, 1), "logits": kept,
            "finite": finite, "prefill_s": t_prefill, "step_s": steps,
            "caches": caches}


def logits_agree(got, want, tol) -> dict:
    """Max |got - want| and whether every logit has ``|got - want| <=
    tol * (1 + |want|)``."""
    diff = (got - want).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tol": bool((diff <= tol * (1 + want.abs())).all())}


def compare_runs(card, cpu, tol, skip_rows=()) -> dict:
    """The CPU run (fed the card's tokens) against the card's: tokens equal
    wherever the CPU's top-2 margin exceeds ``tol``, and the kept logits
    within ``tol``, in every batch row but ``skip_rows``."""
    rows = torch.ones(cpu["tokens"].shape[0], dtype=torch.bool)
    rows[list(skip_rows)] = False
    sure = (cpu["margins"] > tol) & rows[:, None]
    bad = int((card["tokens"][sure] != cpu["tokens"][sure]).sum())
    agree = [logits_agree(card["logits"][t][rows], cpu["logits"][t][rows],
                          tol) for t in cpu["logits"]]
    return {"tokens_compared": int(sure.sum()),
            "near_ties": int((~sure).sum()), "token_mismatches": bad,
            "max_abs_err_logits": max(a["max_abs_err"] for a in agree),
            "tol": tol, "rows_compared": int(rows.sum()),
            "ok": bad == 0 and all(a["within_tol"] for a in agree)
            and card["finite"] and cpu["finite"]}


def timing(run, batch) -> dict:
    steps = [s * 1e3 for s in run["step_s"]]
    return {"prefill_ms": run["prefill_s"] * 1e3,
            "decode_ms_per_token": statistics.median(steps),
            "decode_tokens_per_s": batch * len(steps) / sum(run["step_s"])}


def rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def held_layers(cfg) -> slice:
    """The layers whose cache row a decode step must write as a re-prefill
    does.  In a MoE model whose experts can overflow, only those up to the
    first MoE layer: decode routes B tokens at a capacity of its own (C = 1
    for B = 8 at top-8 of 128 or 256 experts), a re-prefill B (S + 1)
    tokens at another, so the two drop different assignments, and every
    later layer's input differs (the reference's semantics, ROADMAP Queue
    3).  At capacity factor E / k or more, C >= T and nothing drops."""
    if cfg.family == "moe" and \
            cfg.capacity_factor * cfg.top_k < cfg.num_experts:
        return slice(0, cfg.num_dense_layers + 1)
    return slice(None)


def rows_at(caches, S) -> dict:
    """Every cache's rows at position ``S`` (L, B, ...), a float32 copy."""
    return {n: c[:, :, S].to(torch.float32, copy=True)
            for n, c in caches.items()}


def reprefill_outputs(mdl, tokens, run) -> dict:
    """The first decode step (``run`` kept the logits of positions 0 and 1
    and its padded caches) beside a prefill of the prompt and the token it
    was fed (``again``) and a planted fault (``fault``): the same step on
    the prompt-length caches, which writes no row and so leaves the token
    out of its own attention (the reference's contract, ROADMAP Queue 3);
    the row it leaves at S is the padding's zeros.  For each: the logits
    (B, V) and the cache rows at S (``rows_at``), float32."""
    from repro_torch.models.model import pad_caches
    V, S = mdl.cfg.vocab_size, tokens.shape[1]
    fed = run["tokens"][:, 0].to(tokens.device)
    again, caches = mdl.prefill({"tokens": torch.cat([tokens, fed[:, None]],
                                                     1)})
    again_rows = rows_at(caches, S)
    del caches
    caches = run["caches"]
    fault, fault_caches = mdl.decode({n: c[:, :, :S] for n, c in
                                      caches.items()}, fed, S)
    fault_rows = rows_at(pad_caches(fault_caches, S + 1), S)
    del fault_caches
    return {"step": (run["logits"][1][:, :V], rows_at(caches, S)),
            "again": (again.float().cpu()[:, :V], again_rows),
            "fault": (fault.float().cpu()[:, :V], fault_rows)}


def against_reprefill(out, name, held):
    """rms(a - b) / rms(b) of ``out[name]``'s logits and of its cache rows
    picked by ``held`` (L, B), over all of them and in the worst layer,
    against the re-prefill's (``out["again"]``)."""
    (ref, ref_rows), (got, got_rows) = out["again"], out[name]

    def rel(a, b):
        return rms(a - b) / rms(b)
    layers = [i for i in range(len(held)) if held[i].any()]
    return (rel(got, ref),
            max(rel(got_rows[n][held], r[held]) for n, r in ref_rows.items()),
            max(rel(got_rows[n][i][held[i]], r[i][held[i]])
                for n, r in ref_rows.items() for i in layers))


def held_against(out, held) -> dict:
    """``reprefill_outputs``' step and fault against the re-prefill, on the
    cache rows at S picked by ``held`` (L, B) and every row's logits: max
    |a - b| and rms(a - b) / rms(b) of the logits, with tokens equal
    wherever the re-prefill's top-2 margin exceeds twice that max, and
    rms(a - b) / rms(b) of the held cache rows, over all of them
    (``kv_rms_rel_err``) and in the worst layer."""
    ref, got = out["again"][0], out["step"][0]
    rel, kv, kv_worst = against_reprefill(out, "step", held)
    fault_rel, fault_kv, _ = against_reprefill(out, "fault", held)
    top2 = ref.topk(2, dim=-1).values
    err = float((got - ref).abs().max())
    sure = (top2[:, 0] - top2[:, 1]) > 2 * err
    return {"max_abs_err": err,
            "within_tol": logits_agree(got, ref, F32_TOL)["within_tol"],
            "rms_rel_err": rel, "kv_rms_rel_err": kv,
            "kv_worst_layer_rms_rel_err": kv_worst,
            "kv_rows_held": int(held.sum()), "fault_rms_rel_err": fault_rel,
            "fault_kv_rms_rel_err": fault_kv,
            "tokens_compared": int(sure.sum()),
            "token_mismatches": int((got.argmax(-1)[sure]
                                     != ref.argmax(-1)[sure]).sum())}


def decode_vs_reprefill(mdl, tokens, run) -> dict:
    """The first decode step against a re-prefill (``held_against``), on
    every cache row of the ``held_layers``."""
    out = reprefill_outputs(mdl, tokens, run)
    held = torch.zeros(mdl.cfg.num_layers, tokens.shape[0], dtype=torch.bool)
    held[held_layers(mdl.cfg)] = True
    return held_against(out, held.to(tokens.device))


class RoutingLog:
    """Records each MoE routing call's top experts and probabilities (on
    the device that ran it) while it is entered.  With ``alter``, a
    planted fault, each call's (top_p, top_e) is first replaced by
    ``alter(top_p, top_e, E)``."""

    def __init__(self, alter=None):
        self.alter = alter

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.route, self.calls = moe, moe.route, []

        def wrapped(router, xt, cfg):
            out = self.route(router, xt, cfg)
            if self.alter:
                out = (*self.alter(out[0], out[1], cfg.num_experts),
                       *out[2:])
            self.calls.append((out[1].clone(), out[2].clone()))
            return out
        moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.route = self.route


# faults planted in a decode step's MoE layers
MOE_FAULTS = {
    # routing: each assignment sent to the next expert over
    "misrouted": lambda p, e, E: (p, (e + 1) % E),
    # combine: every expert's output weighed by 1, not its probability
    "unweighted": lambda p, e, E: (torch.ones_like(p), e)}


def moe_layers(cfg) -> int:
    return cfg.num_layers - cfg.num_dense_layers if cfg.family == "moe" \
        else 0


def routing_differences(card_calls, cpu_calls, batch, expected) -> dict:
    """The card's routing against the CPU's, call by call (``expected``
    calls on each, or it fails: a log that missed the calls compares
    nothing): the assignments
    whose expert differs, and the batch rows they fall in.  Each token
    with a difference must be a near-tie on the CPU's own probabilities:
    at the first rank j where its experts differ, the j-th and (j+1)-th
    largest probabilities within ``NEAR_TIE`` of each other, relative (at
    j = k - 1, the k-th and (k+1)-th); and up to the first call with a
    difference, the two devices' probabilities must agree within
    ``NEAR_TIE`` (``all_near_ties``).  ``flips`` lists [call, token,
    rank, relative gap] of the first 16 differences."""
    if not len(card_calls) == len(cpu_calls) == expected:
        fail(f"{len(card_calls)} routing calls on the card, "
             f"{len(cpu_calls)} on the CPU, {expected} expected")
    assignments, rows, ties, flips, noise = 0, set(), True, [], 0.0
    for i, ((e_g, p_g), (e_c, p_c)) in enumerate(zip(card_calls,
                                                     cpu_calls)):
        if not flips:
            # the devices' disagreement before any routing differs: the
            # largest |card - CPU| of a probability, relative to its
            # token's largest
            noise = max(noise, float(((p_g.cpu() - p_c).abs().amax(-1)
                                      / p_c.amax(-1)).max()))
        bad = e_g.cpu() != e_c
        assignments += int(bad.sum())
        per_row = len(e_c) // batch
        for t in bad.any(1).nonzero().flatten().tolist():
            j = int(bad[t].nonzero()[0])
            ps = p_c[t].double().sort(descending=True).values
            gap = float((ps[j] - ps[j + 1]) / ps[j])
            ties = ties and gap <= NEAR_TIE
            flips.append([i, t, j, gap])
            rows.add(t // per_row)
    return {"calls": len(cpu_calls), "differing_assignments": assignments,
            "differing_tokens": len(flips), "rows": sorted(rows),
            "flips": flips[:16], "prob_rel_diff": noise,
            "all_near_ties": ties and noise <= NEAR_TIE}


def card_against_cpu(cfg, tokens, gen):
    """``cfg`` (float32) with weights drawn on the card from seed 0, served
    there (TF32 off) and its first decode step held against a re-prefill
    (to ``F32_RMS`` on the rows of the ``held_layers``, and the planted
    fault must read above it; the logits too, to ``F32_TOL`` and
    ``F32_RMS``, where every layer is held), then moved to the CPU and
    served again, fed the card's tokens.  The routing of a MoE model is
    held call by call (``routing_differences``), and the rows where it
    differs are left out of the comparison.  Returns the comparison."""
    from repro_torch.models.model import build
    mdl = build(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
    with RoutingLog() as routed_card:
        card = serve_run(mdl, tokens, gen, keep=(0, 1, gen))
    again = decode_vs_reprefill(mdl, tokens, card)
    card.pop("caches")
    mdl.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with RoutingLog() as routed_cpu:
        cpu = serve_run(mdl, tokens.cpu(), gen, feed=card["tokens"][:, :-1],
                        keep=(0, 1, gen))
    routing = routing_differences(routed_card.calls, routed_cpu.calls,
                                  tokens.shape[0],
                                  moe_layers(cfg) * (1 + gen))
    rec = compare_runs(card, cpu, F32_TOL, routing["rows"])
    rec["ok"] = rec["ok"] and routing["all_near_ties"] \
        and again["kv_rms_rel_err"] <= F32_RMS \
        and again["fault_kv_rms_rel_err"] > F32_RMS
    if held_layers(cfg) == slice(None):
        rec["ok"] = rec["ok"] and again["within_tol"] \
            and not again["token_mismatches"] \
            and again["rms_rel_err"] <= F32_RMS \
            and again["fault_rms_rel_err"] > F32_RMS
    return {**rec, "routing": routing,
            "decode_vs_reprefill": {**again, "tol_rms_rel": F32_RMS},
            "card": timing(card, tokens.shape[0]),
            "cpu_s": time.perf_counter() - t0}


def kb_tokens(facts, lubm_nfacts, lubm_stats):
    """LUBM-L materialized on the card with ``tg`` (held to phase 3's facts
    and counts) and linearized by the port's ``KBLinearizer(kb, 8, 256)``:
    its first batch of tokens on the card, the linearizer, and the
    materialization's and linearization's seconds."""
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import LUBM_L
    from repro_torch.data.pipeline import KBLinearizer
    t0 = time.perf_counter()
    kb = EngineKB(LUBM_L, facts)
    st = materialize(kb, mode="tg")
    sync()
    t_mat = time.perf_counter() - t0
    if (kb.num_facts(), [st.rounds, st.triggers, st.derived]) != \
            (lubm_nfacts, list(lubm_stats)):
        fail(f"serve: the KB has {kb.num_facts()} facts, {st}; phase 3 had "
             f"{lubm_nfacts}, {lubm_stats}")
    t0 = time.perf_counter()
    data = KBLinearizer(kb, batch=KB_LM["batch"], seq=KB_LM["seq"])
    t_lin = time.perf_counter() - t0
    del kb
    tokens = torch.from_numpy(data.next()["tokens"]).cuda()
    return tokens, data, {"facts": lubm_nfacts, "materialize_s": t_mat,
                          "linearize_s": t_lin,
                          "stream_tokens": len(data.stream)}


CONFIG_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
               "head_dim", "d_ff", "vocab_size", "attn_chunk", "dtype",
               "attn_type", "q_lora_rank", "kv_lora_rank", "qk_nope_dim",
               "qk_rope_dim", "v_head_dim", "num_dense_layers", "dense_d_ff",
               "num_experts", "top_k", "num_shared_experts", "moe_d_ff")


def kb_lm_path(name, make_cfg, facts, lubm_nfacts, lubm_stats):
    """The KB -> LM path, its kernel launches counted from 0: the KB's
    tokens (``kb_tokens``) served by ``make_cfg(vocabulary)``, prefill and
    ``KB_LM``'s greedy tokens on padded caches, in float32 on the card
    against the CPU (``card_against_cpu``), then in bfloat16 on the card,
    timed after a warm-up.  Returns the record, the launches and the
    tokens."""
    from repro_torch.kernels import ops as KO
    from repro_torch.models.model import build
    KO.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tokens, data, kb_rec = kb_tokens(facts, lubm_nfacts, lubm_stats)
    cfg = make_cfg(data.vocab_size)
    f32 = card_against_cpu(cfg.with_(dtype="float32"), tokens,
                           KB_LM["gen"])
    mdl = build(cfg.with_(dtype="bfloat16"), "cuda",
                torch.Generator(device="cuda").manual_seed(0))
    serve_run(mdl, tokens, 2)                          # warm-up
    bf16 = serve_run(mdl, tokens, KB_LM["gen"])
    launches = KO.launch_counts()
    rec = {"config": {k: getattr(cfg, k) for k in CONFIG_KEYS},
           "params": sum(p.numel() for p in mdl.parameters()),
           **kb_rec, **KB_LM, "float32_card_vs_cpu": f32,
           "bfloat16": {**timing(bf16, KB_LM["batch"]),
                        "finite": bf16["finite"]},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    del mdl, data
    torch.cuda.empty_cache()
    log(f"[serve] {name} {json.dumps(rec)}")
    if not f32["ok"] or not bf16["finite"]:
        fail(f"serve {name}: {rec}")
    return rec, launches, tokens


def full_width(name, cfg, shape, dropless=None):
    """``cfg`` in bfloat16 on the card, random weights from seed 0: a cold
    prefill of ``shape``'s batch x prompt, then a warm one and ``gen``
    greedy tokens on padded caches, timed; the first decode step against
    a re-prefill (``decode_vs_reprefill``); one more decode step
    profiled; with ``dropless``, a MoE model's decode against a
    re-prefill where no expert overflows (``dropless_vs_reprefill``); the
    peak memory.  Returns the record."""
    from repro_torch.models.model import build
    B, S, gen = shape["batch"], shape["prompt"], shape["gen"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mdl = build(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
    sync()
    t_build = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(1))
    t0 = time.perf_counter()
    mdl.prefill({"tokens": tokens})
    sync()
    t_cold = time.perf_counter() - t0
    run = serve_run(mdl, tokens, gen, keep=(0, 1))
    again = decode_vs_reprefill(mdl, tokens, run)
    last = run["tokens"][:, -1].cuda()
    prof = profile_run(f"{name} decode step", lambda: mdl.decode(
        run.pop("caches"), last, S + gen - 1))
    extra = {}
    if dropless:
        extra["dropless_vs_reprefill"] = dropless_vs_reprefill(mdl, dropless)
    rec = {"config": {k: getattr(cfg, k) for k in CONFIG_KEYS},
           "params": sum(p.numel() for p in mdl.parameters()), **shape,
           "build_s": t_build, "prefill_cold_ms": t_cold * 1e3,
           **timing(run, B), "finite": run["finite"],
           "decode_step_profile": prof,
           "decode_vs_reprefill": {**again, "tol_rms_rel": BF16_REL},
           **extra, "peak_bytes": torch.cuda.max_memory_allocated()}
    del mdl, run, tokens
    torch.cuda.empty_cache()
    log(f"[serve] {name} {json.dumps(rec)}")
    return rec


def dropless_vs_reprefill(mdl, shape) -> dict:
    """Decode against a re-prefill where nothing drops: the MoE model
    ``mdl`` run at capacity factor E / k, so C = T in the decode step and
    in the re-prefill alike, over ``shape``'s batch x prompt (random
    tokens from seed 3).  Every layer's cache row at S and the logits are
    held (``held_against``).  Besides the planted fault of
    ``reprefill_outputs``, the ``MOE_FAULTS``: the same step with its MoE
    layers' routing or combine broken.  Each MoE layer's routing of the
    fed token is logged in the step and the re-prefill, and the tokens
    that the two send to another set of experts (bfloat16 near-ties
    between two paths of different shapes) are counted."""
    cfg = mdl.cfg
    B, S, L, V = shape["batch"], shape["prompt"], cfg.num_layers, \
        cfg.vocab_size
    n_moe, dev = moe_layers(cfg), mdl.device
    tokens = torch.randint(0, V, (B, S), device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
    mdl.cfg = cfg.with_(capacity_factor=cfg.num_experts / cfg.top_k)
    faults = {}
    try:
        with RoutingLog() as step:      # the prefill, then the decode step
            run = serve_run(mdl, tokens, 1, keep=(0, 1))
        with RoutingLog() as again:     # the re-prefill, then the fault
            out = reprefill_outputs(mdl, tokens, run)
        fed = run["tokens"][:, 0].to(dev)
        for name, alter in MOE_FAULTS.items():
            with RoutingLog(alter) as bad:
                logits, caches = mdl.decode(run["caches"], fed, S)
            faults[name] = len(bad.calls)
            out[name] = (logits.float().cpu()[:, :V], rows_at(caches, S))
    finally:
        mdl.cfg = cfg
    del run, caches
    if not len(step.calls) == len(again.calls) == 2 * n_moe or \
            set(faults.values()) != {n_moe}:
        fail(f"dropless: {len(step.calls)}, {len(again.calls)} and "
             f"{faults} routing calls; {2 * n_moe} and {n_moe} expected")
    rerouted = 0
    for m in range(n_moe):
        e_step = step.calls[n_moe + m][0].sort(-1).values
        e_again = again.calls[m][0].view(B, S + 1, -1)[:, S]
        rerouted += int((e_step != e_again.sort(-1).values).any(-1).sum())
    held = torch.ones(L, B, dtype=torch.bool, device=dev)
    rec = held_against(out, held)
    for name in MOE_FAULTS:
        rel, _, worst = against_reprefill(out, name, held)
        rec[f"{name}_rms_rel_err"] = rel
        rec[f"{name}_kv_worst_layer_rms_rel_err"] = worst
    return {**shape, "capacity_factor": cfg.num_experts / cfg.top_k,
            "rerouted_tokens": rerouted, "routings": n_moe * B, **rec,
            "tol_rms_rel": BF16_REL}


def two_layers_against_cpu(name, cfg):
    """A 2-layer float32 copy of ``cfg`` at full width, card against CPU
    (``card_against_cpu``) over ``FULL_CPU``'s batch x prompt."""
    tokens = torch.randint(0, cfg.vocab_size, (FULL_CPU["batch"],
                                               FULL_CPU["prompt"]),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(2))
    two = card_against_cpu(cfg.with_(num_layers=2, dtype="float32"),
                           tokens, FULL_CPU["gen"])
    torch.cuda.empty_cache()
    log(f"[serve] {name} 2 layers {json.dumps(two)}")
    if not two["ok"]:
        fail(f"serve {name} 2 layers: card and CPU differ: {two}")
    return {**FULL_CPU, **two}


def serve_phase(facts, lubm_nfacts, lubm_stats):
    """Phase 12.  (a) LUBM-L ``n_univ=2000`` materialized on the card and
    linearized (``kb_tokens``), served by ``lm_100m`` at the linearizer's
    vocabulary: prefill and 32 greedy tokens on caches padded to 256 + 32,
    in float32 on the card against the CPU, then in bfloat16 on the card,
    timed after a warm-up.  (b) ``stablelm_12b``'s ``CONFIG`` at full
    width and depth in bfloat16 (``full_width``, 8 x 2048 + 64), its
    logits and cache rows within ``BF16_REL`` of a re-prefill and its
    planted fault above it.  Then a 2-layer copy at full width in float32
    on the card against the CPU.  Returns the ``serve`` record, the kernel
    launches of (a)'s path (the LM side has no kernel) and (a)'s tokens."""
    from repro_torch.configs.base import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (a) KB -> LM
    kb_lm, launches, tokens = kb_lm_path("kb_lm", lm_100m, facts,
                                         lubm_nfacts, lubm_stats)

    # (b) stablelm_12b at full width and depth
    cfg = get_config("stablelm_12b")
    full = full_width("stablelm_12b", cfg, FULL)
    again = full["decode_vs_reprefill"]
    if not (full["finite"] and again["rms_rel_err"] <= BF16_REL
            and again["kv_rms_rel_err"] <= BF16_REL
            and again["fault_rms_rel_err"] > BF16_REL):
        fail(f"serve stablelm_12b: {full}")
    full["two_layers_float32_card_vs_cpu"] = two_layers_against_cpu(
        "stablelm_12b", cfg)
    return {"kb_lm": kb_lm, "stablelm_12b": full}, launches, tokens


# ---------------------------------------------------------------------------
# phase 13: serving MoE and MLA LMs
# ---------------------------------------------------------------------------
FULL_MOE = {"batch": 8, "prompt": 2048, "gen": 32}  # qwen3 / deepseek
DROPLESS = {"batch": 8, "prompt": 128}  # at C = T: deepseek's one MoE layer
                                        # takes about 13 GB of transients
DEEPSEEK_LAYERS = 4   # 3 dense + 1 MoE: one MoE layer is 22.5 GB in
                      # bfloat16, the 58 of the full model 1.3 TB
NEAR_TIE = 2e-5       # card against CPU, float32: the routing
                      # probabilities agree within this, relative to each
                      # token's largest, and a token may reach another
                      # expert only where two adjacent probabilities are
                      # this close, relative.  The devices' float32
                      # probabilities differ by up to 5.6e-6 at qwen3's
                      # width (H100), and a flip at 1.9e-6 was seen, so
                      # 1e-6 could not tell a fault from rounding


def dropless_held(rec) -> bool:
    """``dropless_vs_reprefill``'s gate: the logits and every cache row,
    layer by layer, within ``BF16_REL`` of the re-prefill; the K/V fault's
    rows above it (its logits are printed, not held: with random weights
    attention is near uniform over the prompt, and leaving one token out
    moved qwen3's logits by only 0.025 on the H100, its sound step 0.017);
    each MoE fault above it, in the logits or the worst layer."""
    return rec["rms_rel_err"] <= BF16_REL \
        and rec["kv_worst_layer_rms_rel_err"] <= BF16_REL \
        and rec["fault_kv_rms_rel_err"] > BF16_REL \
        and all(max(rec[f"{n}_rms_rel_err"],
                    rec[f"{n}_kv_worst_layer_rms_rel_err"]) > BF16_REL
                for n in MOE_FAULTS)


def kb_moe_mla(vocab: int):
    """``deepseek_v3_671b``'s layer pattern (MLA attention, dense layers
    first, routed experts plus a shared one) at ``lm_100m``'s width and
    the linearizer's vocabulary."""
    return lm_100m(vocab).with_(
        name="kb-moe-mla", family="moe", num_layers=4, attn_type="mla",
        q_lora_rank=384, kv_lora_rank=128, qk_nope_dim=64, qk_rope_dim=32,
        v_head_dim=64, num_dense_layers=1, dense_d_ff=2304, num_experts=16,
        top_k=4, num_shared_experts=1, moe_d_ff=384)


def serve_moe_phase(facts, lubm_nfacts, lubm_stats, tokens_12):
    """Phase 13.  (a) Phase 12's KB tokens, made again (equal to phase
    12's), served by ``kb_moe_mla``: prefill and 32 greedy tokens on
    caches padded to 256 + 32, float32 on the card against the CPU
    (``card_against_cpu``: routing near-ties only, rows without a routing
    difference within ``F32_TOL``), then bfloat16 on the card, timed.
    (b) ``qwen3_moe_30b_a3b``'s ``CONFIG`` at full width and depth and
    (c) ``deepseek_v3_671b``'s at full width and ``DEEPSEEK_LAYERS``
    layers (no MTP head), both in bfloat16 (``full_width``, 8 x 2048 +
    32): finite logits, the cache rows of the ``held_layers`` within
    ``BF16_REL`` of a re-prefill and the planted fault above it; the
    logits against the re-prefill are printed, not held (capacity, see
    ``held_layers``); then the same model where no expert overflows,
    every layer and the logits held (``dropless_vs_reprefill``,
    ``dropless_held``).  Then qwen3's 2-layer float32 copy on the card
    against the CPU.  Returns the ``serve_moe`` record and the kernel
    launches of (a)'s path (the MoE and MLA layers have no kernel)."""
    from repro_torch.configs.base import get_config
    log(f"[serve_moe] allocated at start: {torch.cuda.memory_allocated()} "
        f"bytes")

    # (a) KB -> MoE / MLA LM
    kb_moe, launches, tokens = kb_lm_path("kb_moe_mla", kb_moe_mla, facts,
                                          lubm_nfacts, lubm_stats)
    if not torch.equal(tokens, tokens_12):
        fail("serve_moe: the KB's tokens differ from phase 12's")

    # (b) qwen3_moe_30b_a3b at full width and depth, (c) deepseek_v3_671b
    # at full width; decode against a re-prefill holds only the rows that
    # capacity does not touch (``held_layers``), and every row where
    # nothing overflows (``DROPLESS``)
    out = {"kb_moe_mla": kb_moe}
    for arch, layers in (("qwen3_moe_30b_a3b", None),
                         ("deepseek_v3_671b", DEEPSEEK_LAYERS)):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.with_(num_layers=layers)
        rec = full_width(arch, cfg, FULL_MOE, DROPLESS)
        again, dropless = rec["decode_vs_reprefill"], \
            rec["dropless_vs_reprefill"]
        if not (rec["finite"] and again["kv_rms_rel_err"] <= BF16_REL
                and again["fault_kv_rms_rel_err"] > BF16_REL
                and dropless_held(dropless)):
            fail(f"serve_moe {arch}: {rec}")
        out[arch] = rec
    out["qwen3_moe_30b_a3b"]["two_layers_float32_card_vs_cpu"] = \
        two_layers_against_cpu("qwen3_moe_30b_a3b",
                               get_config("qwen3_moe_30b_a3b"))
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import (LUBM_L, TC, lubm_facts,
                                             tc_wide_chunks, tc_wide_total)
    from repro_torch.kernels import bitonic_sort as BS
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import hash_probe as HP
    from repro_torch.kernels import ops as KO
    from repro_torch.kernels import unique_mask as UM
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s "
        f"(nvcc: {build.BUILD_SECONDS})")

    # 2. kernels against plain versions
    t0 = time.perf_counter()
    bad = check_kernels(BS, UM, HP, KO, ref, np.random.default_rng(0))
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s; "
        f"mismatches {bad or 0}")
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # 3. LUBM-L, card against CPU
    facts = lubm_facts(n_univ=LUBM_UNIV)
    log(f"[lubm] n_univ={LUBM_UNIV}: {len(facts)} base facts")
    with ShapeLog(BS, UM, HP) as shapes:
        KO.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        kb_g, st_g, wall_g, cnt_g = run_lubm("cuda", facts)
        launches_lubm = KO.launch_counts()
        lubm_mem = torch.cuda.max_memory_allocated()
        kb_c, st_c, wall_c, cnt_c = run_lubm("cpu", facts)
        log(f"[lubm] cuda: EngineKB {wall_g[0]:.2f} s + materialize "
            f"{wall_g[1]:.3f} s; cpu: EngineKB {wall_c[0]:.2f} s + "
            f"materialize {wall_c[1]:.3f} s; facts "
            f"{kb_g.num_facts()}, rounds {st_g.rounds}, triggers "
            f"{st_g.triggers}, derived {st_g.derived}, {cnt_g[0]}, "
            f"count_pulls {cnt_g[1]}; launches {launches_lubm}; peak "
            f"{lubm_mem} bytes")
        if (st_g.rounds, st_g.triggers, st_g.derived, cnt_g) != \
                (st_c.rounds, st_c.triggers, st_c.derived, cnt_c):
            fail(f"lubm stats differ: cuda {st_g} {cnt_g} vs cpu {st_c} "
                 f"{cnt_c}")
        lubm_rows, rc = rows_by_pred(kb_g), rows_by_pred(kb_c)
        if lubm_rows.keys() != rc.keys() or any(
                not np.array_equal(lubm_rows[p], rc[p]) for p in lubm_rows):
            fail("lubm fact rows differ between cuda and cpu")
        if any(launches_lubm[k] == 0 for k in KERNELS):
            fail(f"a kernel was never launched on LUBM-L: {launches_lubm}")
        lubm_kbs, lubm_stats = (kb_g, kb_c), [st_g.rounds, st_g.triggers,
                                              st_g.derived]
        lubm_nfacts = kb_g.num_facts()
        del rc

        # 4. tc_wide at scale, card against CPU
        KO.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        kb, st, (t_in, t_mat), cnt_g = run_tc_wide("cuda")
        launches_tc = KO.launch_counts()
        # the reference's count: without the ``e~aux`` twin that program
        # normalization adds for the mixed body ``T(X, Y) & e(Y, Z)``
        n_facts = sum(r.count for p, r in kb.rels.items() if "~" not in p)
        tc_mem = torch.cuda.max_memory_allocated()
        log(f"[tc_wide] chains={TC_CHAINS}: facts {n_facts} "
            f"(num_facts() {kb.num_facts()} with e~aux), rounds "
            f"{st.rounds}, triggers {st.triggers}, {cnt_g[0]}, count_pulls "
            f"{cnt_g[1]}; ingest {t_in:.2f} s, materialize {t_mat:.2f} s, "
            f"{n_facts / (t_in + t_mat):.0f} facts/s end to end; peak "
            f"{tc_mem} bytes; launches {launches_tc}")
        if n_facts != tc_wide_total(TC_CHAINS):
            fail(f"tc_wide has {n_facts} facts, expected "
                 f"{tc_wide_total(TC_CHAINS)}")
        kb_c, st_c, wall_c, cnt_c = run_tc_wide("cpu")
        log(f"[tc_wide] cpu: ingest {wall_c[0]:.2f} s + materialize "
            f"{wall_c[1]:.2f} s")
        if (st.rounds, st.triggers, st.derived, cnt_g) != \
                (st_c.rounds, st_c.triggers, st_c.derived, cnt_c):
            fail(f"tc_wide stats differ: cuda {st} {cnt_g} vs cpu {st_c} "
                 f"{cnt_c}")
        rg, rc = rows_by_pred(kb), rows_by_pred(kb_c)
        if rg.keys() != rc.keys() or any(
                not np.array_equal(rg[p], rc[p]) for p in rg):
            fail("tc_wide fact rows differ between cuda and cpu")
        tc_kbs = (kb, kb_c)
        del kb, kb_c, rg, rc

    # 5. times at the main path's largest shapes
    launches = {k: launches_lubm[k] + launches_tc[k] for k in KERNELS}
    rows = kernel_rows(shapes.largest, launches, BS, UM, HP, ref)
    for r in rows:
        r["launches_lubm"] = launches_lubm[r["name"]]
        r["launches_tc_wide"] = launches_tc[r["name"]]
    sort_2_22 = sort_breakdown(BS, KO, np.random.default_rng(1))
    grid = probe_grid(HP, ref, np.random.default_rng(3))
    if any(v["mismatches"] for v in grid.values()):
        fail(f"probe_sorted disagrees with its plain version: {grid}")

    # 6. where the time goes: warm re-runs of materialize under the profiler
    kb = EngineKB(LUBM_L, facts)
    prof = [profile_run("lubm_l materialize", lambda: materialize(kb))]
    kb = EngineKB.from_stream(TC, tc_wide_chunks(TC_CHAINS))
    prof.append(profile_run("tc_wide materialize", lambda: materialize(kb)))
    del kb

    # 7. deltas at full size: card against CPU and against from-scratch
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    deltas, launches_delta = run_deltas(
        "lubm_l", *lubm_kbs, lubm_delta_calls(facts, rng),
        lambda base: EngineKB(LUBM_L, base))
    tc_deltas, tc_launches = run_deltas(
        "tc_wide", *tc_kbs, tc_delta_calls(rng),
        lambda base: EngineKB.from_stream(TC, [("e", base)]))
    deltas += tc_deltas
    launches_delta = {k: launches_delta[k] + tc_launches[k]
                      for k in KERNELS}
    del lubm_kbs, tc_kbs
    log(f"[delta] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_delta}")
    if any(launches_delta[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched by the delta calls: "
             f"{launches_delta}")
    for r in rows:
        r["launches_delta"] = launches_delta[r["name"]]
        r["launches"] += launches_delta[r["name"]]

    # 8. crash recovery on the card, in child processes
    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                           dir=os.path.join(HERE, "build"))
    try:
        drills = recovery_drills(tmp, lubm_rows, lubm_stats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[recovery] {time.perf_counter() - t0:.1f} s")

    # 9. the fused executor at full size
    t0 = time.perf_counter()
    from repro_torch.core.terms import parse_program
    from repro_torch.engine import fused
    deep_prog, deep_facts = parse_program(DEEP_TC), deep_tc_facts()

    def deep_checks(cold, warm):
        for r in (cold, warm):
            if (r["rounds"], r["triggers"], r["derived"]) != DEEP_COUNTS:
                fail(f"deep chain: {r}, expected {DEEP_COUNTS}")
        if warm["fused_pulls"] != DEEP_PULLS:
            fail(f"deep chain: {warm['fused_pulls']} fused pulls warm, "
                 f"expected {DEEP_PULLS}")

    workloads = [
        ("lubm_l", lambda d: EngineKB(LUBM_L, facts, device=d), None),
        ("tc_wide", lambda d: EngineKB.from_stream(
            TC, tc_wide_chunks(TC_CHAINS), device=d), None),
        ("deep_chain", lambda d: EngineKB(deep_prog, deep_facts, device=d),
         deep_checks)]
    fused_recs, fused_kbs = [], {}
    launches_fused = {k: 0 for k in KERNELS}
    loops_fused = 0
    prev_flag = os.environ.get("REPRO_FUSED")
    try:
        for name, make_kb, checks in workloads:
            rec, lc, loops, kbs = fused_workload(
                name, make_kb, checks or (lambda cold, warm: None))
            fused_recs.append(rec)
            for k in KERNELS:
                launches_fused[k] += lc[k]
            loops_fused += loops
            if name == "deep_chain":
                # one more run, untimed, keeps each device loop's inputs
                with LoopRecorder() as recorder:
                    materialize(make_kb("cuda"), mode="tg")
                loop_row = graph_loop_row(recorder.calls, loops_fused)
                del recorder
            else:
                fused_kbs[name] = kbs
            fused.clear_programs()
            torch.cuda.empty_cache()
        fused_delta_recs, handed = fused_deltas(
            "lubm_l", fused_kbs.pop("lubm_l"),
            lubm_delta_calls(facts, np.random.default_rng(0))[:2])
        more, handed_tc = fused_deltas(
            "tc_wide", fused_kbs.pop("tc_wide"),
            tc_delta_calls(np.random.default_rng(0)))
        fused_delta_recs += more
        if not (handed or handed_tc):
            fail("no delta call under REPRO_FUSED=1 ran rounds on the "
                 "fused executor")
    finally:
        if prev_flag is None:
            os.environ.pop("REPRO_FUSED", None)
        else:
            os.environ["REPRO_FUSED"] = prev_flag
    del fused_kbs
    fused.clear_programs()
    if any(launches_fused[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched by the fused runs: "
             f"{launches_fused}")
    for r in rows:
        r["launches_fused"] = launches_fused[r["name"]]
        r["launches"] += launches_fused[r["name"]]
    rows.append(loop_row)
    log(f"[fused] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_fused}; device loops {loops_fused}")

    # 10. tg_linear over a precomputed TG, card against CPU
    t0 = time.perf_counter()
    tg_linear, launches_tgl = tg_linear_phase(facts)
    for r in rows:
        r["launches_tg_linear"] = sum(lc.get(r["name"], 0)
                                      for lc in launches_tgl.values())
        r["launches"] += r["launches_tg_linear"]
    log(f"[tg_linear] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_tgl}")

    # 11. the sharded executor: BENCH_dist.json's rows, card against CPU,
    # and LUBM-L at full width against the card's two-phase run
    t0 = time.perf_counter()
    dist, launches_dist = dist_phase(facts, lubm_rows, lubm_stats)
    for r in rows:
        r["launches_dist"] = launches_dist.get(r["name"], 0)
        r["launches"] += r["launches_dist"]
    log(f"[dist] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_dist}")

    # 12. serving dense LMs: a KB materialized on the card, linearized and
    # served by lm_100m (card against CPU), and stablelm_12b at full width
    del kb_g
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served, launches_serve, tokens_12 = serve_phase(facts, lubm_nfacts,
                                                    lubm_stats)
    for r in rows:
        r["launches_serve"] = launches_serve.get(r["name"], 0)
        r["launches"] += r["launches_serve"]
    log(f"[serve] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_serve}")
    if any(launches_serve[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched on the KB->LM path: "
             f"{launches_serve}")

    # 13. serving MoE and MLA LMs: the KB's tokens served by a narrow MLA +
    # MoE model (card against CPU), qwen3_moe_30b_a3b at full width and
    # depth, deepseek_v3_671b at full width
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served_moe, launches_moe = serve_moe_phase(facts, lubm_nfacts,
                                               lubm_stats, tokens_12)
    del tokens_12
    for r in rows:
        r["launches_serve_moe"] = launches_moe.get(r["name"], 0)
        r["launches"] += r["launches_serve_moe"]
    log(f"[serve_moe] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_moe}")
    if any(launches_moe[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched on the KB->MoE LM path: "
             f"{launches_moe}")

    print(json.dumps({"profile": prof}))
    print(json.dumps({"sort_2^22": sort_2_22}))
    print(json.dumps({"probe_grid": grid}))
    print(json.dumps({"deltas": deltas}))
    print(json.dumps({"recovery": drills}))
    print(json.dumps({"fused": fused_recs,
                      "fused_deltas": fused_delta_recs}))
    print(json.dumps({"tg_linear": tg_linear}))
    print(json.dumps({"dist": dist}))
    print(json.dumps({"serve": {**served, "card": smi}}))
    print(json.dumps({"serve_moe": {**served_moe, "card": smi}}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
