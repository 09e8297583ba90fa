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
   where one computes the same function, and its bound (the bytes the cost
   walk counts for the call, over the card's memory rate); and break a whole
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
   round 1); the three drills run side by side; each save's time and
   bytes are printed.
9. the fused executor (``REPRO_FUSED=1``) on the card: LUBM-L
   ``n_univ=2000``, wide TC at 1,000,000 chains and the deep chain of
   ``benchmarks/bench_fused.py`` (``tc_facts(192, 16)``, its generator
   copied here), each cold and then warm on a fresh ``EngineKB``.  Every
   run is held against the fused run on the CPU from the same capacity
   memo (rows, MatStats with ``extra``, SORT_STATS, count_pulls,
   fused_pulls, fused_retries; the CPU's cold runs of LUBM-L and wide TC
   come from a child started before phase 7, which runs them beside the
   card's work) and against the two-phase run on the card
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
14. serving SSM and hybrid LMs (``models/ssm.py``, zamba2's shared
   block, ``causal_tree_attn``; no kernel of their own): phase 12's KB
   materialized and linearized again (every kernel must launch, the
   tokens equal phase 12's), served by ``kb_mamba`` (falcon's pattern)
   and ``kb_zamba`` (zamba2's, the shared block after every 2nd layer) at
   ``lm_100m``'s width, float32 on the card against the CPU, then
   bfloat16, timed.  ``falcon_mamba_7b``'s and ``zamba2_1p2b``'s
   ``CONFIG`` at full width and depth in bfloat16: prefill 8 x 2048 cold
   and warm, 32 greedy tokens, finite logits, peak memory, one decode
   step profiled, and the first decode step against a re-prefill: the
   logits and every layer's conv tail and h (and zamba2's shared K/V
   rows) within ``BF16_REL`` in rms, with planted faults (h not
   advanced, conv tail not shifted, zamba2's K/V row not written) above
   it; falcon over 8 x 2048 + 1, zamba2 over 8 x 255 + 1, where the
   re-prefill fits one SSM chunk (its 8 x 2048 + 1 is printed: the
   reference's multi-chunk SSD is not exact).  2-layer float32 copies at
   full width on the card against the CPU: falcon, zamba2 with the
   shared block after every 2nd layer, and ``stablelm_12b`` with
   ``causal_tree_attn`` over 2 x 2048, also against the same copy
   without the tree.  It adds the ``serve_ssm`` line and a
   ``launches_serve_ssm`` key to each kernel row.
15. training (``Model.loss_fn`` / ``train_step``, ``train/``,
   ``launch/train.py``; no kernel of its own): phase 12's KB materialized
   and linearized again (every kernel must launch, the tokens equal phase
   12's).  ``lm_100m`` at the linearizer's vocabulary (703 M): two
   float32 ``train_step``s (TF32 off) on 2 x 256 of the KB's tokens, card
   against CPU from the same weights: loss, ce and grad_norm within
   ``F32_METRIC_REL``, ``lr`` equal, every gradient within
   ``F32_GRAD_RMS`` in rms and every weight's update within
   ``F32_UPDATE_RMS``, with two planted faults above their bounds (the
   attention output detached, Adam's bias correction dropped); then in
   bfloat16 through ``train`` at 8 x 256 with checkpoints every 3 steps:
   6 steps, then a second call to 8 that must resume at 6 with the data
   state restored and equal an uninterrupted 8-step run to the bit, both
   under ``torch.use_deterministic_algorithms``; then the 8 steps with
   the defaults, timed (step ms, tokens/s, peak, the example's first and
   last loss).
   ``zamba2_1p2b``'s ``CONFIG`` whole through ``launch.train.main`` at 8 x
   2048 (2 microbatches, remat full), 4 steps: finite losses and gradient
   norms, the step-0 loss within 0.2 of ln(V) + d_model 0.02^2 / 2 (what
   random weights give), step ms, tokens/s, peak, one profiled step and 6
   N tokens FLOP/s (N active) against the bf16 peak, and one more step
   under the cost walk.  2-layer float32 copies at full
   width, card against CPU: one ``train_step`` of zamba2 (shared block
   after every 2nd layer, 2 x 1040), ``stablelm_12b`` with ``flash_vjp``
   (2 x 1040; loss and gradients, also against the plain backward) and
   ``falcon_mamba_7b`` (2 x 520; loss and gradients through the Mamba-1
   scan's backward, a fault planted in its adjoint).  The CPU's sides run
   on a background thread.  It adds the ``train`` line
   and a ``launches_train`` key to each kernel row.
16. the analysis layer (``repro_torch.analysis``): ``engine_op_roofline``
   at phase 5's largest shapes on the card and on the CPU, every count
   equal; phase 5's bounds, now the counted bytes of one call over
   ``roofline.HBM_BW``, equal to PERF.md's kernel table
   (``PHASE5_BOUND_MS``); ``lower_fused_programs`` on phase 9's warm
   LUBM-L fused KBs, card and CPU from the same memo, counts equal and
   the memo untouched, each program's memory term beside the profiled
   warm run's busy time; the cost walk of one more zamba2 train step
   (phase 15, 8 x 2048) and of one ``stablelm_12b`` decode step (phase
   12), counted FLOPs, bytes and memory beside the measured step, its
   busy time and its peak; phase 15's model FLOP/s from
   ``roofline.model_flops_estimate`` (active parameters) over
   ``roofline.PEAK_FLOPS``.  It adds the ``analysis`` line.
17. serving on a mesh (``launch/mesh.py``, the models' mesh paths; no
   kernel of its own), run on the card while phase 15's CPU side finishes
   (so before phase 16): (i) ``stablelm_12b``'s ``CONFIG`` at full width
   and depth in bfloat16 through the process path, an in-process NCCL
   world of one, from phase 12's weights and prompts (8 x 2048 + 64): its
   tokens phase 12's, its logits within ``BF16_REL``; (ii)
   ``launch/serve.py --smoke`` under ``torchrun --standalone
   --nproc-per-node=<cards>``, its tokens the in-process run's; (iii)
   thread ranks on the card at tp = 2 and 4 (and (2, 2) for the a2a
   dispatch) of 2-layer float32 copies at full width (``stablelm_12b``,
   ``qwen3_moe_30b_a3b`` with psum and with a2a, ``deepseek_v3_671b``'s
   two MLA layers with the dense FFN), 2 x 1040 + 4, each against the
   same weights without a mesh: tokens equal, logits and every rank's
   cache chunk within ``F32_RMS``, with two planted faults above it (the
   log-sum-exp merge without its max correction, a rank writing the new
   row outside its chunk).  With several cards (i) runs again at tp =
   the card count, one process per card (logits held, tokens counted:
   bfloat16 sums in another order flip near-ties), timed.  It adds the
   ``mesh`` line and a ``launches_mesh`` key to each kernel row.
18. training on a mesh (the mesh paths' gradients, ZeRO-1, FSDP; no
   kernel of its own), after phase 15's comparisons have freed the
   records phase 15 keeps on the card: (i) ``zamba2_1p2b``'s ``CONFIG``
   whole in bfloat16 as two thread ranks at (2, 1) (data parallel: no
   collective inside its backward), from phase 15's weights and batches,
   two steps within ``BF16_REL`` of phase 15's one-device steps, timed;
   (ii) ``launch/train.py --smoke`` under ``torchrun
   --nproc-per-node=<cards>`` (NCCL), its losses the in-process run's;
   (iii) 2-layer float32 copies at full width, 2 x 520, as four
   processes sharing the card (``MeshTrainWorkers``: thread ranks cannot
   run a backward with a collective on a card, NCCL refuses two ranks on
   one device; the processes' collectives go through buffers on the card
   that each maps, ordered by gloo barriers): ``stablelm_12b`` at (1, 2)
   and (2, 2), ``qwen3_moe_30b_a3b`` with a2a at (2, 2),
   ``deepseek_v3_671b``'s two dense MLA layers with FSDP at (2, 2),
   ``falcon_mamba_7b`` and ``zamba2_1p2b`` at (1, 2),
   and zamba2 with ``grad_compress`` at (2, 2), one ``train_step`` each
   against the plain run: loss, ce and grad_norm within
   ``F32_METRIC_REL``, every gathered gradient within ``F32_GRAD_RMS``,
   every gathered weight after within ``F32_UPDATE_RMS``, each int8 scale
   within ``INT8_SCALE_REL`` of the whole tensor's; with three planted
   faults above their bounds (an all-reduce whose backward sums, a ZeRO-1
   update left un-gathered, an int8 scale from the shard).  It adds the
   ``mesh_train`` line and a ``launches_mesh_train`` key to each kernel
   row.

It prints a ``{"profile": [...]}`` line, a ``{"sort_2^22": {...}}`` line,
a ``{"probe_grid": {...}}`` line, a ``{"deltas": [...]}`` line, a
``{"recovery": [...]}`` line, a ``{"fused": [...]}`` line, a
``{"tg_linear": {...}}`` line, a ``{"dist": {...}}`` line, a
``{"serve": {...}}`` line, a ``{"serve_moe": {...}}`` line, a
``{"serve_ssm": {...}}`` line, a ``{"train": {...}}`` line, an
``{"analysis": {...}}`` line, a ``{"mesh": {...}}`` line, a
``{"mesh_train": {...}}`` line, a ``{"kernels": [...]}`` line,
the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  It needs a CUDA card and the
repository's ``src/`` beside it, and exits non-zero without a result
otherwise.  ``chip_smoke.py --child ...`` is phase 8's child process,
``chip_smoke.py --fused-cpu DIR`` phase 9's CPU cold runs, and
``chip_smoke.py --mesh-child DIR`` (under ``torchrun``) a rank of phase
17's run on several cards; phase 18's processes are spawned
(``mesh_train_worker``).
"""
from __future__ import annotations

import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# phase 15 holds a resumed bfloat16 run to the bit under deterministic
# algorithms, which need cuBLAS's fixed workspace; cuBLAS reads it once
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
LUBM_UNIV = 2000
TC_CHAINS = 1_000_000
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


def profile_run(name: str, fn, host_ops: bool = True) -> dict:
    """Wall time of ``fn`` (ending in a synchronize), the device's busy
    time in it from a torch.profiler trace, the number of device entries
    (kernels, copies, memsets) and the ones that took the most time.
    Without ``host_ops`` the trace holds the device's entries only (a
    smaller trace where other threads run host ops meanwhile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
            shape = {"n": keys.numel(), "dtype": str(keys.dtype),
                     "block": block}
        elif name == "unique_mask":
            (data,) = args
            data = data.clone()
            kern = lambda: UM.unique_mask(data)  # noqa: E731
            base = lambda: ref.unique_mask_ref(data)  # noqa: E731
            lib = None
            n, c = data.shape
            shape = {"n": n, "cols": c, "dtype": str(data.dtype)}
        else:
            q, hay = (a.clone() for a in args)
            kern = lambda: HP.probe_sorted(q, hay)  # noqa: E731
            base = lambda: ref.probe_sorted_ref(q, hay)  # noqa: E731

            def lib():
                idx = torch.searchsorted(hay, q).clamp_(max=hay.numel() - 1)
                return hay[idx] == q
            shape = {"n": q.numel(), "hay": hay.numel(),
                     "dtype": str(q.dtype)}
        got, want = kern(), base()
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        mism = sum(mismatches(g, w) for g, w in pairs)
        err = max_abs_err(pairs)
        if mism:
            fail(f"{name} disagrees with its plain version at {shape}")
        bound = counted(kern)
        ms = time_ms(kern)
        dev_ms = device_ms(kern)
        plain_ms = time_ms(base)
        library_ms = time_ms(lib) if lib is not None else None
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "mismatches": mism, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": "bytes",
            "bytes": bound["bytes"], "library_ms": library_ms,
            "shape": shape})
    return rows


def counted(fn) -> dict:
    """One call of ``fn`` under the cost walk (``repro_torch.analysis``):
    the bytes its kernels must move by their formulas (each input read
    once, each output written once; the probe's haystack by the 32-byte
    sectors its answers rest on), and that over the card's memory rate
    (``roofline.HBM_BW``)."""
    from repro_torch.analysis import cost
    from repro_torch.analysis import roofline as RL
    with cost.Recorder() as r:
        fn()
    return {"bytes": r.cost.bytes, "flops": r.cost.flops,
            "bound_ms": r.cost.bytes / RL.HBM_BW * 1e3}


# (queries, haystack keys, key type) of the probe's shape grid
PROBE_GRID = [(n, h, dt) for dt in (torch.int32, torch.int64)
              for n in (1 << 16, 1 << 20)
              for h in (1 << 12, 1 << 18, 1 << 22, 1 << 24)]


def probe_grid(HP, ref, rng) -> dict:
    """The probe over ``PROBE_GRID``: random keys in [0, 4H), so about a
    fifth of the queries are found; mismatches against the plain version,
    device time, time per call, and the byte bound (``counted``).  At
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
            "bound_ms": counted(kern)["bound_ms"]}
        del hay, q
    return out


def sort_breakdown(BS, KO, rng) -> dict:
    """A whole 2^22 int32 ``sort_with_payload`` (tile 1024): the device
    time of its tile sort and of its merge at each width, of the whole sort,
    and of ``torch.sort(keys, stable=True)`` as a yardstick the port never
    calls.  The bound counts one read and one write of every key and
    payload per kernel call (``counted``)."""
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
            "bound_ms": counted(full)["bound_ms"],
            "tile_device_ms": device_ms(
                lambda: BS.bitonic_sort_tiles(keys, pos, tile)),
            "merge_device_ms": merge_ms,
            "sort_ms": time_ms(full), "sort_device_ms": device_ms(full),
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


def release_card() -> None:
    """This process's free memory on the card handed back: the collected
    tensors' blocks, and cuBLAS's workspaces (one for each thread that ran
    a matmul, held in the allocator's cache: a workspace left in a large
    free segment keeps the whole segment)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


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
    must reach the uninterrupted run's rows and counters.  The drills are
    independent (a directory each) and run side by side, one thread each
    driving its two children in turn."""
    import signal
    from concurrent.futures import ThreadPoolExecutor
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

    def drill(label, n_univ, fault, rc_want, resumed_want):
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
        return {"drill": label, "n_univ": n_univ, "fault": fault,
                "exit": rc, "saves": [x for x in lines if "save" in x],
                "resume": res,
                "resume_saves": [x for x in lines2 if "save" in x]}

    with ThreadPoolExecutor(len(drills)) as pool:
        jobs = [pool.submit(drill, *x) for x in drills]
        out = [j.result() for j in jobs]
    for rec in out:
        log(f"[recovery] {json.dumps(rec)}")
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
    from repro_torch.analysis import roofline as RL
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
            "bound_ms": nbytes / RL.HBM_BW * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "shape": {"iterations": iters, "state": [list(x.shape)
                                                     for x in state]}}


def fused_workloads(facts):
    """Phase 9's LUBM-L and wide TC: (name, make_kb(device))."""
    from repro_torch import EngineKB
    from repro_torch.data.kb_sources import LUBM_L, TC, tc_wide_chunks
    return [("lubm_l", lambda d: EngineKB(LUBM_L, facts, device=d)),
            ("tc_wide", lambda d: EngineKB.from_stream(
                TC, tc_wide_chunks(TC_CHAINS), device=d))]


def fused_cpu_cold(out_dir: str) -> int:
    """``chip_smoke.py --fused-cpu DIR``: phase 9's CPU cold fused runs of
    LUBM-L and wide TC (about 170 s), each from an empty capacity memo as
    ``fused_workload`` would make them, in a child that runs beside the
    card's work of phases 7-9.  For each workload: its rows
    (``<name>.npz``), the memo it converged to (``<name>.memo``, pickled)
    and, written last, its counters and wall (``<name>.json``)."""
    import pickle
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data.kb_sources import lubm_facts
    from repro_torch.engine import fused, plan
    os.environ["REPRO_FUSED"] = "1"
    torch.set_num_threads(CPU_JOB_THREADS)
    for name, make_kb in fused_workloads(lubm_facts(n_univ=LUBM_UNIV)):
        plan._CAP_MEMO.clear()
        fused.clear_programs()
        kb, rec, card = fused_run(make_kb, "cpu")
        path = os.path.join(out_dir, name)
        np.savez(path + ".npz", **rows_by_pred(kb))
        with open(path + ".memo", "wb") as f:
            pickle.dump(dict(plan._CAP_MEMO), f)
        with open(path + ".part", "w") as f:
            json.dump({"rec": rec, "wall_ms": card["wall_ms"]}, f)
        os.replace(path + ".part", path + ".json")
        del kb
    return 0


def start_fused_cpu_cold(out_dir: str):
    """Start ``fused_cpu_cold`` in a child process, killed at exit if it
    still runs."""
    import atexit
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    with open(os.path.join(out_dir, "stderr"), "w") as err:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--fused-cpu", out_dir], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def fused_cpu_cold_run(proc, out_dir: str, name: str):
    """The child's cold run of ``name``, once written: (counters, wall ms,
    rows, the memo it converged to)."""
    import pickle
    path = os.path.join(out_dir, name)
    while not os.path.exists(path + ".json"):
        if proc.poll() is not None and not os.path.exists(path + ".json"):
            with open(os.path.join(out_dir, "stderr")) as f:
                fail(f"phase 9's CPU cold runs stopped ({proc.returncode}) "
                     f"before {name}: {f.read()[-3000:]}")
        time.sleep(0.2)
    with open(path + ".json") as f:
        got = json.load(f)
    with np.load(path + ".npz") as z:
        rows = {k: z[k] for k in z.files}
    with open(path + ".memo", "rb") as f:
        memo = pickle.load(f)
    return got["rec"], got["wall_ms"], rows, memo


def fused_workload(name, make_kb, checks, cpu_cold=None):
    """Phase 9 for one workload: two-phase on the card, fused cold and warm
    on the card and on the CPU from the same capacity memo, a profiled
    third run.  ``cpu_cold``, where given, returns the CPU's cold run as
    ``fused_cpu_cold_run`` does; the CPU's warm run then starts from the
    memo that run converged to.  Returns (record, summed card launches,
    device loops, and the KBs: warm fused on the card and on the CPU,
    two-phase on the card)."""
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
        if device == "cpu" and cpu_cold is not None:
            rec, wall_ms, rows, memo = cpu_cold()
            plan._CAP_MEMO.update(memo)
            runs["cpu"] = [(rows, rec, {"wall_ms": wall_ms}),
                           fused_run(make_kb, "cpu")]
        else:
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
        if not same_rows(rows, kb_c if isinstance(kb_c, dict)
                         else rows_by_pred(kb_c)):
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
                  # rms(b), for the logits and the K/V row or the SSM
                  # states decode wrote
FULL_RUN: dict = {}   # stablelm_12b's full-width run (phase 17 holds to it)
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
    seconds of the prefill and of each decode step, and the caches.  On a
    mesh (``mdl.mcx``) the tokens, margins, logits and caches are the
    rank's rows; ``feed`` is the whole batch's."""
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
    caches = pad_caches(caches, S + gen, mdl.mcx)
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
    there (TF32 off) and, in an attention model, its first decode step held
    against a re-prefill (to ``F32_RMS`` on the rows of the
    ``held_layers``, and the planted fault must read above it; the logits
    too, to ``F32_TOL`` and ``F32_RMS``, where every layer is held), then
    moved to the CPU and served again, fed the card's tokens.  An SSM or
    hybrid model's first decode step is held instead by
    ``ssm_vs_reprefill`` to ``F32_RMS`` in the logits and every layer's
    states, with its planted faults above it; a Mamba-2 model's over the
    first ``ssm_chunk - 1`` positions only, where the re-prefill fits one
    SSM chunk (the reference's multi-chunk SSD is not exact: ROADMAP,
    Queue 3).  The routing of a MoE model is held call by call
    (``routing_differences``), and the rows where it differs are left out
    of the comparison.  Returns the comparison."""
    from repro_torch.models.model import build
    mdl = build(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
    with RoutingLog() as routed_card:
        card = serve_run(mdl, tokens, gen, keep=(0, 1, gen))
    ssm = cfg.family in ("ssm", "hybrid")
    if not ssm:
        again = decode_vs_reprefill(mdl, tokens, card)
    elif cfg.ssm_version == 1:
        again = ssm_vs_reprefill(mdl, tokens)
    else:
        again = ssm_vs_reprefill(mdl, tokens[:, :cfg.ssm_chunk - 1])
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
    rec["ok"] = rec["ok"] and routing["all_near_ties"]
    if ssm:
        rec["ok"] = rec["ok"] and reprefill_held(again, F32_RMS) \
            and not again["step"]["token_mismatches"]
        return {**rec, "decode_vs_reprefill": {**again,
                                               "tol_rms_rel": F32_RMS},
                "card": timing(card, tokens.shape[0]),
                "cpu_s": time.perf_counter() - t0}
    rec["ok"] = rec["ok"] and again["kv_rms_rel_err"] <= F32_RMS \
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


CONFIG_KEYS = ("family", "num_layers", "d_model", "num_heads",
               "num_kv_heads", "head_dim", "d_ff", "vocab_size", "attn_chunk",
               "dtype", "attn_type", "q_lora_rank", "kv_lora_rank",
               "qk_nope_dim", "qk_rope_dim", "v_head_dim", "num_dense_layers",
               "dense_d_ff", "num_experts", "top_k", "num_shared_experts",
               "moe_d_ff", "d_inner", "ssm_state", "ssm_dt_rank",
               "ssm_head_dim", "ssm_chunk", "hybrid_attn_every",
               "causal_tree_attn")


def kb_lm_serve(name, cfg, tokens, kb_rec):
    """``cfg`` served on the KB's tokens: prefill and ``KB_LM``'s greedy
    tokens on padded caches, in float32 on the card against the CPU
    (``card_against_cpu``), then in bfloat16 on the card, timed after a
    warm-up.  Logs the record and fails unless the float32 runs agree and
    the bfloat16 logits are finite; returns the record."""
    from repro_torch.models.model import build
    f32 = card_against_cpu(cfg.with_(dtype="float32"), tokens,
                           KB_LM["gen"])
    mdl = build(cfg.with_(dtype="bfloat16"), "cuda",
                torch.Generator(device="cuda").manual_seed(0))
    serve_run(mdl, tokens, 2)                          # warm-up
    bf16 = serve_run(mdl, tokens, KB_LM["gen"])
    rec = {"config": {k: getattr(cfg, k) for k in CONFIG_KEYS},
           "params": sum(p.numel() for p in mdl.parameters()),
           **kb_rec, **KB_LM, "float32_card_vs_cpu": f32,
           "bfloat16": {**timing(bf16, KB_LM["batch"]),
                        "finite": bf16["finite"]},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del mdl
    torch.cuda.empty_cache()
    log(f"[serve] {name} {json.dumps(rec)}")
    if not f32["ok"] or not bf16["finite"]:
        fail(f"serve {name}: {rec}")
    return rec


def kb_lm_path(name, make_cfg, facts, lubm_nfacts, lubm_stats):
    """The KB -> LM path, its kernel launches counted from 0: the KB's
    tokens (``kb_tokens``) served by ``make_cfg(vocabulary)``
    (``kb_lm_serve``).  Returns the record, the launches and the
    tokens."""
    from repro_torch.kernels import ops as KO
    KO.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tokens, data, kb_rec = kb_tokens(facts, lubm_nfacts, lubm_stats)
    rec = kb_lm_serve(name, make_cfg(data.vocab_size), tokens, kb_rec)
    rec["launches"] = launches = KO.launch_counts()
    return rec, launches, tokens


def full_width(name, cfg, shape, dropless=None, walk=False, keep_run=None):
    """``cfg`` in bfloat16 on the card, random weights from seed 0: a cold
    prefill of ``shape``'s batch x prompt, then a warm one and ``gen``
    greedy tokens on padded caches, timed; the first decode step against
    a re-prefill (``decode_vs_reprefill``); one more decode step
    profiled; with ``dropless``, a MoE model's decode against a
    re-prefill where no expert overflows (``dropless_vs_reprefill``); the
    peak memory.  With ``walk``, the profiled step once more under the cost
    walk (``decode_step_count``, for phase 16).  ``keep_run``, a dict, gets
    the run's tokens, margins and kept logits (phase 17 holds its own run
    to them).  Returns the record."""
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
    if keep_run is not None:
        keep_run.update({k: run[k] for k in ("tokens", "margins", "logits")})
    again = decode_vs_reprefill(mdl, tokens, run)
    last = run["tokens"][:, -1].cuda()
    caches = run.pop("caches")
    prof = profile_run(f"{name} decode step", lambda: mdl.decode(
        caches, last, S + gen - 1))
    extra = {}
    if walk:
        params = dict(mdl.named_parameters())
        extra["decode_step_count"] = walk_step(
            lambda: mdl.decode_step(caches, last, S + gen - 1),
            (params, caches, last))
        del params
    del caches
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


def two_layers_against_cpu(name, cfg, shape=FULL_CPU):
    """A 2-layer float32 copy of ``cfg`` at full width, card against CPU
    (``card_against_cpu``) over ``shape``'s batch x prompt."""
    tokens = torch.randint(0, cfg.vocab_size, (shape["batch"],
                                               shape["prompt"]),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(2))
    two = card_against_cpu(cfg.with_(num_layers=2, dtype="float32"),
                           tokens, shape["gen"])
    torch.cuda.empty_cache()
    log(f"[serve] {name} 2 layers {json.dumps(two)}")
    if not two["ok"]:
        fail(f"serve {name} 2 layers: card and CPU differ: {two}")
    return {**shape, **two}


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
    full = full_width("stablelm_12b", cfg, FULL, walk=True,
                      keep_run=FULL_RUN)
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


# ---------------------------------------------------------------------------
# phase 14: serving SSM and hybrid LMs
# ---------------------------------------------------------------------------
FULL_SSM = {"batch": 8, "prompt": 2048, "gen": 32}  # falcon / zamba2
ONE_CHUNK = {"batch": 8, "prompt": 255}  # zamba2: the re-prefill of 256
                                         # fits one SSM chunk
TREE = {"batch": 2, "prompt": 2048, "gen": 4}  # stablelm_12b, 2 layers:
                                               # two attention chunks


def kb_mamba(vocab: int):
    """``falcon_mamba_7b``'s pattern (Mamba-1 layers, tied embeddings,
    state 16, dt rank d_model / 16) at ``lm_100m``'s width and depth and
    the linearizer's vocabulary."""
    return lm_100m(vocab).with_(
        name="kb-mamba", family="ssm", num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, attn_type="none", ssm_version=1, ssm_state=16,
        ssm_conv=4, ssm_dt_rank=48, tie_embeddings=True)


def kb_zamba(vocab: int):
    """``zamba2_1p2b``'s pattern (Mamba-2 layers, state 64 and as many
    heads, and a shared MHA + gelu MLP block, here after every 2nd layer)
    at ``lm_100m``'s width and depth and the linearizer's vocabulary."""
    return lm_100m(vocab).with_(
        name="kb-zamba", family="hybrid", num_kv_heads=12, mlp_type="gelu",
        ssm_version=2, ssm_state=64, ssm_conv=4, ssm_head_dim=24,
        ssm_ngroups=1, hybrid_attn_every=2)


class StepFault:
    """While entered, each Mamba decode step (``mamba1_step``,
    ``mamba2_step``) returns its output as it should, but hands on the
    state ``alter(old state, new state)``: a planted fault."""

    def __init__(self, alter):
        self.alter = alter

    def __enter__(self):
        from repro_torch.models import ssm
        self.mod, self.steps = ssm, (ssm.mamba1_step, ssm.mamba2_step)

        def faulty(step):
            def run(p, x, cfg, state, *mesh):
                out, new = step(p, x, cfg, state, *mesh)
                return out, self.alter(state, new)
            return run
        ssm.mamba1_step, ssm.mamba2_step = map(faulty, self.steps)
        return self

    def __exit__(self, *exc):
        self.mod.mamba1_step, self.mod.mamba2_step = self.steps


# faults planted in a decode step's Mamba layers
SSM_FAULTS = {"h_not_advanced": lambda old, new: (new[0], old[1]),
              "conv_not_shifted": lambda old, new: (old[0], new[1])}


def ssm_states(caches, S) -> dict:
    """Float32 copies of every layer's conv tail and h, (L, B, ...), and of
    a hybrid's shared K/V rows at position S, (slots, B, KV, hd)."""
    conv, h = caches["ssm"]
    out = {"conv": conv.to(torch.float32, copy=True), "h": h.clone()}
    for n in ("k", "v"):
        if n in caches:
            out[n] = caches[n][:, :, S].to(torch.float32, copy=True)
    return out


def ssm_vs_reprefill(mdl, tokens) -> dict:
    """The first decode step of an SSM or hybrid model (fed the prefill's
    greedy token, on caches padded to S + 1) against a prefill of the
    prompt and that token: rms(a - b) / rms(b) of the logits and, in the
    worst layer, of each state ``ssm_states`` lists; the same for the
    planted faults (``SSM_FAULTS``; a hybrid also decodes on its
    prompt-length K/V caches, ``kv_not_written``, which leaves the row at
    S to the padding's zeros); max |a - b| of the step's logits, and its
    tokens against the re-prefill's where the top-2 margin exceeds twice
    that."""
    from repro_torch.models.model import pad_caches
    V, S = mdl.cfg.vocab_size, tokens.shape[1]
    logits, caches = mdl.prefill({"tokens": tokens})
    fed = logits.argmax(-1)
    base = pad_caches(caches, S + 1)
    del caches

    def fresh(length=S + 1):
        return {n: tuple(t.clone() for t in c) if n == "ssm"
                else c[:, :, :length].clone() for n, c in base.items()}

    def step(caches, alter=None):
        if alter:
            with StepFault(alter):
                out, caches = mdl.decode(caches, fed, S)
        else:
            out, caches = mdl.decode(caches, fed, S)
        return out.float()[:, :V], ssm_states(pad_caches(caches, S + 1), S)

    runs = {"step": step(fresh())}
    for name, alter in SSM_FAULTS.items():
        runs[name] = step(fresh(), alter)
    if "k" in base:
        runs["kv_not_written"] = step(fresh(S))
    again, caches = mdl.prefill({"tokens": torch.cat([tokens, fed[:, None]],
                                                     1)})
    ref, ref_states = again.float()[:, :V], ssm_states(caches, S)
    del caches, base

    def rel(a, b):
        return rms(a - b) / rms(b)
    rec = {}
    for name, (got, states) in runs.items():
        worst = {n: max(rel(states[n][i], r[i]) for i in range(len(r)))
                 for n, r in ref_states.items()}
        rec[name] = {"rms_rel_err": rel(got, ref),
                     "worst_layer_rms_rel_err": worst,
                     "max": max(rel(got, ref), *worst.values())}
    got = runs["step"][0]
    err = float((got - ref).abs().max())
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * err
    rec["step"].update(max_abs_err=err, tokens_compared=int(sure.sum()),
                       token_mismatches=int((got.argmax(-1)[sure]
                                             != ref.argmax(-1)[sure]).sum()))
    return {"prompt": S, **rec}


def reprefill_held(rec, tol) -> bool:
    """The step within ``tol`` in the logits and every state's worst
    layer, and each planted fault above it somewhere."""
    faults = [n for n in rec if n not in ("prompt", "step")]
    return rec["step"]["max"] <= tol and all(rec[n]["max"] > tol
                                             for n in faults)


def ssm_full_width(name, cfg, shape, one_chunk=None):
    """``cfg`` in bfloat16 on the card, random weights from seed 0: a cold
    prefill of ``shape``'s batch x prompt, then a warm one and ``gen``
    greedy tokens on padded caches, timed; one more decode step profiled;
    the first decode step against a re-prefill over the prompt
    (``ssm_vs_reprefill``) and, with ``one_chunk``, over that shorter
    prompt (random tokens from seed 3); the peak memory.  Returns the
    record."""
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
    run = serve_run(mdl, tokens, gen, keep=(0,))
    last = run["tokens"][:, -1].cuda()
    prof = profile_run(f"{name} decode step", lambda: mdl.decode(
        run.pop("caches"), last, S + gen - 1))
    again = {"full": ssm_vs_reprefill(mdl, tokens)}
    if one_chunk:
        short = torch.randint(0, cfg.vocab_size, (B, one_chunk["prompt"]),
                              device="cuda", generator=torch.Generator(
                                  device="cuda").manual_seed(3))
        again["one_chunk"] = ssm_vs_reprefill(mdl, short)
    rec = {"config": {k: getattr(cfg, k) for k in CONFIG_KEYS},
           "params": sum(p.numel() for p in mdl.parameters()), **shape,
           "build_s": t_build, "prefill_cold_ms": t_cold * 1e3,
           **timing(run, B), "finite": run["finite"],
           "decode_step_profile": prof,
           "decode_vs_reprefill": {**again, "tol_rms_rel": BF16_REL},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del mdl, run, tokens
    torch.cuda.empty_cache()
    log(f"[serve_ssm] {name} {json.dumps(rec)}")
    return rec


def tree_against_flash(cfg) -> dict:
    """``cfg``'s 2-layer float32 copy with ``causal_tree_attn`` over
    ``TREE``'s batch x prompt (two attention chunks, so one split): on the
    card against the CPU (``two_layers_against_cpu``), and on the card
    against the same copy without the tree, fed the same tokens
    (``compare_runs`` within ``F32_TOL``)."""
    from repro_torch.models.model import build
    tree = cfg.with_(causal_tree_attn=True)
    rec = two_layers_against_cpu(f"{cfg.name} causal_tree_attn", tree, TREE)
    tokens = torch.randint(0, cfg.vocab_size, (TREE["batch"],
                                               TREE["prompt"]),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(2))
    two = tree.with_(num_layers=2, dtype="float32")
    mdl = build(two, "cuda", torch.Generator(device="cuda").manual_seed(0))
    with_tree = serve_run(mdl, tokens, TREE["gen"], keep=(0, 1, TREE["gen"]))
    mdl.cfg = two.with_(causal_tree_attn=False)
    flash = serve_run(mdl, tokens, TREE["gen"], feed=with_tree["tokens"],
                      keep=(0, 1, TREE["gen"]))
    del mdl, with_tree["caches"], flash["caches"]
    torch.cuda.empty_cache()
    rec["card_vs_flash"] = compare_runs(with_tree, flash, F32_TOL)
    rec["card_vs_flash"]["tree_prefill_ms"] = with_tree["prefill_s"] * 1e3
    rec["card_vs_flash"]["flash_prefill_ms"] = flash["prefill_s"] * 1e3
    log(f"[serve_ssm] {cfg.name} causal_tree_attn vs flash "
        f"{json.dumps(rec['card_vs_flash'])}")
    if not rec["card_vs_flash"]["ok"]:
        fail(f"serve_ssm: causal_tree_attn differs from flash: {rec}")
    return rec


def serve_ssm_phase(facts, lubm_nfacts, lubm_stats, tokens_12):
    """Phase 14.  (a) Phase 12's KB, materialized and linearized once more
    (every kernel must launch; the tokens equal phase 12's), served by
    ``kb_mamba`` and by ``kb_zamba`` (``kb_lm_serve``: float32 on the card
    against the CPU, then bfloat16, timed).  (b) ``falcon_mamba_7b``'s
    and (c) ``zamba2_1p2b``'s ``CONFIG`` at full width and depth in
    bfloat16 (``ssm_full_width``, 8 x 2048 + 32): finite logits; decode
    against a re-prefill (``ssm_vs_reprefill``) held to ``BF16_REL`` with
    the planted faults above it, for falcon over 8 x 2048 + 1, for zamba2
    over 8 x 255 + 1, where the re-prefill fits one SSM chunk; zamba2's
    over 8 x 2048 + 1 is printed, not held: the reference's multi-chunk
    SSD is not exact (ROADMAP, Queue 3), and the port keeps it.  (d)
    2-layer float32 copies at full width on the card against the CPU:
    falcon, zamba2 with the shared block after every 2nd layer (so that
    it runs), and ``stablelm_12b`` with ``causal_tree_attn``, also against
    the same copy without the tree (``tree_against_flash``).  Returns the
    ``serve_ssm`` record and the kernel launches of (a)'s path."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops as KO

    # (a) KB -> Mamba-1 and Mamba-2 hybrid LMs
    KO.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tokens, data, kb_rec = kb_tokens(facts, lubm_nfacts, lubm_stats)
    if not torch.equal(tokens, tokens_12):
        fail("serve_ssm: the KB's tokens differ from phase 12's")
    out = {name: kb_lm_serve(name, make(data.vocab_size), tokens, kb_rec)
           for name, make in (("kb_mamba", kb_mamba), ("kb_zamba",
                                                          kb_zamba))}
    out["launches"] = launches = KO.launch_counts()
    del data, tokens

    # (b) falcon_mamba_7b, (c) zamba2_1p2b at full width and depth
    falcon = ssm_full_width("falcon_mamba_7b", get_config("falcon_mamba_7b"),
                            FULL_SSM)
    if not (falcon["finite"] and reprefill_held(
            falcon["decode_vs_reprefill"]["full"], BF16_REL)):
        fail(f"serve_ssm falcon_mamba_7b: {falcon}")
    zamba = ssm_full_width("zamba2_1p2b", get_config("zamba2_1p2b"),
                           FULL_SSM, ONE_CHUNK)
    if not (zamba["finite"] and reprefill_held(
            zamba["decode_vs_reprefill"]["one_chunk"], BF16_REL)):
        fail(f"serve_ssm zamba2_1p2b: {zamba}")
    out["falcon_mamba_7b"], out["zamba2_1p2b"] = falcon, zamba

    # (d) 2-layer float32 copies at full width, card against CPU
    falcon["two_layers_float32_card_vs_cpu"] = two_layers_against_cpu(
        "falcon_mamba_7b", get_config("falcon_mamba_7b"))
    zamba["two_layers_float32_card_vs_cpu"] = two_layers_against_cpu(
        "zamba2_1p2b", get_config("zamba2_1p2b").with_(hybrid_attn_every=2))
    out["stablelm_12b_causal_tree_attn"] = tree_against_flash(
        get_config("stablelm_12b"))
    return out, launches


# ---------------------------------------------------------------------------
# phase 15: training, on the KB's tokens and at full width
# ---------------------------------------------------------------------------
TRAIN_F32 = {"batch": 2, "seq": 256, "steps": 2}   # lm_100m, card vs CPU
TRAIN_BF16 = {"batch": 8, "seq": 256, "steps": 8, "ckpt_every": 3,
              "resume_at": 6}                      # lm_100m through train()
ZAMBA_ARGS = ["--arch", "zamba2_1p2b", "--batch", "8", "--seq", "2048",
              "--steps", "4"]
TRAIN_2L = {"batch": 2, "seq": 1040,   # stablelm's and zamba2's 2-layer
                                      # copies: two attention chunks, four
                                      # SSD chunks and a part
            "falcon_seq": 520}        # falcon_mamba_7b's: two scan chunks
                                      # and a part (the CPU's time)
F32_METRIC_REL = 1e-4   # card against CPU, float32 (TF32 off): loss, ce,
                        # grad_norm, relative
F32_GRAD_RMS = 1e-3     # each gradient: rms(card - CPU) / rms(CPU), or
ZERO_FLOOR = 1e-6       # / (ZERO_FLOOR x the largest such rms) where the
                        # CPU's is below that (a gradient zero but for
                        # rounding)
F32_UPDATE_RMS = 1e-2   # each weight after the steps: rms(card - CPU) /
                        # rms(CPU's update), as the same fraction
INIT_STD = 0.02            # the std every weight matrix is drawn with
LN_VOCAB_TOL = 0.2         # zamba2's step-0 loss against its expectation
CARD = "cuda"              # the device phase 15 trains on
CPU_JOB_THREADS = max(1, (os.cpu_count() or 1) - 2)   # the CPU's sides


def rel_errors(got, want, init=None) -> dict:
    """Per name, taken on the card: rms(got - want) over rms(want), or with
    ``init`` over rms(want - init) (the reference run's update); over
    ``ZERO_FLOOR`` times the largest such rms where it is below that."""
    def on_card(t):
        return t.detach().to(CARD, torch.float32)

    def scale(n):
        w = on_card(want[n])
        return rms(w if init is None else w - on_card(init[n]))
    scales = {n: scale(n) for n in want}
    floor = ZERO_FLOOR * max(scales.values())
    return {n: rms(on_card(got[n]) - on_card(want[n]))
            / max(scales[n], floor, 1e-30) for n in want}


def worst(errs: dict) -> list:
    name = max(errs, key=errs.get)
    return [name, errs[name]]


def f32_steps(mdl, batches, init=None, keep_grads=True, keep_after=True):
    """``len(batches)`` train_steps of ``mdl``, from the weights ``init``
    where given.  With ``keep_grads`` each call of the instance's
    ``_grads`` (one per microbatch) keeps its gradients, and with
    ``keep_after`` the weights after the last step are kept, on the
    model's device.  Returns {"metrics": per step, "grads": per call,
    "after"}."""
    from repro_torch.train import optimizer as OPT
    if init is not None:
        mdl.load_state_dict(init)
    calls, inner = [], mdl._grads

    def wrapped(params, batch):
        loss, met, grads = inner(params, batch)
        if keep_grads:
            calls.append(grads)
        return loss, met, grads
    mdl._grads = wrapped
    params = dict(mdl.named_parameters())
    opt = OPT.init_opt_state(params, mdl.opt_cfg)
    rec = {"metrics": []}
    try:
        for i, b in enumerate(batches):
            opt, met = mdl.train_step(opt, b, i)
            rec["metrics"].append({k: float(v) for k, v in met.items()})
    finally:
        del mdl._grads, opt
    if keep_grads:
        rec["grads"] = calls
    if keep_after:
        rec["after"] = {n: p.detach().clone() for n, p in params.items()}
    return rec


def loss_and_grads(mdl, batch) -> dict:
    """The loss, ce and gradients of ``batch`` (``Model._grads``), in
    ``f32_steps``' record."""
    loss, met, grads = mdl._grads(dict(mdl.named_parameters()), batch)
    return {"metrics": [{"loss": float(loss), "ce": float(met["ce"])}],
            "grads": [grads]}


def held_f32(got, want, init=None) -> dict:
    """Record ``got`` against ``want`` (both from ``f32_steps`` or
    ``loss_and_grads``, from the same weights ``init``): the largest metric
    error, whether ``lr`` is equal, the worst gradient and (with ``init``)
    weight-update errors, and whether each is within its bound."""
    rec = {}
    metric = [abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
              for g, w in zip(got["metrics"], want["metrics"])
              for k in ("loss", "ce", "grad_norm") if k in g and k in w]
    if metric:
        rec["metric_rel_max"] = max(metric)
    if all("lr" in m for m in got["metrics"] + want["metrics"]):
        rec["lr_equal"] = all(g["lr"] == w["lr"] for g, w in zip(
            got["metrics"], want["metrics"]))
    if "grads" in got and "grads" in want:
        rec["grad_rms_rel_worst"] = max(
            (worst(rel_errors(g, w)) for g, w in zip(got["grads"],
                                                     want["grads"])),
            key=lambda e: e[1])
    if init is not None and "after" in got and "after" in want:
        rec["update_rms_rel_worst"] = worst(rel_errors(
            got["after"], want["after"], init))
    rec["ok"] = rec.get("metric_rel_max", 0) <= F32_METRIC_REL and \
        rec.get("lr_equal", True) and \
        rec.get("grad_rms_rel_worst", [0, 0])[1] <= F32_GRAD_RMS and \
        rec.get("update_rms_rel_worst", [0, 0])[1] <= F32_UPDATE_RMS
    return rec


class Patched:
    """While entered, ``module.name`` is ``value``: a planted fault."""

    def __init__(self, module, name, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.old = getattr(self.module, self.name)
        setattr(self.module, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.old)


# name: (module, attribute replaced, what of the run is kept, the key of
# ``held_f32`` that must read above its bound, the bound)
TRAIN_FAULTS = {
    # the attention output cut from the graph: wq, wk and wv get no
    # gradient (their error reads 1)
    "attention_detached": ("repro_torch.models.layers", "flash_attention",
                           "grads", "grad_rms_rel_worst", F32_GRAD_RMS),
    # Adam without bias correction: the first update is 0.45 lr, not lr
    "no_bias_correction": ("repro_torch.train.optimizer", "_bias_correction",
                           "after", "update_rms_rel_worst", F32_UPDATE_RMS),
}


def fault_value(name):
    """The planted fault ``name`` for ``Patched``, acting on this thread
    only: the CPU's side of a comparison (``cpu_job``) may call the
    patched function on its own thread meanwhile, and gets the plain
    one."""
    import threading
    from repro_torch.models import layers
    from repro_torch.train import optimizer
    owner = threading.get_ident()
    if name == "attention_detached":
        plain = layers.flash_attention

        def detached(*a, **k):
            out = plain(*a, **k)
            return out.detach() if threading.get_ident() == owner else out
        return detached
    plain = optimizer._bias_correction
    return lambda beta, step: (1.0 if threading.get_ident() == owner
                               else plain(beta, step))


def timed(fn, *args, **kwargs):
    """(fn's result, its seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if CARD == "cuda":
        sync()
    return out, time.perf_counter() - t0


def kb_batches(data, n, rows):
    """``n`` batches of the linearizer's stream, each cut to ``rows``."""
    out = []
    for _ in range(n):
        b = data.next()
        out.append({k: v[:rows] for k, v in b.items()})
    return out


class StepClock:
    """While entered, every ``Model.train_step`` on the card is timed (a
    synchronize at either end) and its loss and gradient norm read; the
    call at step ``profile_step`` runs under ``profile_run``.  ``last``
    keeps the last call's model, optimizer state, batch and step."""

    def __init__(self, profile_step=None):
        self.profile_step = profile_step
        self.steps, self.profile, self.last = [], None, None

    def __enter__(self):
        from repro_torch.models import model
        self.cls, self.inner = model.Model, model.Model.train_step
        clock = self

        def timed(mdl, opt_state, batch, step):
            if mdl.device.type != CARD:
                return clock.inner(mdl, opt_state, batch, step)
            out = []
            sync()
            t0 = time.perf_counter()
            if step == clock.profile_step:
                clock.profile = profile_run(
                    f"{mdl.cfg.name} train step", lambda: out.append(
                        clock.inner(mdl, opt_state, batch, step)),
                    host_ops=False)
            else:
                out.append(clock.inner(mdl, opt_state, batch, step))
                sync()
            met = out[0][1]
            clock.last = (mdl, out[0][0], batch, step)
            clock.steps.append({"step": step,
                                "ms": (time.perf_counter() - t0) * 1e3,
                                "loss": float(met["loss"]),
                                "ce": float(met["ce"]),
                                "grad_norm": float(met["grad_norm"])})
            return out[0]
        self.cls.train_step = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.inner

    def timing(self, batch, seq, skip=1) -> dict:
        """Every step's ms, and the median and tokens/s over the steps
        from ``skip`` on but the profiled one."""
        ms = [s["ms"] for s in self.steps
              if s["step"] >= skip and s["step"] != self.profile_step]
        med = statistics.median(ms)
        return {"step_ms": [s["ms"] for s in self.steps],
                "median_step_ms": med,
                "tokens_per_s": batch * seq / (med / 1e3)}


def bf16_train(cfg, data, build_dir) -> dict:
    """``cfg`` in bfloat16 through ``train``.  Under deterministic
    algorithms: 6 steps checkpointed every 3, then a second call to 8
    steps from the initial weights and a fresh data state, which must
    resume at step 6 with the data state restored, then 8 uninterrupted
    steps from the same weights and data; the resumed weights must equal
    the uninterrupted ones to the bit.  Then the 8 uninterrupted steps
    again with the defaults, timed (the resumed weights' share of equal
    elements against these is printed, not held).  The peak memory counts
    what the card held before (``held_bytes``)."""
    import copy
    from repro_torch.models.model import build
    from repro_torch.train.train_loop import train
    B, S = TRAIN_BF16["batch"], TRAIN_BF16["seq"]
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mdl = build(cfg.with_(dtype="bfloat16"), CARD,
                torch.Generator(device=CARD).manual_seed(0), training=True)
    init = {n: t.clone() for n, t in mdl.state_dict().items()}
    fresh = copy.deepcopy(data)
    start = fresh.step
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build_dir)
    lines = []

    def run(steps, data, ckpt_dir=None):
        mdl.load_state_dict(init)
        params, _, losses = train(mdl, data, steps=steps, ckpt_dir=ckpt_dir,
                                  ckpt_every=TRAIN_BF16["ckpt_every"],
                                  log_every=1, log=lines.append)
        return {n: p.detach().clone() for n, p in params.items()}, losses

    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        run(TRAIN_BF16["resume_at"], copy.deepcopy(fresh), ckpt)
        first_s = time.perf_counter() - t0
        ckpts = sorted(os.listdir(ckpt))
        # the resume reads the newest; the older one only takes disk
        shutil.rmtree(os.path.join(ckpt, ckpts[0]))
        resumed_data = copy.deepcopy(fresh)
        t0 = time.perf_counter()
        resumed, _ = run(TRAIN_BF16["steps"], resumed_data, ckpt)
        resume_s = time.perf_counter() - t0
        ckpts += sorted(os.listdir(ckpt))
        whole, _ = run(TRAIN_BF16["steps"], copy.deepcopy(fresh))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    with StepClock() as clock:
        timed_run, losses = run(TRAIN_BF16["steps"], copy.deepcopy(fresh))

    def equal_frac(got, want):
        return sum(int((got[n] == w).sum()) for n, w in want.items()) \
            / sum(w.numel() for w in want.values())
    first, last = losses[0][1], losses[-1][1]
    rec = {"config": {k: getattr(cfg, k) for k in CONFIG_KEYS},
           "params": sum(w.numel() for w in whole.values()), **TRAIN_BF16,
           **clock.timing(B, S), "losses": [l for _, l in losses],
           "done": f"[done] loss {first:.3f} -> {last:.3f} "
                   f"({'improved' if last < first else 'NO IMPROVEMENT'})",
           "resume_log": [ln for ln in lines if "resumed" in ln],
           "checkpoints": ckpts, "first_call_s": first_s,
           "resume_call_s": resume_s,
           "data_steps": [start, resumed_data.step],
           "resume_rms_rel_worst": worst(rel_errors(resumed, whole, init)),
           "resume_bit_equal_frac": equal_frac(resumed, whole),
           "resume_bit_equal_frac_default": equal_frac(resumed, timed_run),
           "held_bytes": held,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    rec["ok"] = (rec["resume_log"] == [
        f"[train] resumed from step {TRAIN_BF16['resume_at']}"]
        and resumed_data.step == start + TRAIN_BF16["steps"]
        and all(torch.equal(resumed[n], w) for n, w in whole.items())
        and all(np.isfinite(rec["losses"])))
    del mdl, resumed, whole, timed_run, init
    torch.cuda.empty_cache()
    log(f"[train] kb_lm bfloat16 {json.dumps(rec)}")
    log(rec["done"])
    return rec


def walk_step(fn, arguments) -> dict:
    """One step ``fn()`` on the card under the cost walk
    (``repro_torch.analysis.cost.walk``): counted FLOPs (matrix products
    apart), bytes, ops and memory, the roofline terms of those counts,
    and the step's own wall ms (the walk's host work included)."""
    from repro_torch.analysis import cost
    from repro_torch.analysis import roofline as RL
    sync()
    t0 = time.perf_counter()
    _, rec = cost.walk(fn, arguments)
    sync()
    wall = time.perf_counter() - t0
    return {"flops": rec["flops"], "dot_flops": rec["dot_flops"],
            "bytes": rec["bytes"], "ops": rec["ops"],
            "memory": rec["memory"],
            "compute_ms": rec["flops"] / RL.PEAK_FLOPS * 1e3,
            "memory_ms": rec["bytes"] / RL.HBM_BW * 1e3,
            "walked_step_ms": wall * 1e3}


def zamba_whole() -> dict:
    """``zamba2_1p2b``'s ``CONFIG`` whole (38 layers, microbatches 2,
    remat full, bfloat16) through ``repro_torch.launch.train.main`` at 8 x
    2048 for 4 steps; every loss and gradient norm finite, the step-0 loss
    within ``LN_VOCAB_TOL`` of what random weights give: the final norm
    leaves h at unit rms, so each logit is normal with variance s^2 =
    d_model x ``INIT_STD``^2 (0.82) and the cross-entropy of a random
    label is ln(V) + s^2 / 2 (10.78, not ln(32000) = 10.37: the logits
    are not uniform); times, peak memory, one profiled step (the last)
    and model FLOP/s (``roofline.model_flops_estimate``: 6 N tokens, N
    the active parameters) against the bf16 peak.  Then one more step
    under the cost walk (``step_count``: counted FLOPs, bytes and memory,
    for phase 16)."""
    import math
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import train as launch
    cfg = get_config("zamba2_1p2b")
    B, S = 8, 2048
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepClock(profile_step=3) as clock:
        launch.main(ZAMBA_ARGS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = cfg.param_counts()
    tm = clock.timing(B, S)
    shape = ShapeConfig("zamba2_whole", S, B, "train")
    flops = RL.model_flops_estimate(cfg, shape) / (tm["median_step_ms"] / 1e3)
    mdl, opt, batch, step = clock.last
    clock.last = None
    params = dict(mdl.named_parameters())
    step_count = walk_step(lambda: (params, *mdl.train_step(
        opt, batch, step + 1)), (params, opt, batch))
    del mdl, opt, batch, params
    losses = [s["loss"] for s in clock.steps]
    norms = [s["grad_norm"] for s in clock.steps]
    ZAMBA_WHOLE.update(losses=losses, grad_norms=norms,
                       ces=[s["ce"] for s in clock.steps],
                       median_step_ms=tm["median_step_ms"])
    rec = {"params": counts["total"], "active_params": counts["active"],
           "batch": B, "seq": S, "microbatches":
           cfg.microbatches, "remat": cfg.remat, **tm, "losses": losses,
           "grad_norms": norms, "ln_vocab": math.log(cfg.vocab_size),
           "expected_step0_loss": math.log(cfg.vocab_size)
           + cfg.d_model * INIT_STD ** 2 / 2,
           "call_s": wall, "held_bytes": held, "peak_bytes": peak,
           "profiled_step": clock.profile,
           "model_flops_per_s": flops,
           "bf16_peak_share": flops / RL.PEAK_FLOPS,
           "step_count": step_count,
           "card": torch.cuda.get_device_name(0)}
    rec["ok"] = len(losses) == 4 and all(np.isfinite(losses + norms)) and \
        abs(losses[0] - rec["expected_step0_loss"]) <= LN_VOCAB_TOL
    torch.cuda.empty_cache()
    log(f"[train] zamba2_1p2b {json.dumps(rec)}")
    return rec


def cpu_job(fn, mdl, *args):
    """``timed(fn, mdl, *args)`` on this thread with ``CPU_JOB_THREADS``
    intra-op threads, leaving cores to the card's host work and the
    checkpoint writer."""
    torch.set_num_threads(CPU_JOB_THREADS)
    return timed(fn, mdl, *args)


def train_phase(facts, lubm_nfacts, lubm_stats, tokens_12):
    """Phase 15.  (a) Phase 12's KB materialized and linearized again
    (every kernel must launch, the tokens equal phase 12's).  (b)
    ``lm_100m`` at the linearizer's vocabulary, full width and depth: two
    float32 ``train_step``s on the card and on the CPU from the same
    weights and batches (2 x 256 of the KB's tokens): loss, ce, grad_norm
    and lr, every gradient and the weights after within their bounds,
    with two planted faults above them; then in bfloat16 through
    ``train`` with checkpoints (``bf16_train``).  (c) ``zamba2_1p2b``
    whole through the launcher (``zamba_whole``).  (d) 2-layer float32
    copies at full width, card against CPU: one ``train_step`` of zamba2
    with the shared block after every 2nd layer (2 x 1040: four SSD
    chunks and a part); ``stablelm_12b`` with ``flash_vjp`` over 2 x 1040
    (two attention chunks; loss and gradients), also against the same
    copy without it; ``falcon_mamba_7b``'s loss and gradients over 2 x 520
    (the Mamba-1 scan's backward), with a fault planted in its adjoint.
    Each model is copied to the host and queued on a background thread
    (``cpu_job``) before the card's float32 steps, which keep their
    records on the card; the CPU works while the card runs the rest of
    (d), (b)'s bfloat16 part and (c), and then phase 17.
    Returns the comparisons as a callable (``_train_compare``), which waits
    for the CPU and returns the ``train`` record and (a)'s kernel
    launches."""
    import copy
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops as KO
    from repro_torch.models import ssm
    from repro_torch.models.model import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (a) the KB's tokens
    KO.reset_launch_counts()
    tokens, data, kb_rec = kb_tokens(facts, lubm_nfacts, lubm_stats)
    launches = KO.launch_counts()
    if not torch.equal(tokens, tokens_12):
        fail("train: the KB's tokens differ from phase 12's")
    out = {"kb": kb_rec}
    cfg = lm_100m(data.vocab_size)
    pool = ThreadPoolExecutor(max_workers=1)

    def card_model(c):
        return build(c, CARD, torch.Generator(device=CARD).manual_seed(0),
                     training=True)

    # (b), (d): copies on the host for the CPU's sides, each queued on the
    # CPU's thread at once, and the card's float32 steps (each record kept
    # on the card)
    jobs = []

    def on_cpu(fn, mdl, *args):
        jobs.append(pool.submit(cpu_job, fn, copy.deepcopy(mdl).to("cpu"),
                                *args))
    f32 = cfg.with_(dtype="float32")
    mdl = card_model(f32)
    init = {n: t.clone() for n, t in mdl.state_dict().items()}
    batches = kb_batches(copy.deepcopy(data), TRAIN_F32["steps"],
                         TRAIN_F32["batch"])
    on_cpu(f32_steps, mdl, batches)
    lm, lm_s = timed(f32_steps, mdl, batches)
    faults = {}
    for name, (module, attr, part, _, _) in TRAIN_FAULTS.items():
        with Patched(sys.modules[module], attr, fault_value(name)):
            faults[name] = f32_steps(mdl, batches, init, part == "grads",
                                     part == "after")
    del mdl

    zcfg = get_config("zamba2_1p2b").with_(num_layers=2, hybrid_attn_every=2,
                                           dtype="float32")
    scfg = get_config("stablelm_12b").with_(num_layers=2, dtype="float32",
                                            microbatches=1)
    fcfg = get_config("falcon_mamba_7b").with_(num_layers=2, dtype="float32")
    tok = torch.randint(0, min(c.vocab_size for c in (zcfg, scfg, fcfg)),
                        (TRAIN_2L["batch"], TRAIN_2L["seq"] + 1),
                        generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok[:, :-1].numpy(), "labels": tok[:, 1:].numpy()}
    fbatch = {k: v[:, :TRAIN_2L["falcon_seq"]] for k, v in batch.items()}
    zmdl = card_model(zcfg)
    zinit = {n: t.clone() for n, t in zmdl.state_dict().items()}
    on_cpu(f32_steps, zmdl, [batch])
    zamba, zamba_s = timed(f32_steps, zmdl, [batch])
    del zmdl
    smdl = card_model(scfg.with_(flash_vjp=True))
    sinit = {n: t.clone() for n, t in smdl.state_dict().items()}
    on_cpu(loss_and_grads, smdl, batch)
    vjp, vjp_s = timed(f32_steps, smdl, [batch], None, True, False)
    smdl.cfg = scfg
    plain = f32_steps(smdl, [batch], sinit, True, False)
    vjp_vs_flash = {**held_f32(vjp, plain), "card_s": vjp_s}
    del smdl, sinit, plain
    torch.cuda.empty_cache()
    # falcon's Mamba-1 scan under autograd (``_DiagScan``): loss and
    # gradients, the peak above what the card held, and a fault planted in
    # the adjoint (its carry dropped: g_t = dL/dh_t)
    fmdl = card_model(fcfg)
    on_cpu(loss_and_grads, fmdl, fbatch)
    f_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    falcon, falcon_s = timed(loss_and_grads, fmdl, fbatch)
    f_peak = torch.cuda.max_memory_allocated() - f_held
    with Patched(ssm, "_adjoint", lambda a, gh, chunk: gh):
        falcon_fault = loss_and_grads(fmdl, fbatch)
    del fmdl
    torch.cuda.empty_cache()

    # (b) bfloat16 through train(), (c) zamba2 whole, while the CPU works
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out["kb_lm_bfloat16"] = bf16_train(cfg, copy.deepcopy(data),
                                       os.path.join(HERE, "build"))
    out["zamba2_1p2b"] = zamba_whole()
    return functools.partial(
        _train_compare, out, launches, jobs, pool, f32, init, lm, lm_s,
        faults, zamba, zamba_s, zinit, falcon, falcon_s, f_peak,
        falcon_fault, vjp, vjp_vs_flash)


def _train_compare(out, launches, jobs, pool, f32, init, lm, lm_s, faults,
                   zamba, zamba_s, zinit, falcon, falcon_s, f_peak,
                   falcon_fault, vjp, vjp_vs_flash):
    """Phase 15's end, once its CPU thread is done: the CPU's records, and
    every comparison.  Returns the ``train`` record and the kernel
    launches of phase 15's KB."""
    t0 = time.perf_counter()
    (lm_cpu, lm_cpu_s), (z_cpu, z_cpu_s), (s_cpu, s_cpu_s), \
        (f_cpu, f_cpu_s) = (job.result() for job in jobs)
    torch.set_num_threads(os.cpu_count() or 1)
    pool.shutdown()
    out["cpu_wait_s"] = time.perf_counter() - t0
    rec = {"config": {k: getattr(f32, k) for k in CONFIG_KEYS},
           "params": sum(t.numel() for t in init.values()), **TRAIN_F32,
           "card_s": lm_s, "cpu_s": lm_cpu_s, **held_f32(lm, lm_cpu, init)}
    for name, (_, _, _, key, bound) in TRAIN_FAULTS.items():
        rec[f"fault_{name}"] = held_f32(faults[name], lm_cpu, init)[key]
        rec["ok"] = rec["ok"] and rec[f"fault_{name}"][1] > bound
    out["kb_lm_float32"] = rec
    out["zamba2_1p2b_2_layers"] = {
        "batch": TRAIN_2L["batch"], "seq": TRAIN_2L["seq"],
        "card_s": zamba_s, "cpu_s": z_cpu_s, **held_f32(zamba, z_cpu, zinit)}
    rec = {"batch": TRAIN_2L["batch"], "seq": TRAIN_2L["falcon_seq"],
           "card_s": falcon_s, "cpu_s": f_cpu_s, "peak_bytes": f_peak,
           **held_f32(falcon, f_cpu),
           "fault_adjoint_no_carry": held_f32(
               falcon_fault, f_cpu)["grad_rms_rel_worst"]}
    rec["ok"] = rec["ok"] and rec["fault_adjoint_no_carry"][1] > F32_GRAD_RMS
    out["falcon_mamba_7b_2_layers"] = rec
    out["stablelm_12b_2_layers_flash_vjp"] = {
        "batch": TRAIN_2L["batch"], "seq": TRAIN_2L["seq"],
        "card_vs_cpu": {**held_f32(vjp, s_cpu), "cpu_s": s_cpu_s},
        "card_vs_flash": vjp_vs_flash}
    out["compare_s"] = time.perf_counter() - t0 - out["cpu_wait_s"]
    del lm, lm_cpu, faults, init, zamba, z_cpu, zinit, vjp, s_cpu, \
        falcon, falcon_fault, f_cpu
    torch.cuda.empty_cache()
    for name in ("kb_lm_float32", "zamba2_1p2b_2_layers",
                 "falcon_mamba_7b_2_layers",
                 "stablelm_12b_2_layers_flash_vjp"):
        log(f"[train] {name} {json.dumps(out[name])}")
    checks = [out["kb_lm_float32"]["ok"], out["kb_lm_bfloat16"]["ok"],
              out["zamba2_1p2b"]["ok"], out["zamba2_1p2b_2_layers"]["ok"],
              out["falcon_mamba_7b_2_layers"]["ok"],
              out["stablelm_12b_2_layers_flash_vjp"]["card_vs_cpu"]["ok"],
              vjp_vs_flash["ok"]]
    if not all(checks):
        fail(f"train: {checks}")
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: the analysis layer
# ---------------------------------------------------------------------------
# phase 5's bounds as PERF.md's kernel table gives them (ms, 4 decimals):
# its largest shapes are fixed by the seeded data, so the counted bytes
# must come out as the hand formulas they replace did
PHASE5_BOUND_MS = {"bitonic_sort_tiles": 0.0200,
                   "bitonic_merge_pairs": 0.0200, "unique_mask": 0.0300,
                   "probe_sorted": 0.0002}
COUNT_KEYS = ("flops", "dot_flops", "bytes", "sorts", "kernels", "coll",
              "coll_count")


def fused_program_counts(kbs, rec) -> dict:
    """Phase 16's part of phase 9: ``lower_fused_programs`` on LUBM-L's
    warm fused KBs, the card's and the CPU's, from the same capacity memo;
    the counts must be equal and the memo untouched.  Each program's
    memory term (counted bytes over ``roofline.HBM_BW``) beside the
    profiled warm run's busy time."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.engine import plan
    from repro_torch.engine.fused import lower_fused_programs
    memo = dict(plan._CAP_MEMO)
    t0 = time.perf_counter()
    card = lower_fused_programs(kbs[0])
    sync()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = lower_fused_programs(kbs[1])
    t_cpu = time.perf_counter() - t0
    if plan._CAP_MEMO != memo:
        fail("lower_fused_programs changed the capacity memo")
    if set(card) != {"round", "fixpoint"} or any(
            {k: card[n][k] for k in COUNT_KEYS}
            != {k: cpu[n][k] for k in COUNT_KEYS} for n in card):
        fail(f"lower_fused_programs: card {card} vs cpu {cpu}")
    prof = rec["profiled_warm"]
    out = {"programs": {n: {"flops": c["flops"], "bytes": c["bytes"],
                            "sort_ops_static": c["sort_ops_static"],
                            "trip_count": c["trip_count"],
                            "kernels": c["kernels"],
                            "memory_ms": c["bytes"] / RL.HBM_BW * 1e3,
                            "compute_ms": c["flops"] / RL.PEAK_FLOPS * 1e3}
                        for n, c in card.items()},
           "equal_card_cpu": True, "count_card_s": t_card,
           "count_cpu_s": t_cpu,
           "warm_rounds": rec["warm"]["rounds"],
           "profiled_warm_wall_ms": prof["wall_ms"],
           "profiled_warm_busy_ms": prof["device_busy_ms"]}
    log(f"[analysis] lubm_l fused programs {json.dumps(out)}")
    return out


def op_roofline_both(largest) -> dict:
    """``engine_op_roofline`` at phase 5's largest shapes (the sort's n at
    arity 1, which reaches the sort kernel; the unique mask's rows), on the
    card and on the CPU; every count must be equal."""
    from repro_torch.analysis import roofline as RL
    from repro_torch.engine.relation import numpy_dtype
    keys = largest["bitonic_sort_tiles"][1][0]
    rows = largest["unique_mask"][1][0]
    out = {}
    for n, arity, dt in ((keys.numel(), 1, keys.dtype),
                         (rows.shape[0], rows.shape[1], rows.dtype)):
        got = {d: RL.engine_op_roofline(n, arity, numpy_dtype(dt), device=d)
               for d in ("cuda", "cpu")}
        if got["cuda"] != got["cpu"]:
            fail(f"engine_op_roofline({n}, {arity}): card {got['cuda']} "
                 f"vs cpu {got['cpu']}")
        out[f"{n}x{arity}"] = {
            op: {**{k: got["cuda"][op][k] for k in ("flops", "bytes",
                                                     "bytes_per_fact")},
                 "memory_ms": got["cuda"][op]["bytes"] / RL.HBM_BW * 1e3}
            for op in ("sort", "probe", "absorb")}
    return out


def analysis_phase(largest, rows, fused_counts, served, trained,
                   smi) -> dict:
    """Phase 16: the engine's unit costs card against CPU, phase 5's
    bounds as counted, phase 9's fused counts, and the counted steps of
    phases 12 and 15 beside their measured ones."""
    from repro_torch.analysis import roofline as RL
    bounds = {r["name"]: r["bound_ms"] for r in rows if r["name"] in
              PHASE5_BOUND_MS}
    if {k: round(v, 4) for k, v in bounds.items()} != PHASE5_BOUND_MS:
        fail(f"phase 5's counted bounds {bounds} are not PERF.md's "
             f"{PHASE5_BOUND_MS}")
    zamba = trained["zamba2_1p2b"]
    z = zamba["step_count"]
    stable = served["stablelm_12b"]
    d = stable["decode_step_count"]
    for name, c in (("zamba2_1p2b train step", z),
                    ("stablelm_12b decode step", d)):
        if not (c["dot_flops"] > 0 and c["bytes"] > 0
                and c["memory"]["argument_bytes"] > 0
                and np.isfinite([c["flops"], c["bytes"]]).all()):
            fail(f"{name}: counted {c}")
    out = {"card": smi,
           "constants": {"PEAK_FLOPS": RL.PEAK_FLOPS, "HBM_BW": RL.HBM_BW,
                         "LINK_BW": RL.LINK_BW},
           "engine_op_roofline": op_roofline_both(largest),
           "phase5_bound_ms": bounds,
           "fused_programs_lubm_l": fused_counts,
           "zamba2_train_step": {
               "counted": z, "median_step_ms": zamba["median_step_ms"],
               "profiled_busy_ms": zamba["profiled_step"]["device_busy_ms"],
               "peak_bytes": zamba["peak_bytes"],
               "held_bytes": zamba["held_bytes"],
               "model_flops_per_s": zamba["model_flops_per_s"],
               "bf16_peak_share": zamba["bf16_peak_share"]},
           "stablelm_12b_decode_step": {
               "counted": d,
               "median_step_ms": stable["decode_ms_per_token"],
               "profiled_busy_ms":
                   stable["decode_step_profile"]["device_busy_ms"],
               "peak_bytes": stable["peak_bytes"]}}
    return out


# ---------------------------------------------------------------------------
# phase 17: serving on a mesh
# ---------------------------------------------------------------------------
# 2-layer float32 copies at full width (phases 12-13's), served as thread
# ranks on the card, each against the same weights without a mesh: (name,
# config overrides, meshes).  deepseek's copy is its first two layers, MLA
# with the dense FFN (its MoE layer is 45 GB in float32; qwen3's copy
# holds the MoE path).  The a2a dispatch changes which assignments
# overflow (capacity per share), so it runs at capacity factor E / k, where
# none do; psum keeps the whole batch's capacity and ranks, so its copy
# keeps the config's
MESH_2L = [("stablelm_12b", {}, ((1, 2), (1, 4))),
           ("qwen3_moe_30b_a3b", {"moe_dispatch": "psum"}, ((1, 2), (1, 4))),
           ("qwen3_moe_30b_a3b", {"moe_dispatch": "a2a",
                                  "capacity_factor": 16.0},
            ((1, 2), (1, 4), (2, 2))),
           ("deepseek_v3_671b", {"num_dense_layers": 2}, ((1, 2), (1, 4)))]
MESH_FAULT_AT = ("stablelm_12b", (1, 4))


def merge_without_max(m, l, o, mcx):
    """A planted fault: each rank's sums added as if its own row max were
    the global one."""
    return mcx.all_reduce(l), mcx.all_reduce(o)


def write_outside_chunk(cache, new, pos, lo=0):
    """A planted fault: every rank writes the new row, at ``pos`` clipped
    into its own chunk."""
    cache[:, min(max(pos - lo, 0), cache.shape[1] - 1)] = new


MESH_FAULTS = {"merge_without_max": ("merge_over_ranks", merge_without_max),
               "write_outside_chunk": ("write_row", write_outside_chunk)}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rms_rel(got, want) -> float:
    """rms(got - want) / rms(want) over the finite entries of ``want`` (the
    padded vocabulary rows are -1e30 in both)."""
    keep = want > -1e29
    return rms(got[keep] - want[keep]) / rms(want[keep])


def mesh_against_plain(name, cfg, meshes, tokens, gen, faults=None):
    """``cfg`` on the card without a mesh, then as thread ranks on each of
    ``meshes`` from the same weights (seed 0), fed the plain run's tokens:
    every rank's greedy tokens (its rows) equal, its logits at every step
    and its chunk of every cache after the last step within ``F32_RMS`` in
    rms.  ``faults``: planted faults run on the first mesh, each of which
    must read above ``F32_RMS``.  Returns the record."""
    import threading
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build
    keep = tuple(range(gen + 1))
    mdl = build(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
    t0 = time.perf_counter()
    plain = serve_run(mdl, tokens, gen, keep=keep)
    plain_s = time.perf_counter() - t0
    plain["caches"] = {k: v.cpu() for k, v in plain.pop("caches").items()}
    del mdl
    torch.cuda.empty_cache()

    building = threading.Lock()

    def rank(mcx):
        # one rank builds at a time: each draws every weight whole (the
        # embedding of a 2-layer copy is most of it) before keeping its part
        with building:
            m = build(cfg, "cuda", torch.Generator(
                device="cuda").manual_seed(0), mesh=mcx)
        run = serve_run(m, tokens, gen, feed=plain["tokens"][:, :-1],
                        keep=keep)
        run["caches"] = {k: v.cpu() for k, v in run["caches"].items()}
        return run

    def held(dp, tp, runs):
        worst, bad = 0.0, 0
        B = tokens.shape[0]
        for r, run in enumerate(runs):
            d, m = divmod(r, tp)
            rows = slice(d * B // dp, (d + 1) * B // dp) if B % dp == 0 \
                else slice(0, B)
            bad += int((run["tokens"] != plain["tokens"][rows]).sum())
            for t in keep:
                worst = max(worst, rms_rel(run["logits"][t],
                                           plain["logits"][t][rows]))
            for k, c in run["caches"].items():
                whole = plain["caches"][k][:, rows]
                n = c.shape[2]
                worst = max(worst, rms_rel(
                    c[:, :, :min(n, whole.shape[2] - m * n)],
                    whole[:, :, m * n:(m + 1) * n]))
        return worst, bad

    rec = {"plain_s": plain_s, "meshes": {}}
    for dp, tp in meshes:
        t0 = time.perf_counter()
        runs = make_host_mesh(dp, tp).run(rank)
        secs = time.perf_counter() - t0
        worst, bad = held(dp, tp, runs)
        rec["meshes"][f"{dp}x{tp}"] = {
            "rms_rel_err_worst": worst, "token_mismatches": bad,
            "thread_ranks_s": secs,
            "prefill_ms_rank0": runs[0]["prefill_s"] * 1e3,
            "decode_ms_rank0": statistics.median(runs[0]["step_s"]) * 1e3}
        del runs
        torch.cuda.empty_cache()
    for fault in faults or ():
        attr, value = MESH_FAULTS[fault]
        dp, tp = meshes[-1]
        with Patched(layers, attr, value):
            runs = make_host_mesh(dp, tp).run(rank)
        rec[f"fault_{fault}_rms_rel_err"], _ = held(dp, tp, runs)
        del runs
        torch.cuda.empty_cache()
    rec["ok"] = all(v["rms_rel_err_worst"] <= F32_RMS
                    and v["token_mismatches"] == 0
                    for v in rec["meshes"].values()) and all(
        rec[f"fault_{f}_rms_rel_err"] > F32_RMS for f in faults or ())
    log(f"[mesh] {name} {json.dumps(rec)}")
    return rec


def world_one_full_width(full_run) -> dict:
    """(i) ``stablelm_12b``'s ``CONFIG`` at full width and depth in
    bfloat16 through the process path: an in-process NCCL world of one
    (``torch.distributed`` over tcp://localhost), its ``MeshCtx`` from
    ``make_process_mesh``, phase 12's weights (seed 0) and prompts (seed
    1), 8 x 2048 + 64 greedy tokens on padded caches.  Its tokens must be
    phase 12's, its logits (prefill's and the first step's) within
    ``BF16_REL`` of phase 12's in rms."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.models.model import build
    cfg = get_config("stablelm_12b")
    B, S, gen = FULL["batch"], FULL["prompt"], FULL["gen"]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mcx = MESH.make_mesh_ctx(MESH.make_process_mesh())
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        mdl = build(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0),
                    mesh=mcx)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(1))
        mdl.prefill({"tokens": tokens})          # warm
        run = serve_run(mdl, tokens, gen, keep=(0, 1))
        del mdl, tokens
        run.pop("caches")
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rels = [rms_rel(run["logits"][t], full_run["logits"][t]) for t in (0, 1)]
    rec = {**FULL, "mesh": [1, 1], "backend": "nccl",
           "token_mismatches": int((run["tokens"]
                                    != full_run["tokens"]).sum()),
           "logits_rms_rel_err": rels, "tol_rms_rel": BF16_REL,
           "finite": run["finite"], **timing(run, B),
           "held_before_bytes": held_before,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    rec["ok"] = rec["token_mismatches"] == 0 and run["finite"] and \
        max(rels) <= BF16_REL
    log(f"[mesh] stablelm_12b world 1 {json.dumps(rec)}")
    return rec


def start_torchrun(args, nproc, out_dir):
    """``torchrun --standalone --nproc-per-node=nproc`` of ``args`` (a
    module's or a script's), started in the background with the
    repository's ``src`` on the path, its output in ``out_dir``.  Returns
    the handle for ``end_torchrun``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = open(os.path.join(out_dir, "torchrun.log"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                             "--standalone", f"--nproc-per-node={nproc}",
                             *args], cwd=HERE, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter(), args


def end_torchrun(handle, timeout=900):
    """Waits for a ``start_torchrun`` run; fails unless it exits 0.
    Returns (its output, its seconds)."""
    proc, out, t0, args = handle
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
    secs = time.perf_counter() - t0
    with open(out.name) as f:
        text = f.read()
    if proc.returncode:
        fail(f"torchrun {' '.join(args)}: exit {proc.returncode}\n"
             f"{text[-4000:]}")
    return text, secs


def start_launcher(tmp):
    """(ii) started: ``launch/serve.py --smoke`` under ``torchrun`` with a
    process per card, in the background."""
    out = os.path.join(tmp, "serve_tokens.npy")
    return start_torchrun(["-m", "repro_torch.launch.serve", "--arch",
                           "stablelm_12b", "--smoke", "--out", out],
                          torch.cuda.device_count(), tmp), out


def launcher_check(started) -> dict:
    """(ii) ended: the launcher's tokens must equal the same run in this
    process (thread ranks on one card where there are several)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    handle, out = started
    n = torch.cuda.device_count()
    cfg = get_smoke_config("stablelm_12b")
    if n == 1:
        here = serve.serve(cfg, device="cuda")[0]
    else:
        here = make_host_mesh(1, n).run(
            lambda mcx: serve.serve(cfg, device="cuda", mesh=mcx)[0])[0]
    stdout, secs = end_torchrun(handle)
    got = np.load(out)
    rec = {"nproc": n, "torchrun_s": secs,
           "lines": [ln for ln in stdout.splitlines()
                     if ln.startswith("[serve]")],
           "token_mismatches": int((got != here).sum()),
           "tokens": list(got.shape)}
    rec["ok"] = rec["token_mismatches"] == 0
    log(f"[mesh] launcher {json.dumps(rec)}")
    return rec


def mesh_child(out_dir: str) -> int:
    """``torchrun ... chip_smoke.py --mesh-child DIR``: one rank of (i) at
    tp = the card count, fed phase 12's tokens (``DIR/feed.npy``); rank 0
    saves its tokens, kept logits and timing in DIR."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.models.model import build
    MESH.init_process_group()
    mcx = MESH.make_mesh_ctx(MESH.make_process_mesh())
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("stablelm_12b")
    torch.cuda.reset_peak_memory_stats()
    mdl = build(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                mesh=mcx)
    tokens = torch.randint(0, cfg.vocab_size, (FULL["batch"], FULL["prompt"]),
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(1))
    feed = torch.from_numpy(np.load(os.path.join(out_dir, "feed.npy")))
    mdl.prefill({"tokens": tokens})          # warm
    run = serve_run(mdl, tokens, FULL["gen"], feed=feed.to(dev),
                    keep=(0, 1))
    if mcx.rank == 0:
        with open(os.path.join(out_dir, "timing.json"), "w") as f:
            json.dump({**timing(run, FULL["batch"]),
                       "peak_bytes_rank0": torch.cuda.max_memory_allocated()},
                      f)
        np.save(os.path.join(out_dir, "tokens.npy"), run["tokens"].numpy())
        for t in (0, 1):
            np.save(os.path.join(out_dir, f"logits{t}.npy"),
                    run["logits"][t].numpy())
    dist.destroy_process_group()
    return 0


def several_cards(full_run, tmp) -> dict:
    """(i) at tp = the card count, one process per card over NCCL
    (``mesh_child``), fed phase 12's tokens: logits within ``BF16_REL`` of
    phase 12's in rms.  The greedy tokens that differ are counted, not
    held: bfloat16 partial sums added in another order (each rank's
    rounded before the all-reduce) move the logits by about 0.07 in rms
    on 4 cards, and a token whose top-2 margin is below that flips."""
    n = torch.cuda.device_count()
    np.save(os.path.join(tmp, "feed.npy"),
            full_run["tokens"][:, :-1].numpy())
    _, secs = end_torchrun(start_torchrun(
        [os.path.join(HERE, "chip_smoke.py"), "--mesh-child", tmp], n, tmp))
    got = torch.from_numpy(np.load(os.path.join(tmp, "tokens.npy")))
    sure = full_run["margins"] > 0.05
    rels = [rms_rel(torch.from_numpy(np.load(os.path.join(
        tmp, f"logits{t}.npy"))), full_run["logits"][t]) for t in (0, 1)]
    with open(os.path.join(tmp, "timing.json")) as f:
        timed_run = json.load(f)
    rec = {"tp": n, "torchrun_s": secs, "logits_rms_rel_err": rels,
           "tol_rms_rel": BF16_REL, "token_mismatches_margin_above_0.05":
           int((got[sure] != full_run["tokens"][sure]).sum()),
           "tokens_compared": int(sure.sum()), **timed_run}
    rec["ok"] = max(rels) <= BF16_REL
    log(f"[mesh] stablelm_12b tp {n} {json.dumps(rec)}")
    return rec


def mesh_phase(full_run) -> dict:
    """Phase 17.  (i) ``world_one_full_width``; (ii) ``launcher_check``;
    (iii) the ``MESH_2L`` copies as thread ranks on the card
    (``mesh_against_plain``, 2 x 1040 + 4, float32, TF32 off), with the
    ``MESH_FAULTS`` planted at ``MESH_FAULT_AT``; where there are several
    cards, (i) again at tp = the card count (``several_cards``).  Returns
    the ``mesh`` record."""
    from repro_torch.configs.base import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_",
                           dir=os.path.join(HERE, "build"))
    out, launcher = {}, None
    try:
        launcher = start_launcher(tmp)         # beside (i) and (iii)
        out["world_one"] = world_one_full_width(full_run)
        shape = FULL_CPU
        out["thread_ranks"] = {}
        for name, overrides, meshes in MESH_2L:
            cfg = get_config(name).with_(num_layers=2, dtype="float32",
                                         **overrides)
            tokens = torch.randint(0, cfg.vocab_size,
                                   (shape["batch"], shape["prompt"]),
                                   device="cuda", generator=torch.Generator(
                                       device="cuda").manual_seed(2))
            faults = tuple(MESH_FAULTS) \
                if (name, meshes[-1]) == MESH_FAULT_AT else ()
            key = name + ("_" + overrides["moe_dispatch"]
                          if "moe_dispatch" in overrides else "")
            out["thread_ranks"][key] = {
                **shape, "overrides": overrides,
                **mesh_against_plain(key, cfg, meshes, tokens, shape["gen"],
                                     faults)}
        out["launcher"] = launcher_check(launcher)
        n = torch.cuda.device_count()
        if n >= 2:
            out["several_cards"] = several_cards(full_run, tmp)
        else:
            out["several_cards"] = f"the card count was {n}"
            log(f"[mesh] the card count was {n}: (i) at one card only")
    finally:
        if launcher is not None and launcher[0][0].poll() is None:
            launcher[0][0].kill()
            launcher[0][0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {k: out[k]["ok"] for k in ("world_one", "launcher")}
    checks.update({k: v["ok"] for k, v in out["thread_ranks"].items()})
    if isinstance(out["several_cards"], dict):
        checks["several_cards"] = out["several_cards"]["ok"]
    if not all(checks.values()):
        fail(f"mesh: {checks}")
    return out


# ---------------------------------------------------------------------------
# phase 18: training on a mesh
# ---------------------------------------------------------------------------
ZAMBA_WHOLE: dict = {}   # phase 15's zamba2_1p2b steps (phase 18's (i)
                         # holds to them)
MESH_TRAIN_SEQ = 520     # 2 x 520 tokens: TRAIN_2L's falcon length
MESH_TRAIN_WORLD = 4     # processes sharing the card over gloo
INT8_SCALE_REL = 1e-5    # each leaf's int8 scale against the plain run's
                         # whole-tensor max, relative (float32 rounding of
                         # the delta moves it by about 1e-7)
# (key, arch, overrides, (dp, tp)): 2-layer float32 copies at full width,
# one train_step each against the same weights without a mesh.  qwen3's
# a2a at capacity factor E / k (nothing drops: the one device keeps every
# assignment too); deepseek's two dense MLA layers without the MTP head
# (one more MoE layer, 45 GB in float32).  The plain run goes first; its
# records wait for the ranks' results on the card, or in host memory
# where they pass ``HOST_RECORDS_SHARE`` of the card (deepseek's, 24 GB:
# with the ranks' results, as large again, and the ranks' step they
# would not fit)
HOST_RECORDS_SHARE = 0.25
MESH_TRAIN_2L = [
    ("stablelm_12b_1x2", "stablelm_12b", {}, (1, 2)),
    ("falcon_mamba_7b_1x2", "falcon_mamba_7b", {}, (1, 2)),
    ("zamba2_1p2b_1x2", "zamba2_1p2b", {"hybrid_attn_every": 2}, (1, 2)),
    ("stablelm_12b_2x2", "stablelm_12b", {}, (2, 2)),
    ("qwen3_moe_30b_a3b_a2a_2x2", "qwen3_moe_30b_a3b",
     {"moe_dispatch": "a2a", "capacity_factor": 16.0}, (2, 2)),
    ("deepseek_v3_671b_mla_fsdp_2x2", "deepseek_v3_671b",
     {"num_dense_layers": 2, "mtp_depth": 0, "fsdp": True}, (2, 2)),
    ("zamba2_1p2b_2x2_grad_compress", "zamba2_1p2b",
     {"hybrid_attn_every": 2, "grad_compress": True}, (2, 2)),
]
# fault: (the case it is planted in, the record's key that must read above
# its bound, the bound)
MESH_TRAIN_FAULTS = {
    # the all-reduce of a row-parallel output summing its gradient over
    # "model" too: every gradient before it doubles
    "sum_reduce_backward_sums": ("zamba2_1p2b_1x2", "grad_rms_rel_worst",
                                 F32_GRAD_RMS),
    # each data rank writes its own ZeRO-1 shard of the new weights only
    "zero1_update_not_gathered": ("zamba2_1p2b_2x2_grad_compress",
                                  "update_rms_rel_worst", F32_UPDATE_RMS),
    # the int8 scale from the rank's shard, not the whole tensor
    "int8_scale_of_the_shard": ("zamba2_1p2b_2x2_grad_compress",
                                "int8_scale_rel_worst", INT8_SCALE_REL),
}


def mesh_train_config(arch, overrides):
    from repro_torch.configs.base import get_config
    return get_config(arch).with_(num_layers=2, dtype="float32",
                                  microbatches=1, **overrides)


def mesh_train_batch() -> dict:
    """2 x 520 tokens below every copy's vocabulary (numpy)."""
    from repro_torch.configs.base import get_config
    vocab = min(get_config(a).vocab_size for _, a, _, _ in MESH_TRAIN_2L)
    tok = torch.randint(0, vocab, (2, MESH_TRAIN_SEQ + 1),
                        generator=torch.Generator().manual_seed(2))
    return {"tokens": tok[:, :-1].numpy(), "labels": tok[:, 1:].numpy()}


class StepRecord:
    """While entered on this thread: the gradients each
    ``optimizer.apply_updates`` is given (on a mesh the rank's ZeRO-1
    shards, summed over "data") and each int8 scale's max, in leaf order;
    calls from other threads pass through."""

    def __enter__(self):
        import threading
        from repro_torch.train import optimizer as OPT
        owner, rec = threading.get_ident(), self
        self.grads, self.scales = None, []
        apply, quant = OPT.apply_updates, OPT._quantize_int8

        def recorded_apply(grads, *a, **k):
            if threading.get_ident() == owner:
                rec.grads = dict(grads)
            return apply(grads, *a, **k)

        def recorded_quant(x, amax=None):
            if threading.get_ident() == owner:
                rec.scales.append(float(x.abs().max() if amax is None
                                        else amax))
            return quant(x, amax)
        self.patches = [Patched(OPT, "apply_updates", recorded_apply),
                        Patched(OPT, "_quantize_int8", recorded_quant)]
        for p in self.patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)
        self.patches = None     # the wrappers hold this record: free both


def mesh_train_reference(cfg, batch) -> dict:
    """The plain run: ``cfg`` without a mesh on the card, one
    ``train_step``; its metrics, gradients and weights after (in host
    memory where they pass ``HOST_RECORDS_SHARE`` of the card) and per
    weight the sums of squares the errors are taken against."""
    from repro_torch.models.model import build
    torch.cuda.reset_peak_memory_stats()
    mdl = build(cfg, CARD, torch.Generator(device=CARD).manual_seed(0),
                training=True)
    b = {k: torch.from_numpy(v % cfg.vocab_size).to(CARD)
         for k, v in batch.items()}
    with StepRecord() as rec:
        opt, met = mdl.train_step(mdl.init_opt_state(), b, 0)
    del opt
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "scales": rec.scales, "grads": {}, "after": {},
           "g_ss": {}, "u_ss": {}, "numel": {},
           "peak_bytes": torch.cuda.max_memory_allocated()}
    size = sum(2 * p.numel() * p.element_size()
               for p in mdl.parameters())
    card_bytes = torch.cuda.get_device_properties(CARD).total_memory
    keep = "cpu" if size > HOST_RECORDS_SHARE * card_bytes else CARD
    out["records_on"] = keep
    for n, p in mdl.named_parameters():
        g = rec.grads.pop(n)
        out["g_ss"][n] = float(g.double().square().sum())
        out["grads"][n] = g.to(keep)
        out["after"][n] = p.detach().to(keep)
        out["numel"][n] = p.numel()
        del g
    del mdl, rec
    release_card()
    init = build(cfg, CARD, torch.Generator(device=CARD).manual_seed(0),
                 training=True)
    for n, p in init.named_parameters():
        out["u_ss"][n] = float((out["after"][n].to(CARD).float()
                                - p.detach().float()).double()
                               .square().sum())
    del init
    release_card()
    return out


def mesh_rank_step(mcx, task) -> dict:
    """One rank of a phase-18 case (a worker process): the copy on its
    mesh, one ``train_step`` with the task's fault planted; its metrics,
    reduced gradients and weights after (on the card, handed to the
    parent), specs and int8 scales."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.models.model import build
    from repro_torch.train import optimizer as OPT
    cfg = task.get("config") or mesh_train_config(task["arch"],
                                                  task["overrides"])
    batch = {k: torch.from_numpy(v % cfg.vocab_size).to(CARD)
             for k, v in task["batch"].items()}
    torch.cuda.reset_peak_memory_stats()
    mdl = build(cfg, CARD, torch.Generator(device=CARD).manual_seed(0),
                training=True, mesh=mcx)
    settle_weights(mdl)
    torch.cuda.reset_peak_memory_stats()
    faults = {
        "sum_reduce_backward_sums": (MESH._SumReduce, "backward",
                                     staticmethod(_summing_backward)),
        "zero1_update_not_gathered": (OPT, "_to_replica", _own_shard_only),
        "int8_scale_of_the_shard": (OPT, "_global_amax",
                                    lambda amax, layout: amax)}
    planted = Patched(*faults[task["fault"]]) if task["fault"] else None
    if planted:
        planted.__enter__()
    try:
        opt = mdl.init_opt_state()
        sync()
        t0 = time.perf_counter()
        with StepRecord() as rec:
            opt, met = mdl.train_step(opt, batch, 0)
        sync()
        step_s = time.perf_counter() - t0
    finally:
        if planted:
            planted.__exit__(None, None, None)
    lay = mdl._state_layout()
    del opt
    peak_reserved = torch.cuda.max_memory_reserved()
    release_card()                    # the plain run takes the card next
    if mcx is None:                   # a warm-up
        return None
    return {"metrics": {k: float(v) for k, v in met.items()},
            "after": {n: p.detach() for n, p in mdl.named_parameters()},
            "grads": rec.grads, "scales": rec.scales,
            "pspecs": mdl.param_specs(), "sspecs": lay.state_specs,
            "coords": (mcx.dp_size, mcx.tp_size, mcx.data_index,
                       mcx.model_index),
            "step_s": step_s, "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": peak_reserved}


def settle_weights(mdl) -> None:
    """The model's weights moved to the host and back, each into a segment
    of the card's cache of its own.  ``build`` draws each weight whole and
    keeps the rank's slice, so the slices and the optimizer state would
    otherwise split the segments the wholes were drawn in, whose
    remainders the step's larger buffers cannot use: four ranks of
    deepseek's copy leave the card a few GB."""
    with torch.no_grad():
        for p in mdl.parameters():
            p.data = p.data.cpu()
        release_card()
        for p in mdl.parameters():
            p.data = p.data.to(CARD)


def _summing_backward(ctx, g):
    """A planted fault: the all-reduce's backward sums over its axis."""
    return ctx.mcx._collective("all_reduce", g, ctx.axis, "sum"), None, None


def _own_shard_only(p, shard, dim, mcx):
    """A planted fault: the new ZeRO-1 shard written into the rank's own
    rows of its replica, the rest left as it was."""
    k = shard.shape[dim]
    p.narrow(dim, mcx.data_index * k, k).copy_(shard)


def mesh_train_worker(rank, port, tasks, results, acks):
    """A process of phase 18 (iii): rank ``rank`` of a gloo world of
    ``MESH_TRAIN_WORLD`` processes sharing the card, which holds the (2, 2)
    mesh and the (1, 2) mesh of processes 0 and 1.  Each task runs on its
    mesh's processes (``mesh_rank_step``); the result stays alive until
    the parent acknowledges it."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as MESH
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=MESH_TRAIN_WORLD, rank=rank)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_card_comm import CardComm
    comm = functools.partial(CardComm, device=CARD)
    meshes = {(1, 2): MESH.ProcessMesh(1, 2, (0, 1), comm=comm),
              (2, 2): MESH.ProcessMesh(2, 2, comm=comm)}
    # gloo connects a group at its first collective, and the card loads
    # a kernel at its first use: both before the first task
    one = torch.ones((8, 8), device=CARD)
    for mesh in meshes.values():
        if mesh.rank is not None:
            mcx = MESH.make_mesh_ctx(mesh)
            for axis in ("model", "data", ("data", "model")):
                mcx.all_reduce(one, axis)
    from repro_torch.configs.base import get_smoke_config
    mesh_rank_step(None, {"fault": None, "batch": mesh_train_batch(),
                          "config": get_smoke_config("stablelm_12b").with_(
                              dtype="float32")})
    sync()
    results.put((rank, "ready"))
    while True:
        task = tasks.get()
        if task is None:
            break
        mesh = meshes[task["mesh"]]
        if mesh.rank is None:
            continue
        try:
            out = mesh_rank_step(MESH.make_mesh_ctx(mesh), task)
        except Exception as e:            # noqa: BLE001 - reported
            import traceback
            results.put((rank, f"{e!r}\n{traceback.format_exc()}"))
            break
        results.put((rank, out))
        acks.get()
        del out
        gc.collect()
        torch.cuda.ipc_collect()
        release_card()
        results.put((rank, "freed"))
    dist.destroy_process_group()


class MeshTrainWorkers:
    """The ``MESH_TRAIN_WORLD`` worker processes (started with the
    ``spawn`` method; each takes the card), their task queues, the shared
    result queue and an acknowledgement queue each."""

    def __init__(self):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(MESH_TRAIN_WORLD)]
        self.acks = [ctx.Queue() for _ in range(MESH_TRAIN_WORLD)]
        self.results = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=mesh_train_worker, args=(
            r, port, self.tasks[r], self.results, self.acks[r]),
            daemon=True) for r in range(MESH_TRAIN_WORLD)]
        for p in self.procs:
            p.start()
        self.ready = False

    def _get(self, timeout=600):
        rank, out = self.results.get(timeout=timeout)
        if isinstance(out, str) and out not in ("ready", "freed"):
            fail(f"mesh train: rank {rank}: {out}")
        return rank, out

    def run(self, task) -> list:
        """The task on every process; the results of its mesh's ranks, in
        rank order (each to be acknowledged by ``done``)."""
        if not self.ready:
            for _ in self.procs:
                self._get()
            self.ready = True
        for q in self.tasks:
            q.put(task)
        n = task["mesh"][0] * task["mesh"][1]
        got = dict(self._get() for _ in range(n))
        return [got[r] for r in range(n)]

    def done(self, n) -> None:
        """The results of ranks 0 .. n - 1 released: each frees its
        memory on the card before the next task."""
        for r in range(n):
            self.acks[r].put(True)
        for _ in range(n):
            self._get()

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()


def mesh_train_held(cfg, ref, outs) -> dict:
    """The ranks' records against the plain run: loss, ce and grad_norm
    (every rank's equal), lr, every gradient and every weight after the
    step over the whole tensor (each element taken once, from the rank
    that counts it: ``ZeroLayout.counted``'s rule) as ``held_f32`` takes
    them, and the int8 scales."""
    import math
    from repro_torch.launch.mesh import MeshCtx
    from repro_torch.models.model import local_leaf
    rec = {}
    met = outs[0]["metrics"]
    rec["ranks_agree"] = all(o["metrics"] == met for o in outs)
    rec["metric_rel_max"] = max(
        abs(met[k] - ref["metrics"][k]) / abs(ref["metrics"][k])
        for k in ("loss", "ce", "grad_norm"))
    rec["lr_equal"] = met["lr"] == ref["metrics"]["lr"]

    def counted(spec, d, m):
        return ("model" in spec or m == 0) and ("data" in spec or d == 0)
    # each rank's part is cut from the plain run's record where it lies
    # (host memory or the card) and compared on the card: the ranks'
    # results wait there beside it
    sse = {"grads": {}, "after": {}}
    for n in ref["after"]:
        for part, specs in (("grads", "sspecs"), ("after", "pspecs")):
            total = 0.0
            for o in outs:
                dp, tp, d, m = o["coords"]
                spec = o[specs][n]
                if counted(spec, d, m):
                    mcx = MeshCtx(dp, tp, d, m, None)
                    want = local_leaf(n, ref[part][n], spec, cfg,
                                      mcx).to(CARD)
                    total += float(torch.sub(o[part][n].float(),
                                             want.float())
                                   .double().square_().sum())
                    del want
            sse[part][n] = total

    def worst_of(part, ss):
        scale = {n: math.sqrt(ss[n] / ref["numel"][n]) for n in ss}
        floor = ZERO_FLOOR * max(scale.values())
        errs = {n: math.sqrt(sse[part][n] / ref["numel"][n])
                / max(scale[n], floor, 1e-30) for n in ss}
        return worst(errs)
    rec["grad_rms_rel_worst"] = worst_of("grads", ref["g_ss"])
    rec["update_rms_rel_worst"] = worst_of("after", ref["u_ss"])
    if ref["scales"]:
        rec["int8_scale_rel_worst"] = max(
            abs(s - w) / w for o in outs for s, w in zip(o["scales"],
                                                         ref["scales"]))
    rec["ok"] = rec["ranks_agree"] and rec["lr_equal"] and \
        rec["metric_rel_max"] <= F32_METRIC_REL and \
        rec["grad_rms_rel_worst"][1] <= F32_GRAD_RMS and \
        rec["update_rms_rel_worst"][1] <= F32_UPDATE_RMS and \
        rec.get("int8_scale_rel_worst", 0.0) <= INT8_SCALE_REL
    rec["step_s_rank0"] = outs[0]["step_s"]
    rec["peak_bytes_rank0"] = outs[0]["peak_bytes"]
    rec["peak_reserved_bytes_max"] = max(o["peak_reserved_bytes"]
                                         for o in outs)
    return rec


def zamba_on_a_data_mesh() -> dict:
    """(i): ``zamba2_1p2b``'s ``CONFIG`` whole in bfloat16 (38 layers,
    microbatches 2, remat full) as two thread ranks at (2, 1) on the card
    (no collective runs inside its backward), ZeRO-1 over "data", from
    phase 15's weights (seed 0) and batches (``SyntheticTokens``, 8 x
    2048): two steps, each step's loss, ce and grad_norm within
    ``BF16_REL`` of phase 15's one-device steps; step ms (rank 0, the
    ranks share the card), tokens/s and the peak."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build
    cfg = get_config("zamba2_1p2b")
    B, S = 8, 2048
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def rank(mcx):
        mdl = build(cfg, CARD, torch.Generator(device=CARD).manual_seed(0),
                    training=True, mesh=mcx)
        data = SyntheticTokens(cfg.vocab_size, B, S)
        opt = mdl.init_opt_state()
        steps = []
        for step in range(2):
            batch = data.next()
            sync()
            t0 = time.perf_counter()
            opt, met = mdl.train_step(opt, batch, step)
            sync()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          **{k: float(v) for k, v in met.items()}})
        return steps
    runs = make_host_mesh(2, 1).run(rank)
    peak = torch.cuda.max_memory_allocated() - held
    want = ZAMBA_WHOLE
    rels = [abs(s[k] - want[key][i]) / abs(want[key][i])
            for i, s in enumerate(runs[0])
            for k, key in (("loss", "losses"), ("ce", "ces"),
                           ("grad_norm", "grad_norms"))]
    ms = [s["ms"] for s in runs[0]]
    rec = {"mesh": [2, 1], "batch": B, "seq": S,
           "microbatches": cfg.microbatches, "steps": runs[0],
           "one_device": {k: want[k][:2] for k in ("losses", "ces",
                                                   "grad_norms")},
           "metric_rel_max": max(rels), "tol_rel": BF16_REL,
           "step_ms": ms, "tokens_per_s": B * S / (ms[-1] / 1e3),
           "one_device_median_step_ms": want["median_step_ms"],
           "peak_bytes": peak, "held_bytes": held,
           "ranks_agree": runs[0] == [dict(s, ms=r["ms"]) for s, r in
                                      zip(runs[1], runs[0])]}
    rec["ok"] = rec["metric_rel_max"] <= BF16_REL and all(
        np.isfinite([s[k] for s in runs[0] for k in ("loss", "grad_norm")]))
    torch.cuda.empty_cache()
    log(f"[mesh_train] zamba2_1p2b (2, 1) {json.dumps(rec)}")
    return rec


def start_train_launcher(tmp):
    """(ii) started: ``launch/train.py --smoke`` under ``torchrun`` with a
    process per card (NCCL), 3 steps of 8 x 256, in the background."""
    out = os.path.join(tmp, "train_losses.npy")
    return start_torchrun(["-m", "repro_torch.launch.train", "--arch",
                           "stablelm_12b", "--smoke", "--steps", "3",
                           "--out", out],
                          torch.cuda.device_count(), tmp), out


def train_launcher_check(started) -> dict:
    """(ii) ended: the launcher's losses finite and equal to the same run
    in this process (on one card a world of one, which trains as no mesh
    to the bit)."""
    from repro_torch.launch import train as launch
    handle, out = started
    here = out + ".here.npy"
    launch.main(["--arch", "stablelm_12b", "--smoke", "--steps", "3",
                 "--out", here])
    stdout, secs = end_torchrun(handle)
    got, want = np.load(out), np.load(here)
    rec = {"nproc": torch.cuda.device_count(), "torchrun_s": secs,
           "lines": [ln for ln in stdout.splitlines()
                     if ln.startswith(("[launch]", "[train]"))],
           "losses": got[:, 1].tolist(), "in_process": want[:, 1].tolist()}
    rec["ok"] = got.shape == want.shape and bool(
        np.isfinite(got).all()) and bool(np.array_equal(got, want))
    log(f"[mesh_train] launcher {json.dumps(rec)}")
    return rec


def mesh_train_start():
    """Phase 18's background parts, started early (before phase 17: each
    takes tens of seconds to reach the card, and little memory until its
    task): the launcher of (ii) under ``torchrun`` and the processes of
    (iii).  Returns (scratch directory, launcher, workers) for
    ``mesh_train_phase``."""
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_",
                           dir=os.path.join(HERE, "build"))
    import atexit
    started = [tmp, None, None]
    # a failing phase before 18 exits the smoke: its processes end too
    atexit.register(mesh_train_stop, started)
    started[1] = start_train_launcher(tmp)
    started[2] = MeshTrainWorkers()
    return started


def mesh_train_stop(started) -> None:
    """Ends what ``mesh_train_start`` started and removes its directory
    (once: later calls find nothing to do)."""
    tmp, launcher, workers = started
    started[1] = started[2] = None
    if workers is not None:
        workers.close()
    if launcher is not None and launcher[0][0].poll() is None:
        launcher[0][0].kill()
        launcher[0][0].wait()
    shutil.rmtree(tmp, ignore_errors=True)


def mesh_train_phase(started) -> dict:
    """Phase 18, on what ``mesh_train_start`` started.  (i)
    ``zamba_on_a_data_mesh``; (ii) the launcher under ``torchrun``
    (``train_launcher_check``); (iii) the ``MESH_TRAIN_2L`` copies at tp >
    1 and (2, 2) as processes sharing the card (``MeshTrainWorkers``;
    thread ranks cannot run a backward with a collective on a card), each
    held against the plain run (``mesh_train_held``), with the
    ``MESH_TRAIN_FAULTS`` planted and above their bounds.  Returns the
    ``mesh_train`` record."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, launcher, workers = started
    out = {}
    t0 = time.perf_counter()
    try:
        out["zamba2_1p2b_2x1"] = zamba_on_a_data_mesh()
        release_card()
        batch = mesh_train_batch()
        out["processes"] = {}
        faults = {}
        for key, arch, overrides, mesh in MESH_TRAIN_2L:
            cfg = mesh_train_config(arch, overrides)
            planted = [f for f, (case, _, _) in MESH_TRAIN_FAULTS.items()
                       if case == key]
            # the plain run first, its records in host memory; then
            # the ranks, whose results wait on the card
            t1 = time.perf_counter()
            ref = mesh_train_reference(cfg, batch)
            t_ref = time.perf_counter() - t1
            for fault in [None] + planted:
                # what this process and the card have free as the ranks
                # start (the ranks' own peaks come with their results)
                free_b, _ = torch.cuda.mem_get_info()
                main_b = torch.cuda.memory_reserved()
                t1 = time.perf_counter()
                outs = workers.run({"arch": arch, "overrides": overrides,
                                    "mesh": mesh, "batch": batch,
                                    "fault": fault})
                t_mesh = time.perf_counter() - t1
                rec = mesh_train_held(cfg, ref, outs)
                del outs
                gc.collect()
                workers.done(mesh[0] * mesh[1])
                if fault is None:
                    out["processes"][key] = {
                        "mesh": list(mesh), "batch": 2,
                        "seq": MESH_TRAIN_SEQ, "overrides": overrides,
                        "plain_s": t_ref, "mesh_s": t_mesh,
                        "plain_peak_bytes": ref["peak_bytes"],
                        "records_on": ref["records_on"],
                        "card_free_bytes_at_start": free_b,
                        "main_reserved_bytes_at_start": main_b, **rec}
                    log(f"[mesh_train] {key} "
                        f"{json.dumps(out['processes'][key])}")
                else:
                    faults[fault] = rec
            del ref
            release_card()
        for fault, (case, key, bound) in MESH_TRAIN_FAULTS.items():
            got = faults[fault][key]
            value = got[1] if isinstance(got, list) else got
            out.setdefault("faults", {})[fault] = {
                "case": case, key: got, "bound": bound,
                "above": value > bound}
        log(f"[mesh_train] faults {json.dumps(out['faults'])}")
        out["launcher"] = train_launcher_check(launcher)
    finally:
        mesh_train_stop(started)
    out["route_tp_above_1"] = (
        f"{MESH_TRAIN_WORLD} processes sharing the card, their collectives "
        "through staging buffers on it (CUDA IPC) ordered by gloo barriers "
        "(NCCL refuses two ranks on one device; thread ranks cannot run a "
        "backward with a collective on a card)")
    out["s"] = time.perf_counter() - t0
    checks = {k: out[k]["ok"] for k in ("zamba2_1p2b_2x1", "launcher")}
    checks.update({k: v["ok"] for k, v in out["processes"].items()})
    checks.update({f"fault_{k}": v["above"]
                   for k, v in out["faults"].items()})
    if not all(checks.values()):
        fail(f"mesh_train: {checks}")
    return out


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

    # phase 9's CPU cold fused runs start now, in a child, beside the
    # card's work of phases 7-9
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    cold_dir = tempfile.mkdtemp(prefix="chip_smoke_fused_cpu_",
                                dir=os.path.join(HERE, "build"))
    cold_proc = start_fused_cpu_cold(cold_dir)

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

    workloads = [(name, make_kb, None, functools.partial(
        fused_cpu_cold_run, cold_proc, cold_dir, name))
        for name, make_kb in fused_workloads(facts)]
    workloads.append(("deep_chain", lambda d: EngineKB(
        deep_prog, deep_facts, device=d), deep_checks, None))
    fused_recs, fused_kbs = [], {}
    launches_fused = {k: 0 for k in KERNELS}
    loops_fused = 0
    prev_flag = os.environ.get("REPRO_FUSED")
    try:
        for name, make_kb, checks, cpu_cold in workloads:
            rec, lc, loops, kbs = fused_workload(
                name, make_kb, checks or (lambda cold, warm: None),
                cpu_cold)
            fused_recs.append(rec)
            for k in KERNELS:
                launches_fused[k] += lc[k]
            loops_fused += loops
            if name == "lubm_l":
                fused_counts = fused_program_counts(kbs, rec)
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
        cold_proc.wait()
        shutil.rmtree(cold_dir, ignore_errors=True)
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
    for r in rows:
        r["launches_serve_moe"] = launches_moe.get(r["name"], 0)
        r["launches"] += r["launches_serve_moe"]
    log(f"[serve_moe] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_moe}")
    if any(launches_moe[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched on the KB->MoE LM path: "
             f"{launches_moe}")

    # 14. serving SSM and hybrid LMs: the KB's tokens served by narrow
    # Mamba-1 and Mamba-2 hybrid models (card against CPU),
    # falcon_mamba_7b and zamba2_1p2b at full width and depth, and
    # causal_tree_attn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served_ssm, launches_ssm = serve_ssm_phase(facts, lubm_nfacts,
                                               lubm_stats, tokens_12)
    for r in rows:
        r["launches_serve_ssm"] = launches_ssm.get(r["name"], 0)
        r["launches"] += r["launches_serve_ssm"]
    log(f"[serve_ssm] {time.perf_counter() - t0:.1f} s; launches "
        f"{launches_ssm}")
    if any(launches_ssm[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched on the KB->SSM LM path: "
             f"{launches_ssm}")

    # 15. training: the KB's tokens through lm_100m (float32 card against
    # CPU, bfloat16 with checkpoints and resume), zamba2_1p2b whole, and
    # 2-layer float32 copies card against CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_compare = train_phase(facts, lubm_nfacts, lubm_stats, tokens_12)
    del tokens_12
    t_train = time.perf_counter() - t0

    # phase 18's launcher and processes start now, beside phase 17
    mesh_train_started = mesh_train_start()

    # 17. serving on a mesh, on the card while phase 15's CPU side works:
    # an NCCL world of one at full width, the launcher under torchrun, and
    # thread ranks of 2-layer float32 copies against the plain runs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    KO.reset_launch_counts()
    meshed = mesh_phase(FULL_RUN)
    launches_mesh = KO.launch_counts()
    meshed["s"] = time.perf_counter() - t0
    FULL_RUN.clear()
    for r in rows:
        r["launches_mesh"] = launches_mesh.get(r["name"], 0)
        r["launches"] += r["launches_mesh"]
    log(f"[mesh] {meshed['s']:.1f} s; launches {launches_mesh} (the mesh "
        f"path has no kernel of its own)")

    t0 = time.perf_counter()
    trained, launches_train = train_compare()
    del train_compare
    t_train += time.perf_counter() - t0
    for r in rows:
        r["launches_train"] = launches_train.get(r["name"], 0)
        r["launches"] += r["launches_train"]
    log(f"[train] {t_train:.1f} s beside phase 17; launches "
        f"{launches_train}")
    if any(launches_train[k] == 0 for k in KERNELS):
        fail(f"a kernel was never launched on the KB->training path: "
             f"{launches_train}")

    # 18. training on a mesh, once phase 15's comparisons have freed its
    # records on the card (33.8 GB): zamba2_1p2b whole at (2, 1), the
    # launcher under torchrun, and 2-layer float32 copies at tp > 1 and
    # (2, 2) as processes sharing the card, each against the plain run
    torch.cuda.empty_cache()
    KO.reset_launch_counts()
    mesh_trained = mesh_train_phase(mesh_train_started)
    launches_mesh_train = KO.launch_counts()
    for r in rows:
        r["launches_mesh_train"] = launches_mesh_train.get(r["name"], 0)
        r["launches"] += r["launches_mesh_train"]
    log(f"[mesh_train] {mesh_trained['s']:.1f} s; launches "
        f"{launches_mesh_train} (the mesh training path has no kernel of "
        f"its own)")

    # 16. the analysis layer: counts card against CPU, and counted steps
    # beside measured ones
    t0 = time.perf_counter()
    analysis = analysis_phase(shapes.largest, rows, fused_counts, served,
                              trained, smi)
    analysis["s"] = time.perf_counter() - t0
    log(f"[analysis] {analysis['s']:.1f} s")

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
    print(json.dumps({"serve_ssm": {**served_ssm, "card": smi}}))
    print(json.dumps({"train": {**trained, "card": smi}}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"mesh": {**meshed, "card": smi}}))
    print(json.dumps({"mesh_train": {**mesh_trained, "card": smi}}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--fused-cpu"]:
        sys.exit(fused_cpu_cold(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2]))
    sys.exit(main())
