"""Compare copies of the port on one CUDA card: sort kernels and
materialization, each copy in its own process, in turns.

    python scripts/compare_port.py [--tiles] [--sort] [--materialize]
        [--probes] [--probe] [--probe-main] [--probe-cuts]
        [--probe-variants SPEC,...]
        [--reps 3] [--rounds 2] [--out FILE] NAME=SRC ...

``SRC`` is a directory holding a ``repro_torch`` package (``src`` for this
checkout; unpack another commit with ``git archive`` into a directory that
git ignores).  Each copy builds its own kernels beside its ``src``.  The
copies run in the order given, then in reverse, ``--rounds`` times in all
(A B B A for two), so that drift of the card's clocks falls on both.  The
measuring functions are those of ``chip_smoke.py``.

``--tiles`` times the tile sort at 2^22 pairs (int32 keys, tile 1024;
int64 keys, tile 4096): device time, and time per call.

``--sort`` times the merge's device time at every width of a 2^22 sort
from tile 1024; the merge wrapper's host time per call (perf_counter
around calls that the card is not waited on, at a width that needs the
span cuts and one that does not); and whole sorts of 2^10 .. 2^20 keys:
device time, and latency (one call fenced by synchronizes).

``--materialize`` times ``materialize(kb, mode="tg")`` on LUBM-L
(``n_univ=2000``) and wide TC (1,000,000 chains) on the card: ``--reps``
runs on fresh KBs after one warm-up, one under the profiler (wall and
device busy time), and two with the sort wrappers timed on the host, the
second with every call fenced by synchronizes.

``--probes`` adds copies of the first package whose
``csrc/bitonic_sort.cu`` is cut down (``PROBES``) to find what the tile
sort's time goes to; their results are wrong and only their times count.

``--probe`` times the sorted-membership probe over ``chip_smoke.py``'s
grid of shapes (``probe_grid``: queries x haystack length x key type):
device time, time per call and mismatches against the plain version.
``--probe-main`` adds, to every copy that times the probe but the cuts,
the probe at the largest call of LUBM-L's ``materialize`` (its own
inputs).
``--probe-cuts`` adds copies of the first package whose
``csrc/hash_probe.cu`` is cut down (``PROBE_CUTS``); a cut is made only
where its text is in that file (the cuts of the one-thread binary search
apply to a tree that still has it, unpacked with ``git archive``), and the
copies time the same grid.  ``--probe-variants`` adds copies of the first
package whose probe kernel has other numbers: a spec
``[L<levels>][T<threads>][C<ctas per SM>][W<loops>]``, such as ``L10`` or
``L10T512C1``, sets ``PROBE_LEVELS``, ``PROBE_THREADS``,
``PROBE_CTAS_PER_SM`` (the narrow grid) and ``PROBE_WIDE_FROM`` (``W0``:
always the wide grid; ``W99999``: never) in its ``csrc/hash_probe.cu``;
they are right and time the same grid.

Prints one JSON object: for every copy, each metric's values over the
rounds.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_ROOT = os.path.join(ROOT, "build", "compare_port")

# name -> (old, new) text replacements in csrc/bitonic_sort.cu
PROBES = {
    # load, register sort and store only: the tile sort's floor
    "probe_no_rounds": [(
        "for (int w = 2 * N; w <= TILE; w <<= 1) {",
        "for (int w = 2 * N; w <= 0; w <<= 1) {")],
    # every round copies a thread's own items: shared traffic and barriers
    "probe_copy_rounds": [(
        "merge_items<P>(SmemRun<T>{src, blk}, h, "
        "SmemRun<T>{src, blk + h}, h,\n                       d0 - blk, x);",
        "for (int t = 0; t < N; ++t) x[t] = src[padded<T>(d0 + t)];\n"
        "        (void)blk;\n        (void)h;")],
    # the rounds merge from a fixed split instead of the co-rank search
    "probe_no_search": [(
        "int i = co_rank<P, 1>(a, na, b, nb, d), j = d - i;",
        "int i = min(d >> 1, na), j = d - i;")],
}


# Cut-down copies of the one-thread binary search of ``csrc/hash_probe.cu``
# (one thread per query, the grid of one query per thread): name -> (old,
# new) replacements.  The table cuts stage the keys that the first L levels
# of the search visit (2^L - 1, breadth-first) in shared memory, descend
# them, and finish with the binary search over the H / 2^L wide range left.
_PROBE_OLD_LOOP = (
    "        long long lo = 0, hi = h;\n"
    "        for (int s = 0; s < steps; ++s) {")
_PROBE_STEP = "    const long long step = (long long)gridDim.x * blockDim.x;"


def _table_descent(lv: int) -> str:
    return f"""        int k = 1;
#pragma unroll
        for (int s = 0; s < {lv}; ++s) k = 2 * k + (tab[k] < q);
        const long long c = k - {1 << lv};
        long long lo = c ? ((c * h) >> {lv}) + 1 : 0;
        long long hi = c < {(1 << lv) - 1} ? (((c + 1) * h) >> {lv}) + 1 : h;
        const int steps2 = 64 - __clzll(hi - lo);
        for (int s = 0; s < steps2; ++s) {{"""


def _table_stage(lv: int) -> str:
    return f"""    __shared__ K tab[{1 << lv}];
    for (int k = threadIdx.x + 1; k < {1 << lv}; k += blockDim.x) {{
        const int lev = 31 - __clz(k);
        const long long j = ((long long)(2 * (k - (1 << lev)) + 1)
                             << ({lv - 1} - lev)) - 1;
        tab[k] = hay[((j + 1) * h) >> {lv}];
    }}
    __syncthreads();
""" + _PROBE_STEP


_NO_SCAN = [
    ("        for (int j = 0; j < PROBE_LANES; ++j) {\n"
     "            const int tj",
     "        for (int j = 0; j < 0; ++j) {\n"
     "            const int tj"),
    ("        for (int j = 0; j < PROBE_LANES; ++j) {\n"
     "            const K qj",
     "        for (int j = 0; j < 0; ++j) {\n"
     "            const K qj")]
PROBE_CUTS = {
    # load the query, write a flag, no search: the floor of this grid
    "cut_no_search": [
        ("for (int s = 0; s < steps; ++s) {",
         "for (int s = 0; s < 0; ++s) {"),
        ("out[i] = (lo < h && hay[lo < h - 1 ? lo : h - 1] == q) ? 1 : 0;",
         "out[i] = q == (K)0;")],
    # the top 12 levels from a shared table staged by every CTA
    "cut_table12": [(_PROBE_STEP, _table_stage(12)),
                    (_PROBE_OLD_LOOP, _table_descent(12))],
    # the same with one CTA per SM, each looping over its queries
    "cut_table12_1cta": [
        (_PROBE_STEP, _table_stage(12)),
        (_PROBE_OLD_LOOP, _table_descent(12)),
        ("grid_for(n, PROBE_THREADS)",
         "(grid_for(n, PROBE_THREADS) < 132u ? grid_for(n, PROBE_THREADS)"
         " : 132u)")],
    # the shared descent and the short search with no staging: the table
    # holds whatever shared memory held, and the queries search whatever
    # range that sends them to
    "cut_table12_unstaged": [
        (_PROBE_STEP, "    __shared__ K tab[4096];\n" + _PROBE_STEP),
        (_PROBE_OLD_LOOP, _table_descent(12))],
    # the top 8 levels from a table staged by every CTA
    "cut_table8": [(_PROBE_STEP, _table_stage(8)),
                   (_PROBE_OLD_LOOP, _table_descent(8))],
    # the line-head kernel without its 8-lane line scan
    "cut_heads_no_scan": _NO_SCAN,
    # the line-head kernel with its table only: no search, no line scan
    "cut_heads_table_only": _NO_SCAN + [
        ("        for (int s = 0; s < steps; ++s) {",
         "        for (int s = 0; s < 0; ++s) {")],
}


def make_probe(name: str, src: str, source: str = "bitonic_sort.cu",
               cuts=None) -> str | None:
    """A copy of the package under ``src`` with probe ``name`` applied to
    ``csrc/<source>``; returns the copy's ``src``.  With ``cuts`` given
    (``PROBE_CUTS``), returns None where a text to replace is not in the
    file exactly once; otherwise that is an error."""
    edits = (cuts or PROBES)[name]
    text = open(os.path.join(src, "repro_torch", "kernels", "csrc",
                             source)).read()
    for old, new in edits:
        if isinstance(old, re.Pattern):
            text, count = old.subn(new, text)
        else:
            count = text.count(old)
            text = text.replace(old, new)
        if count != 1:
            if cuts is not None:
                return None
            raise SystemExit(f"probe {name}: the text to replace is not "
                             f"in {source} exactly once: {old!r}")
    dst = os.path.join(PROBE_ROOT, name, "src")
    shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
    shutil.copytree(os.path.join(src, "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(dst, "repro_torch", "kernels", "csrc", source),
              "w") as f:
        f.write(text)
    return dst


# ---------------------------------------------------------------------------
# the worker: one copy of the package, in its own process
# ---------------------------------------------------------------------------
def time_tiles(smoke, torch, np) -> dict:
    from repro_torch.kernels import bitonic_sort as BS
    rng = np.random.default_rng(1)
    n = 1 << 22
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    out = {}
    for dt, tile in ((torch.int32, 1024), (torch.int64, 4096)):
        keys = smoke.rand_keys(rng, n, dt, 0, 1 << 30)
        tag = f"{str(dt).split('.')[-1]}/{tile}"
        out[f"tile_device_ms {tag}"] = smoke.device_ms(
            lambda: BS.bitonic_sort_tiles(keys, pos, tile))
        out[f"tile_ms {tag}"] = smoke.time_ms(
            lambda: BS.bitonic_sort_tiles(keys, pos, tile))
    return out


_VARIANT = re.compile(r"(?:L(\d+))?(?:T(\d+))?(?:C(\d+))?(?:W(\d+))?")


def variant_cuts(spec: str) -> list:
    """The ``make_probe`` edits of ``--probe-variants`` spec ``spec``."""
    m = _VARIANT.fullmatch(spec)
    if not spec or not m:
        raise SystemExit(f"compare_port: bad probe variant {spec!r}")
    names = ("PROBE_LEVELS", "PROBE_THREADS", "PROBE_CTAS_PER_SM",
             "PROBE_WIDE_FROM")
    return [(re.compile(rf"#define {name} \d+"), f"#define {name} {val}")
            for name, val in zip(names, m.groups()) if val is not None]


def time_probe(smoke, torch, np) -> dict:
    from repro_torch.kernels import hash_probe as HP
    from repro_torch.kernels import ref
    out = {}
    for shape, got in smoke.probe_grid(HP, ref,
                                       np.random.default_rng(3)).items():
        out[f"probe_mismatches {shape}"] = got["mismatches"]
        out[f"probe_device_ms {shape}"] = got["device_ms"]
        out[f"probe_ms {shape}"] = got["ms"]
    return out


def time_probe_main(smoke, torch) -> dict:
    """The probe at the largest call LUBM-L's ``materialize`` makes on the
    card (the main path's own queries and haystack): device time, time
    per call, and what the inputs look like."""
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import LUBM_L, lubm_facts
    from repro_torch.kernels import bitonic_sort as BS
    from repro_torch.kernels import hash_probe as HP
    from repro_torch.kernels import unique_mask as UM
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=smoke.LUBM_UNIV))
    with smoke.ShapeLog(BS, UM, HP) as shapes:
        materialize(kb, mode="tg")
    q, hay = (a.clone() for a in shapes.largest["probe_sorted"][1])
    pad = torch.iinfo(q.dtype).max
    flags = HP.probe_sorted(q, hay)
    return {
        "probe_main_shape": [q.numel(), hay.numel(), str(q.dtype)],
        "probe_main_queries_sorted": bool((q[1:] >= q[:-1]).all()),
        "probe_main_pad_share": [float((q == pad).float().mean()),
                                 float((hay == pad).float().mean())],
        "probe_main_found_share": float(flags.float().mean()),
        "probe_main_device_ms": smoke.device_ms(
            lambda: HP.probe_sorted(q, hay)),
        "probe_main_ms": smoke.time_ms(lambda: HP.probe_sorted(q, hay))}


def latency_us(torch, fn, reps: int = 50) -> float:
    """Median wall time of one call and a synchronize: the host's work and
    the device's, end to end, for a call that nothing else overlaps."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2] * 1e6


def time_sort(smoke, torch, np) -> dict:
    from repro_torch.kernels import bitonic_sort as BS
    from repro_torch.kernels import ops as KO
    rng = np.random.default_rng(2)
    n = 1 << 22
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    keys = smoke.rand_keys(rng, n, torch.int32, 0, 1 << 30)
    cur = BS.bitonic_sort_tiles(keys, pos, 1024)
    out = {}
    width = 2048
    while width <= n:
        out[f"merge_device_ms {width}"] = smoke.device_ms(
            lambda: BS.bitonic_merge_pairs(*cur, width))
        cur = BS.bitonic_merge_pairs(*cur, width)
        width *= 2
    small = cur[0][: 1 << 13], cur[1][: 1 << 13]
    for width in (1 << 11, 1 << 13):
        for _ in range(10):
            BS.bitonic_merge_pairs(*small, width)
        torch.cuda.synchronize()
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            BS.bitonic_merge_pairs(*small, width)
        out[f"merge_host_us {width}"] = \
            (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    for log2 in (10, 12, 14, 16, 18, 20):
        k, v = keys[: 1 << log2], pos[: 1 << log2]
        out[f"sort_latency_us 2^{log2}"] = latency_us(
            torch, lambda: KO.sort_with_payload(k, v, tile=1024))
        out[f"sort_device_ms 2^{log2}"] = smoke.device_ms(
            lambda: KO.sort_with_payload(k, v, tile=1024))
    return out


def wrapper_ms(torch, run, sync: bool) -> dict:
    """Run ``run`` with the sort wrappers timed on the host: their total
    ms and calls.  With ``sync``, each call is fenced by synchronizes, so
    its time is its host work and its kernels' latency."""
    from repro_torch.kernels import bitonic_sort as BS
    names = ("bitonic_sort_tiles", "bitonic_merge_pairs")
    orig = {name: getattr(BS, name) for name in names}
    acc = {name: [0.0, 0] for name in names}

    def timed(name):
        def call(*args):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig[name](*args)
            if sync:
                torch.cuda.synchronize()
            acc[name][0] += (time.perf_counter() - t0) * 1e3
            acc[name][1] += 1
            return res
        return call
    for name in names:
        setattr(BS, name, timed(name))
    try:
        run()
    finally:
        for name in names:
            setattr(BS, name, orig[name])
    return acc


def time_materialize(smoke, torch, reps: int) -> dict:
    from repro_torch import EngineKB, materialize
    from repro_torch.data.kb_sources import (LUBM_L, TC, lubm_facts,
                                             tc_wide_chunks)
    facts = lubm_facts(n_univ=smoke.LUBM_UNIV)
    makers = {
        "lubm": lambda: EngineKB(LUBM_L, facts),
        "tc_wide": lambda: EngineKB.from_stream(
            TC, tc_wide_chunks(smoke.TC_CHAINS)),
    }
    out = {}
    for name, make in makers.items():
        walls = []
        for r in range(reps + 1):
            kb = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            materialize(kb, mode="tg")
            torch.cuda.synchronize()
            if r:                       # the first run warms up
                walls.append(time.perf_counter() - t0)
            del kb
        out[f"{name} materialize_s"] = walls
        kb = make()
        prof = smoke.profile_run(name, lambda: materialize(kb, mode="tg"))
        out[f"{name} profiled_wall_ms"] = prof["wall_ms"]
        out[f"{name} profiled_busy_ms"] = prof["device_busy_ms"]
        for sync in (False, True):
            kb = make()
            out[f"{name} wrappers_{'synced' if sync else 'host'}_ms"] = \
                wrapper_ms(torch, lambda: materialize(kb, mode="tg"), sync)
        del kb
    return out


def worker(src: str, tiles: bool, sort: bool, mat: bool, probe: bool,
           probe_main: bool, reps: int) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(src))
    sys.path.insert(1, ROOT)
    import chip_smoke as smoke
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    out = {"build_s": time.perf_counter() - t0}
    if tiles:
        out.update(time_tiles(smoke, torch, np))
    if sort:
        out.update(time_sort(smoke, torch, np))
    if mat:
        out.update(time_materialize(smoke, torch, reps))
    if probe:
        out.update(time_probe(smoke, torch, np))
    if probe_main:
        out.update(time_probe_main(smoke, torch))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("copies", nargs="*", metavar="NAME=SRC")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--sort", action="store_true")
    ap.add_argument("--materialize", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--probe-main", action="store_true")
    ap.add_argument("--probe-cuts", action="store_true")
    ap.add_argument("--probe-variants", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.tiles, args.sort,
                                args.materialize, args.probe,
                                args.probe_main, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("compare_port: needs a CUDA card")
    copies = [c.split("=", 1) for c in args.copies]
    if not copies or any(len(c) != 2 for c in copies):
        raise SystemExit("compare_port: give copies as NAME=SRC")
    jobs = [(name, src, args.tiles, args.sort, args.materialize, args.probe)
            for name, src in copies]
    if args.probes:
        jobs += [(p, make_probe(p, copies[0][1]), True, False, False, False)
                 for p in PROBES]
    if args.probe_cuts:
        for p in PROBE_CUTS:
            dst = make_probe(p, copies[0][1], "hash_probe.cu", PROBE_CUTS)
            if dst is None:
                print(f"{p}: not in {copies[0][0]}'s hash_probe.cu, "
                      "not made", flush=True)
            else:
                jobs.append((p, dst, False, False, False, True))
    for spec in filter(None, args.probe_variants.split(",")):
        cuts = {spec: variant_cuts(spec)}
        dst = make_probe(spec, copies[0][1], "hash_probe.cu", cuts)
        if dst is None:
            raise SystemExit(f"compare_port: {spec}: no such numbers in "
                             "hash_probe.cu")
        jobs.append((spec, dst, False, False, False, True))
    order = []
    for r in range(args.rounds):
        order += jobs if r % 2 == 0 else jobs[::-1]
    results = {}
    for name, src, tiles, sort, mat, probe in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", src,
               "--reps", str(args.reps)]
        cmd += ["--tiles"] * tiles + ["--sort"] * sort
        cmd += ["--materialize"] * mat + ["--probe"] * probe
        # a cut's wrong flags would keep LUBM-L's fixpoint from closing
        cmd += ["--probe-main"] * (probe and args.probe_main
                                   and name not in PROBE_CUTS)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"compare_port: {name} failed:\n{res.stdout}"
                             f"\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{name}: {json.dumps(got)}", flush=True)
        for k, v in got.items():
            results.setdefault(name, {}).setdefault(k, []).append(v)
    text = json.dumps(results)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
