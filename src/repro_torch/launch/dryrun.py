"""Dry run (``repro.launch.dryrun``'s counterpart): the count of one step of
every (arch, shape) cell on one H100, with its roofline terms and its
memory, without running the step on a card.

The reference compiles each step for a 256- or 512-chip mesh and walks the
compiled HLO.  Here the step runs under fake tensors on the CPU
(``repro_torch.analysis.cost.dry``: shapes and dtypes, no memory) and
``cost.walk`` counts it op by op, with the H100's constants in
``analysis.roofline``.  The mesh is one card (``"mesh": "1"``); several
cards (``--multi-pod``, any larger mesh) are ROADMAP Queue 1 item 12's
last part (the production mesh).

    python -m repro_torch.launch.dryrun --arch stablelm_12b --shape decode_32k
    python -m repro_torch.launch.dryrun --sweep       # every cell, resumable

A cell that does not fit one card's 80 GB is reported with its memory, as
any cell is; nothing is allocated.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.analysis import cost
from repro_torch.analysis import roofline as RL
from repro_torch.configs.base import ARCHS, SHAPES, get_config, supported_cells
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")
MESH = "1"              # one H100
CHIPS = 1
DEVICE_BYTES = 80 * 2**30   # H100 80GB HBM3
SWEEP_JOBS = max(1, (os.cpu_count() or 2) // 2)   # cells counted at once
CELL_TIMEOUT_S = 4 * 3600  # a cell of --sweep still counting then is
                           # recorded as timed out (falcon's train_4k
                           # counts for 3.2 h)
_SEVERAL = ("several cards in the dry run (the 256/512-device production "
            "mesh) are ROADMAP.md Queue 1 item 12's last part: the dry run "
            "counts one H100")


def cell_id(arch, shape, multi_pod=False, tag=""):
    if multi_pod:
        raise NotImplementedError(_SEVERAL)
    sfx = f"-{tag}" if tag else ""
    return f"{arch}.{shape}.h100x{MESH}{sfx}"


def _check_mesh(multi_pod: bool, mesh: str) -> None:
    if multi_pod or mesh != MESH:
        raise NotImplementedError(_SEVERAL)


def _memory(rec) -> dict:
    m = rec["memory"]
    return {"per_device_total": m["per_device_total"],
            "argument_bytes": m["argument_bytes"],
            "temp_bytes": m["temp_bytes"],
            "output_bytes": m["output_bytes"],
            "alias_bytes": m["alias_bytes"],
            "fits_one_card": m["per_device_total"] <= DEVICE_BYTES}


def run_glog_cell(multi_pod: bool = False, tag: str = "", mesh: str = MESH,
                  ndev: int = 8) -> dict:
    """Dry run of the paper's own workload: ONE TG round of the sharded
    executor (delta exchange + planned join + absorb), counted for
    ``ndev`` lockstep shards on one card, under fake tensors."""
    from repro_torch.engine.distributed import (DistConfig,
                                                lower_distributed_tc)
    _check_mesh(multi_pod, mesh)
    t0 = time.time()
    cfg = DistConfig(shard_cap=1 << 20, delta_cap=1 << 18,
                     bucket_cap=1 << 10)
    with cost.dry():
        rec = lower_distributed_tc(ndev, cfg, device="cpu")
    t_count = time.time() - t0
    rr = RL.analyze("glog_tc", "materialize", MESH, CHIPS, rec, 0.0,
                    mem_stats=rec["memory"]["per_device_total"])
    return {"cell": cell_id("glog_tc", "materialize", False, tag),
            "arch": "glog_tc", "shape": "materialize", "mesh": MESH,
            "chips": CHIPS, "ndev": ndev, "status": "ok",
            "count_s": round(t_count, 1), "memory": _memory(rec),
            "roofline": rr.to_json()}


def _batch(cfg, shape):
    """The step's input batch, zeros (values do not change a count)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": torch.zeros((B, S, cfg.d_model),
                                           dtype=torch.float32)}
    else:
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    if shape.kind == "train":
        batch["labels"] = torch.zeros((B, S), dtype=torch.int32)
    return batch


def _decode_inputs(mdl, cfg, shape):
    """Caches of ``shape.seq_len`` positions (the reference's cache specs)
    and one token per sequence."""
    B, S = shape.global_batch, shape.seq_len
    dt = mdl.emb.dtype
    caches = {}
    for name, shp in T.cache_shapes(cfg, B, S).items():
        if name == "ssm":
            caches[name] = (torch.zeros(shp[0], dtype=dt),
                            torch.zeros(shp[1], dtype=torch.float32))
        else:
            caches[name] = torch.zeros(shp, dtype=dt)
    if cfg.input_mode == "embeddings":
        token = torch.zeros((B, 1, cfg.d_model), dtype=torch.float32)
    else:
        token = torch.zeros((B,), dtype=torch.int32)
    return caches, token


def count_step(cfg, shape) -> tuple:
    """Build ``cfg`` under fake tensors and count one step of ``shape``'s
    kind.  Returns (record with ``memory``, seconds)."""
    t0 = time.time()
    with cost.dry():
        mdl = M.build(cfg, device="cpu", training=shape.kind == "train")
        params = dict(mdl.named_parameters())
        if shape.kind == "train":
            opt = OPT.init_opt_state(params, mdl.opt_cfg)
            batch = _batch(cfg, shape)
            _, rec = cost.walk(
                lambda: (params, *mdl.train_step(opt, batch, 0)),
                arguments=(params, opt, batch))
        elif shape.kind == "prefill":
            batch = _batch(cfg, shape)
            _, rec = cost.walk(lambda: mdl.prefill_step(batch),
                               arguments=(params, batch))
        else:
            caches, token = _decode_inputs(mdl, cfg, shape)
            _, rec = cost.walk(
                lambda: mdl.decode_step(caches, token, shape.seq_len - 1),
                arguments=(params, caches, token))
    return rec, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir=None, tag: str = "", overrides=None,
             mesh: str = MESH) -> dict:
    _check_mesh(multi_pod, mesh)
    if arch == "glog_tc":
        return run_glog_cell(multi_pod, tag, mesh)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = SHAPES[shape_name]
    ok, reason = supported_cells(cfg)[shape_name]
    rec = {"cell": cell_id(arch, shape_name, multi_pod, tag),
           "arch": arch, "shape": shape_name, "mesh": MESH, "chips": CHIPS}
    if not ok:
        rec.update({"status": "skipped", "reason": reason})
        return rec
    walk, t_count = count_step(cfg, shape)
    mf = RL.model_flops_estimate(cfg, shape)
    rr = RL.analyze(arch, shape_name, MESH, CHIPS, walk, mf,
                    mem_stats=walk["memory"]["per_device_total"])
    rec.update({
        "status": "ok",
        "count_s": round(t_count, 1),
        "ops": walk["ops"],
        "memory": _memory(walk),
        "roofline": rr.to_json(),
    })
    return rec


def sweep(args) -> None:
    """Every (arch x shape) cell in a subprocess of its own,
    ``SWEEP_JOBS`` at a time; a cell whose record exists is skipped
    (resumable), and one that counts past ``CELL_TIMEOUT_S`` is recorded
    as such."""
    from concurrent.futures import ThreadPoolExecutor

    def one(arch, shape):
        cid = cell_id(arch, shape, False, args.tag)
        path = os.path.join(args.out, cid + ".json")
        if os.path.exists(path):
            print(f"[skip] {cid}", flush=True)
            return
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if args.tag:
            cmd += ["--tag", args.tag]
        if args.override:
            cmd += ["--override", args.override]
        print(f"[run ] {cid}", flush=True)
        try:
            r = subprocess.run(cmd, timeout=CELL_TIMEOUT_S,
                               capture_output=True, text=True)
            rec = {"returncode": r.returncode, "stderr": r.stderr[-2000:]}
        except subprocess.TimeoutExpired:
            rec = {"status": "timeout", "reason": f"the count ran past "
                   f"{CELL_TIMEOUT_S} s on the CPU"}
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({"cell": cid, "arch": arch, "shape": shape,
                           "mesh": MESH, "chips": CHIPS, "status": "error",
                           **rec}, f, indent=2)
        print(f"[done] {cid}", flush=True)

    with ThreadPoolExecutor(SWEEP_JOBS) as pool:
        list(pool.map(lambda c: one(*c),
                      [(a, s) for a in ARCHS for s in SHAPES]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="run every (arch x shape) cell in subprocesses; "
                         "resumable")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", default="",
                    help="comma-separated cfg overrides k=v (perf experiments)")
    args = ap.parse_args(argv)
    _check_mesh(args.multi_pod, MESH)
    os.makedirs(args.out, exist_ok=True)

    if args.sweep:
        sweep(args)
        return

    overrides = {}
    if args.override:
        for kv in args.override.split(","):
            k, v = kv.split("=")
            try:
                v = json.loads(v)
            except ValueError:
                pass
            overrides[k] = v

    cid = cell_id(args.arch, args.shape, False, args.tag)
    path = os.path.join(args.out, cid + ".json")
    try:
        rec = run_cell(args.arch, args.shape, False, args.out, args.tag,
                       overrides or None)
    except Exception as e:
        rec = {"cell": cid, "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    status = rec.get("status")
    print(f"{cid}: {status}")
    if status == "ok":
        r = rec["roofline"]
        print(f"  compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
              f"collective={r['collective_s']:.4g}s bottleneck={r['bottleneck']}"
              f" useful={r['useful_ratio']:.3f} "
              f"mem/dev={rec['memory']['per_device_total']/1e9:.2f}GB "
              f"count={rec['count_s']}s")
    elif status == "error":
        print(rec.get("traceback", "")[-2000:])
        sys.exit(1)


if __name__ == "__main__":
    main()
