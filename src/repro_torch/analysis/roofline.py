"""Roofline terms of a counted program (the counterpart of
``repro.analysis.roofline``), with the H100's constants.

Three terms per (arch, shape, mesh) cell, all in seconds:

    compute    = counted FLOPs       / PEAK_FLOPS
    memory     = counted bytes       / HBM_BW
    collective = collective bytes    / LINK_BW

The counts come from ``repro_torch.analysis.cost``, which walks the torch
program as it runs (the reference walks compiled HLO).  They are per
device: ``hlo_flops`` / ``hlo_bytes`` keep the reference's names and hold
the per-device counts times the chips, and ``useful_ratio`` is the model's
FLOPs over them, as on the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5, from NVIDIA's H100 data sheet (one card)
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12             # HBM3 bytes/s (data sheet)
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction (data sheet)


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # fleet total (counted, not HLO)
    hlo_bytes: float                 # fleet total (counted, not HLO)
    coll_bytes: float                # per-chip payload total
    coll_detail: dict
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    mem_per_device: float

    def to_json(self):
        return self.__dict__


def analyze(arch, shape, mesh_name, chips, record, model_flops,
            mem_stats=None) -> RooflineResult:
    """Roofline terms from one device's counted ``record`` (the dict of
    ``cost.Recorder.as_dict`` or ``cost.walk``).  ``coll_detail`` holds the
    counted collectives by kind, their ``total`` and ``count``, and the
    counted matrix-product FLOPs (``dot_flops``)."""
    per_dev_flops = float(record.get("flops", 0.0))
    per_dev_bytes = float(record.get("bytes", 0.0))
    cb = {k: float(v) for k, v in record.get("coll", {}).items()}
    cb["total"] = float(record.get("coll_bytes", sum(cb.values())))
    cb["count"] = int(record.get("coll_count", 0))
    cb["dot_flops"] = float(record.get("dot_flops", 0.0))
    hlo_flops = per_dev_flops * chips
    hlo_bytes = per_dev_bytes * chips
    compute_s = per_dev_flops / PEAK_FLOPS
    memory_s = per_dev_bytes / HBM_BW
    collective_s = cb["total"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / hlo_flops if hlo_flops else 0.0
    return RooflineResult(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        coll_bytes=cb["total"], coll_detail=cb,
        model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, useful_ratio=useful,
        mem_per_device=float(mem_stats) if mem_stats is not None else 0.0)


# ---------------------------------------------------------------------------
# engine rooflines: bytes / FLOPs per fact of the sorted-store cores (sort /
# probe / absorb) and of the fused executor's programs
# ---------------------------------------------------------------------------
def _core_inputs(cap, arity, dt, device):
    """Two lexsorted (cap, arity) blocks of distinct valid rows (the cores'
    counts depend on shapes alone, but for the probe kernel's sectors)."""
    import torch
    i = torch.arange(cap, dtype=torch.int64, device=device)
    cols = [(i >> (4 * (arity - 1 - c))) if c < arity - 1 else i
            for c in range(arity)]
    a = torch.stack(cols, 1).to(dt)
    b = torch.stack([c + (1 if j == arity - 1 else 0)
                     for j, c in enumerate(cols)], 1).to(dt)
    return a, b


def engine_op_roofline(n_rows: int, arity: int = 2, dtype=None,
                       device=None) -> dict:
    """Count the three dominant sorted-store cores at the capacity the
    planner would pick for ``n_rows`` facts (``next_pow2``) and report
    bytes/FLOPs per fact per op class: ``sort`` (``lexsort_core``),
    ``probe`` (``member_mask_core``), ``absorb`` (``merge_core``).  The
    cores run once each on ``device`` (the card unless the caller names
    one); a hand kernel counts its formula, so the counts are the same on
    the card and on the CPU."""
    import numpy as np
    import torch

    from repro_torch.analysis import cost
    from repro_torch.engine import ops as EO
    from repro_torch.engine.relation import (next_pow2, resolve_device,
                                             store_dtype, torch_dtype)

    dt = torch_dtype(np.dtype(dtype) if dtype is not None
                     else store_dtype())
    dev = resolve_device(device)
    cap = next_pow2(max(n_rows, 1))
    a, b = _core_inputs(cap, arity, dt, dev)
    na = torch.tensor(cap // 2, device=dev)
    nb = torch.tensor(cap // 2, device=dev)

    def cell(fn, *args):
        with cost.Recorder() as r:
            fn(*args)
        t = r.as_dict()
        denom = max(n_rows, 1)
        return {"flops": t["flops"], "bytes": t["bytes"],
                "flops_per_fact": t["flops"] / denom,
                "bytes_per_fact": t["bytes"] / denom,
                "kernels": t["kernels"]}

    out = {"n_rows": n_rows, "capacity": cap, "arity": arity,
           "dtype": str(dt).removeprefix("torch.")}
    out["sort"] = cell(EO.lexsort_core, b.flip(0))
    out["probe"] = cell(EO.member_mask_core, b, a)
    out["absorb"] = cell(EO.merge_core, a, b, na, nb)
    return out


def engine_fused_roofline(kb, total_facts: int, mode: str = "tg"):
    """The counts of the fused executor's round and fixpoint programs for
    ``kb`` (``fused.lower_fused_programs``): FLOPs, bytes, per-fact unit
    costs and arithmetic intensity per program, and ``sort_ops_static``
    (sort calls in one program body).  The reference's ``xla_cost`` (XLA's
    own ``cost_analysis``) has no counterpart and is left out; ``kernels``
    holds the hand kernels' calls and bytes, and the fixpoint its
    ``trip_count``.  Returns None when the program leaves the fused
    fragment."""
    from repro_torch.engine.fused import lower_fused_programs

    arts = lower_fused_programs(kb, mode=mode)
    if not arts:
        return None
    denom = max(total_facts, 1)
    out = {}
    for name, t in arts.items():
        out[name] = {
            "flops": t["flops"], "bytes": t["bytes"],
            "sort_ops_static": t["sort_ops_static"],
            "flops_per_fact": t["flops"] / denom,
            "bytes_per_fact": t["bytes"] / denom,
            "intensity_flops_per_byte": (t["flops"] / t["bytes"]
                                         if t["bytes"] else 0.0),
            "kernels": t["kernels"], "trip_count": t["trip_count"],
        }
    return out


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D train (N=active for MoE), 2*N*D forward-only."""
    counts = cfg.param_counts()
    n = counts["active"]
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
