"""Sorted-membership probe (the Def. 23 antijoin / redundancy-filter core):
wrapper over ``csrc/hash_probe.cu``.

Replaces the Pallas kernel ``probe_sorted`` (``src/repro/kernels/
hash_probe.py``, body ``_probe_kernel``), which copies the whole haystack
into one VMEM block per grid step.

Bound on the card: the dependent loads of each query's search that miss
L1, the lines a warp's loads touch, and the instructions per query, not
bytes.  So the kernel searches the heads of the haystack's 128-byte lines
instead of its keys: the top levels from a table in shared memory that
each CTA of a persistent grid stages once (8 levels, or 12 when a CTA
answers many queries), the rest by one thread per query in device memory;
then 8 lanes read the query's line whole, 16 bytes each, and vote with a
ballot.  One launch per call; ``csrc/hash_probe.cu`` has the design and
PERF.md its measurements.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import build, ref

# kernel launches since the last reset (``kernels.ops.reset_launch_counts``)
LAUNCHES = {"probe_sorted": 0}


@_cost.counted("probe_sorted", _cost.probe_cost)
def probe_sorted(queries: torch.Tensor, hay_sorted: torch.Tensor
                 ) -> torch.Tensor:
    """queries: (N,); hay_sorted: (H,) sorted, H >= 1, same dtype.
    Returns (N,) int32 membership flags."""
    if queries.dim() != 1 or hay_sorted.dim() != 1 or hay_sorted.shape[0] < 1:
        raise ValueError(f"queries {tuple(queries.shape)} and haystack "
                         f"{tuple(hay_sorted.shape)} must be 1-D, H >= 1")
    if (queries.dtype not in build.KEY_CODES
            or hay_sorted.dtype != queries.dtype):
        raise TypeError(f"queries ({queries.dtype}) and haystack "
                        f"({hay_sorted.dtype}) must share one of int16/"
                        "int32/int64")
    if queries.device != hay_sorted.device:
        raise ValueError("queries and haystack must be on one device")
    if queries.device.type == "cpu":
        return ref.probe_sorted_ref(queries, hay_sorted)
    if (queries.device.type != "cuda" or not queries.is_contiguous()
            or not hay_sorted.is_contiguous()):
        raise ValueError("queries and haystack must be contiguous CPU or "
                         "CUDA tensors")
    n, h = queries.shape[0], hay_sorted.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=queries.device)
    if n:
        build.launch("rt_probe_sorted", queries.device,
                     build.KEY_CODES[queries.dtype], queries.data_ptr(),
                     hay_sorted.data_ptr(), out.data_ptr(), n, h)
        LAUNCHES["probe_sorted"] += 1
    return out
