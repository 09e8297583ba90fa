"""Tile sort and pairwise merge of int16/int32/int64 keys carrying an
int32 payload: wrappers over ``csrc/bitonic_sort.cu``.

Replaces the Pallas kernels ``bitonic_sort_tiles`` and ``bitonic_merge_pairs``
(``src/repro/kernels/bitonic_sort.py``, bodies ``_bitonic_kernel`` and
``_merge_kernel``).  The names stay so that the counterparts are easy to
find; on the card neither is a bitonic network any more.

Both kernels rest on one merge-path co-rank search.  The tile sort is a
block merge sort, one CTA per tile: each thread sorts 8 pairs in registers,
then log2(tile / 8) merge rounds run in shared memory, one barrier each.
The merge is one pass at every width: each CTA owns a span of outputs,
loads the slices of the two halves that feed it and merges them in shared
memory.  Above the span's width a small kernel first co-ranks every span
boundary into scratch that the wrapper allocates.

Bound on the card: device-memory bytes.  Each call reads every key and
payload once and writes them once, so a full sort of n keys from tile 1024
is 1 + log2(n / 1024) passes.

Pairs are ordered by (key, payload), so with positions as the payload the
result is that of a stable sort, on the card and in the plain versions
(``kernels.ref``) alike.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import build, ref

# kernel launches since the last reset (``kernels.ops.reset_launch_counts``)
LAUNCHES = {"bitonic_sort_tiles": 0, "bitonic_merge_pairs": 0}


@functools.cache
def merge_span() -> int:
    """Outputs per CTA of the merge kernel: wider merges first co-rank every
    span boundary."""
    return build.library().rt_merge_span()


def _check(keys: torch.Tensor, vals: torch.Tensor, block: int) -> None:
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and payload "
                         f"{tuple(vals.shape)} must be equal-length 1-D")
    if keys.dtype not in build.KEY_CODES:
        raise TypeError(f"keys must be int16/int32/int64, got {keys.dtype}")
    if vals.dtype != torch.int32:
        raise TypeError(f"payload must be int32, got {vals.dtype}")
    if keys.device != vals.device or keys.device.type not in ("cpu", "cuda"):
        raise ValueError("keys and payload must be on one CPU or CUDA "
                         "device")
    if block < 1 or block & (block - 1) or keys.shape[0] % block:
        raise ValueError(f"block {block} must be a power of two dividing "
                         f"{keys.shape[0]}")
    if keys.device.type == "cuda" and not (keys.is_contiguous()
                                           and vals.is_contiguous()):
        raise ValueError("keys and payload must be contiguous")


@_cost.counted("bitonic_sort_tiles",
                lambda keys, vals, tile: _cost.sort_call_cost(keys))
def bitonic_sort_tiles(keys: torch.Tensor, vals: torch.Tensor, tile: int):
    """Sort each (tile,) block of keys and payload independently."""
    _check(keys, vals, tile)
    if keys.device.type == "cpu":
        return ref.sort_tiles_ref(keys, vals, tile)
    smem_block = build.library().rt_smem_block()
    if tile > smem_block:
        raise ValueError(f"tile {tile} exceeds the shared-memory block "
                         f"{smem_block}")
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    if keys.shape[0]:
        build.launch("rt_sort_tiles", keys.device,
                     build.KEY_CODES[keys.dtype], keys.data_ptr(),
                     vals.data_ptr(), ko.data_ptr(), vo.data_ptr(),
                     keys.shape[0], tile)
        LAUNCHES["bitonic_sort_tiles"] += 1
    return ko, vo


@_cost.counted("bitonic_merge_pairs",
                lambda keys, vals, width: _cost.sort_call_cost(keys))
def bitonic_merge_pairs(keys: torch.Tensor, vals: torch.Tensor, width: int):
    """Merge adjacent sorted blocks of width//2 into sorted blocks of
    width."""
    _check(keys, vals, width)
    if width < 2:
        raise ValueError(f"merge width {width} must be at least 2")
    if keys.device.type == "cpu":
        return ref.merge_pairs_ref(keys, vals, width)
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    n = keys.shape[0]
    if n:
        span = merge_span()
        cuts = (torch.empty(-(-n // span), dtype=torch.int64,
                            device=keys.device) if width > span else None)
        build.launch("rt_merge_pairs", keys.device,
                     build.KEY_CODES[keys.dtype], keys.data_ptr(),
                     vals.data_ptr(), ko.data_ptr(), vo.data_ptr(), n,
                     width, None if cuts is None else cuts.data_ptr())
        LAUNCHES["bitonic_merge_pairs"] += 1
    return ko, vo
