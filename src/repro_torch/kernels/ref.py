"""Plain PyTorch versions of the port's kernels.

The kernel wrappers take these for tensors on the CPU, the CPU tests hold
the port against the reference with them, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.

The sorts order (key, payload) pairs lexicographically, as the CUDA bitonic
network does, so kernel and plain version agree element for element; with
row positions as the payload that is a stable sort by key.
"""
from __future__ import annotations

import torch

from repro_torch.engine.relation import pad_of


def _pair_order(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Indices that sort (key, payload) pairs along the last dimension."""
    by_val = torch.argsort(vals, dim=-1, stable=True)
    by_key = torch.argsort(torch.gather(keys, -1, by_val), dim=-1,
                           stable=True)
    return torch.gather(by_val, -1, by_key)


def sort_with_payload_ref(keys, vals):
    """Full sort of keys carrying a payload."""
    order = _pair_order(keys, vals)
    return keys[order], vals[order]


def sort_tiles_ref(keys, vals, tile: int):
    """Sort each (tile,) block independently."""
    n = keys.shape[0]
    kk = keys.reshape(n // tile, tile)
    vv = vals.reshape(n // tile, tile)
    order = _pair_order(kk, vv)
    return (torch.gather(kk, 1, order).reshape(n),
            torch.gather(vv, 1, order).reshape(n))


def merge_pairs_ref(keys, vals, width: int):
    """Adjacent sorted blocks of width//2 merged into sorted blocks of
    width."""
    return sort_tiles_ref(keys, vals, width)


def unique_mask_ref(data):
    """mask[i] = 1 iff row i is valid (column 0 is not PAD) and differs
    from row i-1; row 0 counts as differing.  PAD is the data's own dtype
    max (the reference oracle compares against the int32 PAD whatever the
    dtype)."""
    pad = pad_of(data)
    prev = torch.cat([torch.full((1, data.shape[1]), pad, dtype=data.dtype,
                                 device=data.device), data[:-1]])
    neq = torch.any(data != prev, dim=1)
    neq[0] = True
    valid = data[:, 0] != pad
    return (neq & valid).to(torch.int32)


def probe_sorted_ref(queries, hay_sorted):
    """Membership flag of each query in a non-empty sorted haystack."""
    h = hay_sorted.shape[0]
    idx = torch.searchsorted(hay_sorted, queries)
    found = hay_sorted[idx.clamp(0, h - 1)] == queries
    return (found & (idx < h)).to(torch.int32)
