"""Kernel entry points the engine calls, with the reference's edge-shape
contract (``repro.kernels.ops``).

Dispatch follows the tensor's device: a CUDA tensor launches the hand
kernels in ``csrc/`` (or raises), a CPU tensor takes their plain versions
in ``kernels.ref``.  The shape handling around the kernels is the same on
both, so the CPU tests reach it:

* empty inputs return at once;
* non-pow-2 sort lengths are padded to the next power of two with the key
  dtype's max and sorted with POSITIONS as the payload; the synthetic
  entries are dropped and the caller's payload is gathered back, so the
  returned payload is always a permutation of the caller's;
* on the card a pow-2 sort is the tile sort and the merges at widths
  doubling to n; on the CPU it is their plain version, one sort of the
  (key, payload) pairs;
* tiles are clamped to pow-2 divisors of the padded length.

Launch counts: each wrapper adds one to its kernel's count where it
launches the kernel on a CUDA tensor.  Under CUDA graph capture a wrapper
call records a launch instead of making one, so the fused executor takes
the calls of a warm-up run and of the capture back out of the counts
(``uncounted``) and adds the captured launches once per replay
(``add_launches``).  The cost walk (``repro_torch.analysis.cost``) is
kept the same way: ``uncounted`` holds the block's count apart, and
``add_launches`` adds it per replay.  A pow-2 sort counts its ladder, the
tile sort and one merge per doubling width, on either device.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.engine.relation import next_pow2
from repro_torch.kernels import bitonic_sort as BS
from repro_torch.kernels import hash_probe as HP
from repro_torch.kernels import ref
from repro_torch.kernels import unique_mask as UM

_COUNTERS = (BS.LAUNCHES, UM.LAUNCHES, HP.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` replays of a captured graph that holds ``counts``
    launches per kernel (and, under a cost recorder, its count)."""
    for c in _COUNTERS:
        for k in c:
            c[k] += counts.get(k, 0) * times
    if _cost.ACTIVE is not None:
        _cost.add(getattr(counts, "cost", None), times)


class Made(dict):
    """Launches per kernel made in an ``uncounted`` block; ``cost`` is
    the block's count when a cost recorder was active, else None."""
    cost = None


@contextlib.contextmanager
def uncounted():
    """Wrapper calls inside the block leave the counts as they were; the
    yielded dict holds, after the block, the calls made in it per kernel.
    The cost walk leaves the block out too, and keeps its count in the
    dict's ``cost``."""
    before = launch_counts()
    made = Made()
    with contextlib.ExitStack() as stack:
        if _cost.counting():
            made.cost = stack.enter_context(
                _cost.Recorder(propagate=False)).cost
        try:
            yield made
        finally:
            after = launch_counts()
            made.update({k: after[k] - before[k] for k in after})
            for c in _COUNTERS:
                for k in c:
                    c[k] = before[k]


def _pow2_tile(tile: int, n: int) -> int:
    """Largest pow-2 tile <= min(tile, n); n must itself be pow-2."""
    t = max(1, min(tile, n))
    return 1 << (t.bit_length() - 1)


def _ladder_cost(keys, tile: int) -> dict:
    """The kernel calls of one pow-2 sort: the tile sort, then a merge at
    every width from 2 tile to n."""
    per = _cost.sort_call_cost(keys)
    merges = (keys.shape[0] // tile).bit_length() - 1
    out = {"bitonic_sort_tiles": (1, *per)}
    if merges:
        out["bitonic_merge_pairs"] = (merges, *per)
    return out


def _sort_pow2(keys, vals, tile: int):
    if _cost.ACTIVE is not None:
        return _cost.kernel("sort_with_payload", _ladder_cost(keys, tile),
                            _sort_ladder, keys, vals, tile, sorts=1)
    return _sort_ladder(keys, vals, tile)


def _sort_ladder(keys, vals, tile: int):
    if keys.device.type == "cpu":
        # the plain version of the whole ladder: one sort of the pairs
        BS._check(keys, vals, tile)
        return ref.sort_with_payload_ref(keys, vals)
    keys, vals = BS.bitonic_sort_tiles(keys, vals, tile)
    width = tile * 2
    while width <= keys.shape[0]:
        keys, vals = BS.bitonic_merge_pairs(keys, vals, width)
        width *= 2
    return keys, vals


def sort_with_payload(keys: torch.Tensor, vals: torch.Tensor,
                      tile: int = 1024):
    """Full sort of (n,) int16/int32/int64 keys carrying a payload: the
    tile-sort kernel, then the pairwise merges at widths doubling to n.  On
    pow-2 lengths the payload rides the network and must be int32."""
    n = keys.shape[0]
    if n == 0:
        return keys, vals
    m = next_pow2(n)
    t = _pow2_tile(tile, m)
    if m == n:
        return _sort_pow2(keys.contiguous(), vals.contiguous(), t)
    sentinel = torch.iinfo(keys.dtype).max
    keys_p = torch.cat([keys, keys.new_full((m - n,), sentinel)])
    pos = torch.arange(m, dtype=torch.int32, device=keys.device)
    keys_p, pos = _sort_pow2(keys_p, pos, t)
    # (key, position) order puts every synthetic entry (sentinel key,
    # position >= n) after every real one, so dropping them is keeping the
    # first n slots
    return keys_p[:n], vals[pos[:n].long()]


def unique_mask(data: torch.Tensor) -> torch.Tensor:
    """(N, C) lexsorted rows -> (N,) int32 first-occurrence mask of the
    valid rows."""
    if data.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    return UM.unique_mask(data.contiguous())


def probe_sorted(queries: torch.Tensor, hay_sorted: torch.Tensor
                 ) -> torch.Tensor:
    """(N,) queries -> (N,) int32 membership flags in a sorted haystack."""
    n = queries.shape[0]
    if n == 0 or hay_sorted.shape[0] == 0:
        return torch.zeros(n, dtype=torch.int32, device=queries.device)
    return HP.probe_sorted(queries.contiguous(), hay_sorted.contiguous())
