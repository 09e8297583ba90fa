"""Relational operators on padded narrow-dtype relations (the port of
``repro.engine.ops``).

Rows carry the store dtype (int16/int32/int64); every core reads its PAD
sentinel and key widths off its input tensors.

Execution contracts
-------------------
* **Cores** (``*_core``): plain functions on tensors, with no host
  interaction: nothing in them synchronizes the host, so the fused
  executor captures them in CUDA graphs.  They never choose capacities;
  output capacities are arguments, and data-dependent counts (a join
  total, a merge's valid rows) may be host ints or 0-d tensors.
* **Two-phase host wrappers** (``dedup``/``filter_rows``/``sm_join``/
  ``antijoin``/...) over ``Relation`` values.  A data-dependent size takes a
  count pass, one blocking device->host pull of the count (``.item()``,
  counted in ``HOST_SYNC_STATS.count_pulls``), a host pow-2 bucket choice,
  then the materialize pass.

Sortedness invariant
--------------------
Operators honour ``Relation.sorted_by``: ``dedup``/``antijoin``/``sm_join``
skip their sort pass when an input already carries the needed order, and
``merge_union`` folds a sorted delta into a sorted store with binary
searches instead of a concat-and-resort.  ``SORT_STATS`` counts performed
and skipped sort passes; ``REPRO_SORTED_STORE=0`` turns the fast paths off.

Kernels
-------
The single-key sort (``keysort_core``, and through it single-column
lexsorts), the dedup mask (``dedup_mask_core``) and the single-column
membership probe (``anti_keep_core``, behind the antijoin and
``merge_diff``) go through ``repro_torch.kernels.ops``,
with the same gating as the reference with its kernels on.  On a CUDA tensor
that launches the hand kernels; on a CPU tensor their plain versions run.
Multi-column lexsorts and the merge-union / join searches are torch ops, as
the reference leaves them to XLA.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.engine.relation import (Relation, lex_order, next_pow2,
                                         pad_of)
from repro_torch.kernels import ops as K


def sorted_store_enabled() -> bool:
    """Honor ``sorted_by`` markers (skip redundant sorts, merge unions)."""
    return os.environ.get("REPRO_SORTED_STORE", "1") != "0"


def fused_enabled() -> bool:
    """Route eligible materialization rounds through the fused executor
    (``REPRO_FUSED=1``)."""
    return os.environ.get("REPRO_FUSED", "0") == "1"


def dist_enabled() -> bool:
    """Route eligible materialization through the sharded executor
    (``REPRO_DIST=1``, the same as ``materialize(backend="dist")``)."""
    return os.environ.get("REPRO_DIST", "0") == "1"


def dist_fixpoint_enabled() -> bool:
    """Run linear-tail fixpoint phases of the sharded executor as one loop
    program (on by default; ``REPRO_DIST_FIXPOINT=0`` steps every round
    from the host)."""
    return os.environ.get("REPRO_DIST_FIXPOINT", "1") != "0"


@dataclass
class SortStats:
    """Counts of sort passes performed / avoided."""
    lexsort: int = 0       # full row lexsorts executed
    key_sort: int = 0      # single-key sorts executed (sm_join inputs)
    merges: int = 0        # incremental merge-unions executed
    skipped: int = 0       # sort passes avoided via a sorted_by marker

    def reset(self):
        self.lexsort = self.key_sort = self.merges = self.skipped = 0

    def total_sorts(self) -> int:
        return self.lexsort + self.key_sort


SORT_STATS = SortStats()


@dataclass
class HostSyncStats:
    """Blocking device->host synchronization points: each two-phase wrapper
    pulls its count-pass result once (``count_pulls``); the fused executor
    pulls one scalar bundle per round program and per fixpoint exit
    (``fused_pulls``) and counts its overflow retries (``fused_retries``).
    The sharded executor pulls once per round attempt and once per
    fixpoint exit (``dist_pulls``), counts its host-stepped round retries
    (``dist_retries``), its fixpoint exits (``dist_fixpoint_pulls``) and
    the rounds run inside fixpoint programs (``dist_fixpoint_iters``)."""
    count_pulls: int = 0
    fused_pulls: int = 0
    fused_retries: int = 0
    dist_pulls: int = 0
    dist_retries: int = 0
    dist_fixpoint_pulls: int = 0
    dist_fixpoint_iters: int = 0

    def reset(self):
        self.count_pulls = self.fused_pulls = self.fused_retries = 0
        self.dist_pulls = self.dist_retries = 0
        self.dist_fixpoint_pulls = self.dist_fixpoint_iters = 0

    def snapshot(self) -> "HostSyncStats":
        return replace(self)

    def total(self) -> int:
        return self.count_pulls + self.fused_pulls + self.dist_pulls


HOST_SYNC_STATS = HostSyncStats()


def _pull(n: torch.Tensor) -> int:
    """The one blocking device->host pull of a two-phase wrapper."""
    HOST_SYNC_STATS.count_pulls += 1
    return int(n.item())


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _full(rows: int, ar: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((rows, ar), pad_of(like), dtype=like.dtype,
                      device=like.device)


# ===========================================================================
# cores
# ===========================================================================
def lexsort_core(data):
    """Full-row lexicographic sort of a padded (cap, ar) block (PAD rows sort
    last).  Single-column pow-2 blocks take the sort kernel; arity-2
    int16/int32 rows sort by their packed key."""
    cap, ar = data.shape
    if ar == 1 and _is_pow2(cap):
        return keysort_core(data, 0)
    if ar == 2 and _pack_ok(data.dtype):
        return data[torch.argsort(pack_rows2(data), stable=True)]
    order = torch.argsort(data[:, ar - 1], stable=True)
    for c in reversed(range(ar - 1)):
        order = order[torch.argsort(data[order, c], stable=True)]
    return data[order]


def keysort_core(data, key_col: int):
    """Sort rows of a padded block by one key column (the sort kernel on
    pow-2 caps)."""
    cap = data.shape[0]
    if _is_pow2(cap):
        pos = torch.arange(cap, dtype=torch.int32, device=data.device)
        _, perm = K.sort_with_payload(data[:, key_col].contiguous(), pos,
                                      tile=min(1024, cap))
        return data[perm.long()]
    return data[torch.argsort(data[:, key_col], stable=True)]


def dedup_mask_core(sorted_data):
    """First-occurrence mask over lexsorted rows (PAD rows excluded)."""
    return K.unique_mask(sorted_data).bool()


def filter_mask_core(data, eq_pairs=(), const_pairs=()):
    """Row-selection mask: valid rows meeting column-equality (repeated
    vars) and column-constant constraints."""
    valid = data[:, 0] != pad_of(data)
    for a, b in eq_pairs:
        valid &= data[:, a] == data[:, b]
    for c, v in const_pairs:
        valid &= data[:, c] == v
    return valid


def compact_core(data, mask, out_cap: int):
    """Scatter masked rows to the front of a fresh (out_cap, ar) PAD block,
    keeping their relative order (so sortedness survives compaction).  Rows
    beyond ``out_cap`` are dropped: callers detect that via
    ``sum(mask) > out_cap``."""
    pos = torch.cumsum(mask, 0) - 1
    idx = torch.where(mask & (pos < out_cap), pos, out_cap)
    out = _full(out_cap + 1, data.shape[1], data)
    out[idx] = data
    return out[:out_cap]


def project_core(data, cols):
    """Column gather; invalid (PAD) rows stay fully PAD."""
    valid = data[:, 0] != pad_of(data)
    # column slices, not a list index: that would copy the index to the
    # device and synchronize the host
    out = torch.stack([data[:, c] for c in cols], dim=1)
    return torch.where(valid[:, None], out, pad_of(data))


def join_count_core(ldata, rdata_sorted, lkey: int, rkey: int):
    """Count pass of the sort-merge join: per-left-row match ranges in the
    right block (sorted by ``rkey``).  Returns (total, per, cum, lo)."""
    lk = ldata[:, lkey].contiguous()
    rk = rdata_sorted[:, rkey].contiguous()
    lo = torch.searchsorted(rk, lk, side="left")
    hi = torch.searchsorted(rk, lk, side="right")
    per = torch.where(lk != pad_of(ldata), hi - lo, 0)
    cum = torch.cumsum(per, 0) - per      # exclusive prefix
    return per.sum(), per, cum, lo


def join_gather_core(ldata, rdata, per, cum, lo, total, out_cap: int):
    """Materialize pass: emit [l cols..., r cols...] rows into a
    (out_cap, lar+rar) block; rows past ``total`` (a host int or a 0-d
    tensor) are PAD."""
    lcap, rcap = ldata.shape[0], rdata.shape[0]
    t = torch.arange(out_cap, device=ldata.device)
    # left row for output t: last i with cum[i] <= t
    i = torch.searchsorted(cum + per, t, side="right").clamp(0, lcap - 1)
    j = (lo[i] + (t - cum[i])).clamp(0, rcap - 1)
    out = torch.cat([ldata[i], rdata[j]], dim=1)
    return torch.where((t < total)[:, None], out, pad_of(ldata))


def _range_narrow(col, key, lo, hi):
    """Per-row binary search narrowing [lo, hi) to col == key (col sorted
    within each [lo, hi) range by the lexsort invariant)."""
    n = col.shape[0]
    steps = max(1, int(np.ceil(np.log2(n + 1))))

    def bs(le: bool):
        l, h = lo, hi
        for _ in range(steps):
            mid = (l + h) // 2
            v = col[mid.clamp(0, n - 1)]
            go_right = (v <= key) if le else (v < key)
            in_range = mid < h
            l = torch.where(in_range & go_right, mid + 1, l)
            h = torch.where(in_range & ~go_right, mid, h)
        return l

    return bs(False), bs(True)


def pack_rows2(rows):
    """Pack (cap, 2) int16/int32 rows into one double-width key per row:
    column 0 in the high word, column 1 as the unsigned low word (the
    reference's little-endian bitcast of ``[col1, col0]``).  Dictionary ids
    are non-negative and PAD is the dtype max, so packed PAD rows stay
    lex-maximal; skolem nulls (negative) in column 1 order after every
    constant."""
    c0, c1 = rows[:, 0].long(), rows[:, 1].long()
    if rows.dtype == torch.int16:
        return (c0 * (1 << 16) + (c1 & 0xFFFF)).to(torch.int32)
    return c0 * (1 << 32) + (c1 & 0xFFFFFFFF)


def lex_range_core(hay_sorted, probe):
    """Per-probe-row [lo, hi) occurrence range in a lexsorted haystack."""
    m = probe.shape[0]
    lo = torch.zeros(m, dtype=torch.int64, device=probe.device)
    hi = torch.full((m,), hay_sorted.shape[0], dtype=torch.int64,
                    device=probe.device)
    for c in range(hay_sorted.shape[1]):
        lo, hi = _range_narrow(hay_sorted[:, c], probe[:, c], lo, hi)
    return lo, hi


def _pack_ok(dtype) -> bool:
    """Arity-2 int16 rows pack into int32 keys and int32 rows into int64;
    int64 rows have no 128-bit key and take the per-column searches."""
    return dtype in (torch.int16, torch.int32)


def _lex_keys(hay, probe):
    """Order-preserving scalar keys for rows of arity <= 2, else None."""
    if hay.shape[1] == 1:
        return hay[:, 0].contiguous(), probe[:, 0].contiguous()
    if hay.shape[1] == 2 and _pack_ok(hay.dtype):
        return pack_rows2(hay), pack_rows2(probe)
    return None


def _lex_searchsorted_right(hay, probe):
    """Rightmost insertion positions of each ``probe`` row in lexsorted
    ``hay``."""
    keys = _lex_keys(hay, probe)
    if keys is not None:
        return torch.searchsorted(keys[0], keys[1], side="right")
    return lex_range_core(hay, probe)[1]


def member_mask_core(probe_rows, hay_sorted):
    """Row membership of each probe row in a lexsorted haystack (PAD probe
    rows report non-member)."""
    valid = probe_rows[:, 0] != pad_of(probe_rows)
    keys = _lex_keys(hay_sorted, probe_rows)
    if keys is not None:
        hk, pk = keys
        n = hk.shape[0]
        idx = torch.searchsorted(hk, pk)
        found = (hk[idx.clamp(0, n - 1)] == pk) & (idx < n)
        return found & valid
    lo, hi = lex_range_core(hay_sorted, probe_rows)
    return (hi > lo) & valid


def anti_keep_core(data, hay_sorted, cols):
    """Keep-mask for the antijoin: valid rows of ``data`` whose ``cols``
    tuple does NOT occur in the lexsorted haystack.  A single-column probe
    of a single-column haystack, both caps pow-2, takes the probe kernel."""
    valid = data[:, 0] != pad_of(data)
    if (hay_sorted.shape[1] == 1 and len(cols) == 1
            and _is_pow2(data.shape[0]) and _is_pow2(hay_sorted.shape[0])):
        found = K.probe_sorted(data[:, cols[0]], hay_sorted[:, 0]) != 0
    else:
        found = member_mask_core(project_core(data, cols), hay_sorted)
    return valid & ~found


def merge_diff_core(A, B_sorted, out_cap: int):
    """Sorted set-difference: rows of block A (lexsorted) minus rows of
    lexsorted block B, compacted into a fresh (out_cap, ar) PAD block.
    Every A row is one membership probe into B (the probe kernel on
    arity-1 pow-2 blocks), no sort pass, and compaction keeps A's order.
    Returns (out, n_kept); overflow is ``n_kept > out_cap``, checked by
    the caller."""
    keep = anti_keep_core(A, B_sorted, tuple(range(A.shape[1])))
    return compact_core(A, keep, out_cap), keep.sum()


def merge_core(A, B, na, nb):
    """Merge sorted block B (bcap rows, nb valid) into sorted block A
    (out_cap rows, na valid); ties place the A run first.  ``na`` / ``nb``
    are host ints or 0-d tensors.  Only B is binary-searched: output slot
    of B[i] = i + p_i where p_i = #{A lex<= B[i]}, and output slot of A[j]
    = j + #{i : p_i <= j}.  Overflow is ``na + nb > A.shape[0]``, checked
    by the caller."""
    out_cap, ar = A.shape
    bcap = B.shape[0]
    ia = torch.arange(out_cap, device=A.device)
    ib = torch.arange(bcap, device=A.device)
    valid_b = ib < nb
    # insertion position of each B row AFTER any equal A rows; PAD rows are
    # lex-max so p only counts valid A rows
    p = _lex_searchsorted_right(A, B)
    # B's valid rows come first and in order, so their p are sorted, and
    # #{valid B rows lex< A[j]} is one binary search per A row (no
    # histogram: torch.bincount reads its maximum to the host, and atomics
    # into one bin for every PAD row serialize on the card)
    cnt = torch.searchsorted(torch.where(valid_b, p, out_cap + 1), ia,
                             right=True)
    # on overflow (na + nb > out_cap, the caller's check) slots past the
    # block land in the dump row out_cap rather than out of bounds
    pos_a = torch.where(ia < na, ia + cnt, out_cap).clamp_(max=out_cap)
    pos_b = torch.where(valid_b, ib + p, out_cap).clamp_(max=out_cap)
    out = _full(out_cap + 1, ar, A)
    out[pos_a] = A
    out[pos_b] = B
    return out[:out_cap]


# ===========================================================================
# two-phase host wrappers over the cores
# ===========================================================================
def _empty(arity: int, like: Relation) -> Relation:
    return Relation.empty(arity, dtype=like.dtype, device=like.device)


def lexsort_rows(rel: Relation) -> Relation:
    order = lex_order(rel.arity)
    if sorted_store_enabled() and rel.sorted_by == order:
        SORT_STATS.skipped += 1
        return rel
    data = lexsort_core(rel.data)
    SORT_STATS.lexsort += 1
    return Relation(data, rel.count, order)


def dedup(rel: Relation) -> Relation:
    """Sort (skipped on a lexsorted input) + adjacent-unique + compact.
    Output is lexsorted and marked."""
    if rel.count == 0:
        return _empty(rel.arity, rel)
    s = lexsort_rows(rel)
    mask = dedup_mask_core(s.data)
    n = _pull(mask.sum())
    out = compact_core(s.data, mask, next_pow2(n))
    return Relation(out, n, lex_order(rel.arity))


def filter_rows(rel: Relation, eq_pairs=(), const_pairs=()) -> Relation:
    """Select rows with col equality (repeated vars) / constant constraints.
    Compaction keeps row order, so the sortedness marker is preserved."""
    if rel.count == 0 or (not eq_pairs and not const_pairs):
        return rel
    mask = filter_mask_core(rel.data, eq_pairs, const_pairs)
    n = _pull(mask.sum())
    out = compact_core(rel.data, mask, next_pow2(n))
    return Relation(out, n, rel.sorted_by)


def project(rel: Relation, cols) -> Relation:
    if not cols:
        cols = (0,)
    return Relation(project_core(rel.data, tuple(cols)), rel.count)


def sort_by(rel: Relation, key_col: int) -> Relation:
    """Sort by one key column; skipped when ``sorted_by`` already starts with
    that column (a lexsorted relation is sorted by its primary column)."""
    if (sorted_store_enabled() and rel.sorted_by
            and rel.sorted_by[0] == key_col):
        SORT_STATS.skipped += 1
        return rel
    data = keysort_core(rel.data, key_col)
    SORT_STATS.key_sort += 1
    return Relation(data, rel.count, (key_col,))


def sm_join(l: Relation, r: Relation, lkey: int, rkey: int):
    """Sort-merge join; returns (Relation out, matches) where out columns are
    [l cols..., r cols...] and ``matches`` is the trigger count.  Input sorts
    are skipped for relations already sorted by their join key."""
    if l.count == 0 or r.count == 0:
        return _empty(l.arity + r.arity, l), 0
    ls = sort_by(l, lkey)
    rs = sort_by(r, rkey)
    total, per, cum, lo = join_count_core(ls.data, rs.data, lkey, rkey)
    total = _pull(total)
    if total == 0:
        return _empty(l.arity + r.arity, l), 0
    out = join_gather_core(ls.data, rs.data, per, cum, lo, total,
                           next_pow2(total))
    return Relation(out, total), total


def cross(l: Relation, r: Relation):
    """Cartesian product (rare in practice; needed for disconnected
    bodies)."""
    if l.count == 0 or r.count == 0:
        return _empty(l.arity + r.arity, l), 0
    total = l.count * r.count
    li = torch.arange(l.count, device=l.device).repeat_interleave(r.count)
    ri = torch.arange(r.count, device=l.device).repeat(l.count)
    out = _full(next_pow2(total), l.arity + r.arity, l.data)
    out[:total] = torch.cat([l.data[li], r.data[ri]], dim=1)
    return Relation(out, total), total


def _masked_compact(rel: Relation, keep) -> Relation:
    """Second phase of the antijoin / semijoin: pull the kept count and
    compact, keeping ``rel`` itself when nothing was dropped."""
    n = _pull(keep.sum())
    if n == rel.count:
        return rel
    return Relation(compact_core(rel.data, keep, next_pow2(n)), n,
                    rel.sorted_by)


def antijoin(rel: Relation, hay: Relation, cols=None) -> Relation:
    """Rows of rel whose ``cols``-tuple is NOT in hay.  The haystack lexsort
    is skipped when ``hay`` carries the full-lexsort marker (the store
    invariant); the output keeps ``rel``'s marker."""
    if rel.count == 0 or hay.count == 0:
        return rel
    cols = tuple(cols) if cols is not None else tuple(range(rel.arity))
    if len(cols) != hay.arity:
        raise ValueError(f"antijoin on {len(cols)} columns against an "
                         f"arity-{hay.arity} haystack")
    hs = lexsort_rows(hay)
    return _masked_compact(rel, anti_keep_core(rel.data, hs.data, cols))


def semijoin(rel: Relation, hay: Relation, cols=None) -> Relation:
    """Rows of rel whose ``cols``-tuple IS in hay (the antijoin's
    complement), with the same sortedness contract."""
    if rel.count == 0 or hay.count == 0:
        return _empty(rel.arity, rel)
    cols = tuple(cols) if cols is not None else tuple(range(rel.arity))
    if len(cols) != hay.arity:
        raise ValueError(f"semijoin on {len(cols)} columns against an "
                         f"arity-{hay.arity} haystack")
    hs = lexsort_rows(hay)
    valid = rel.data[:, 0] != pad_of(rel.data)
    keep = valid & member_mask_core(project_core(rel.data, cols), hs.data)
    return _masked_compact(rel, keep)


def union(a: Relation, b: Relation, dedupe: bool = True) -> Relation:
    """Concat-union.  With ``dedupe`` the result is lexsorted (dedup sorts);
    without, the concatenation clears any sortedness marker."""
    if a.count == 0:
        return b
    if b.count == 0:
        return a
    n = a.count + b.count
    data = _full(next_pow2(n), a.arity, a.data)
    data[:a.count] = a.data[:a.count]
    data[a.count:n] = b.data[:b.count]
    out = Relation(data, n)
    return dedup(out) if dedupe else out


def fit_rows(data, out_cap: int):
    """Slice or PAD-extend to ``out_cap`` rows (rows >= count are PAD either
    way)."""
    cap = data.shape[0]
    if cap == out_cap:
        return data
    if cap > out_cap:
        return data[:out_cap]
    return torch.cat([data, _full(out_cap - cap, data.shape[1], data)])


def merge_union(a: Relation, b: Relation) -> Relation:
    """Incremental sorted union of two DISJOINT row sets: binary searches
    place every row, instead of concat + full resort.  Inputs are lexsorted
    first (free when they carry the marker); the output is lexsorted and
    marked."""
    if a.arity != b.arity:
        raise ValueError(f"merge_union of arities {a.arity} and {b.arity}")
    if b.count == 0:
        return lexsort_rows(a)
    if a.count == 0:
        return lexsort_rows(b)
    if b.count > a.count:   # search the smaller side into the larger
        a, b = b, a
    a = lexsort_rows(a)
    b = lexsort_rows(b)
    n = a.count + b.count
    out_cap = next_pow2(n)
    out = merge_core(fit_rows(a.data, out_cap), b.data, a.count, b.count)
    SORT_STATS.merges += 1
    return Relation(out, n, lex_order(a.arity))


def merge_diff(a: Relation, b: Relation) -> Relation:
    """Incremental sorted set-difference ``a - b`` (full rows), the deletion
    counterpart of ``merge_union``: both sides are lexsorted first (free when
    they carry the marker), every ``a`` row is one membership probe into
    ``b``, and the surviving rows compact in place; the store is never
    re-sorted.  The output keeps ``a``'s capacity (the difference always
    fits) and is lexsorted and marked."""
    if a.arity != b.arity:
        raise ValueError(f"merge_diff of arities {a.arity} and {b.arity}")
    if a.count == 0 or b.count == 0:
        return lexsort_rows(a)
    a = lexsort_rows(a)
    b = lexsort_rows(b)
    out, n = merge_diff_core(a.data, b.data, a.capacity)
    n = _pull(n)
    SORT_STATS.merges += 1
    return Relation(out, n, lex_order(a.arity))
