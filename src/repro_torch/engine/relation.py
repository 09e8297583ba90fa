"""Padded fixed-capacity relations over torch tensors, with pow-2 capacity
bucketing (the port of ``repro.engine.relation``).

A ``Relation`` holds ``data``, a (capacity, arity) integer tensor on the
KB's device, and a host-side fill ``count``.  Rows past ``count`` are
padding: every column holds the dtype's max value (PAD), so padding sorts
last under every comparator the engine uses.  Data-dependent output sizes
follow the two-phase pattern of ``repro_torch.engine.ops``: a count pass,
one device->host pull of the count, a host pow-2 bucket choice, then the
materialize pass.

Store dtype
-----------
``REPRO_STORE_DTYPE`` (``int16`` / ``int32`` (default) / ``int64``) picks
the dtype of dictionary ids and relation columns.  torch keeps int64 as it
is, so the wide store needs no process flag.  The dictionary reserves PAD:
ids stay strictly below it, and negative ids are skolem nulls.

Sortedness invariant
--------------------
``sorted_by`` records the column order by which the valid rows are known to
be sorted (``None`` = unknown).  A full lexsort is ``tuple(range(arity))``
and a single-key sort from ``ops.sort_by`` is ``(key_col,)``.  Ops that only
drop rows in place keep the marker; ops that reorder or merge set or clear
it.  Arity-2 rows of int16/int32 stores are ordered by their packed key
(``ops.pack_rows2``), in which column 1 compares as unsigned; ``host_order``
gives the same order on host rows.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

STORE_DTYPES = {
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
}

_TORCH_DTYPE = {
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def store_dtype() -> np.dtype:
    """The process-default store dtype (``REPRO_STORE_DTYPE``, default
    int32)."""
    name = os.environ.get("REPRO_STORE_DTYPE", "int32")
    dt = STORE_DTYPES.get(name)
    if dt is None:
        raise ValueError(f"REPRO_STORE_DTYPE={name!r}: expected one of "
                         f"{sorted(STORE_DTYPES)}")
    return dt


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a store dtype given as a numpy dtype or name."""
    return _TORCH_DTYPE[np.dtype(dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


def pad_value(dtype) -> int:
    """The PAD sentinel of a store dtype (numpy or torch): its max value."""
    if isinstance(dtype, torch.dtype):
        return int(torch.iinfo(dtype).max)
    return int(np.iinfo(np.dtype(dtype)).max)


def pad_of(data: torch.Tensor) -> int:
    """PAD sentinel for a tensor's dtype."""
    return pad_value(data.dtype)


def id_range(dtype) -> Tuple[int, int]:
    """(min, max) dictionary-id range representable in a store dtype: the
    PAD sentinel (dtype max) is reserved, negative ids are skolem nulls."""
    info = np.iinfo(np.dtype(dtype))
    return int(info.min), int(info.max) - 1


def resolve_device(device=None) -> torch.device:
    """The device of a store: ``cuda`` unless the caller names one.  Raises
    when the default is asked for and no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; "
                               "pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def lex_order(arity: int) -> Tuple[int, ...]:
    """The ``sorted_by`` marker of a fully lexsorted relation."""
    return tuple(range(arity))


def host_order(rows: np.ndarray) -> np.ndarray:
    """Row permutation that puts host rows in the engine's lexsort order:
    signed lexicographic, except that arity-2 int16/int32 rows order column
    1 as unsigned (the packed-key order of ``ops.lexsort_core``)."""
    if rows.shape[0] == 0:
        return np.arange(0)
    cols = [rows[:, c] for c in range(rows.shape[1])]
    if rows.shape[1] == 2 and rows.dtype in (np.int16, np.int32):
        cols[1] = cols[1].view(np.dtype(f"u{rows.dtype.itemsize}"))
    return np.lexsort(cols[::-1])


@dataclass
class Relation:
    data: torch.Tensor       # (capacity, arity) ints, rows >= count are PAD
    count: int               # python int (host-side fill level)
    sorted_by: Optional[Tuple[int, ...]] = None  # known sort order, or None

    @property
    def capacity(self):
        return self.data.shape[0]

    @property
    def arity(self):
        return self.data.shape[1]

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self.data.dtype)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def pad(self) -> int:
        return pad_of(self.data)

    @property
    def is_lexsorted(self) -> bool:
        """True iff the relation carries the full-lexsort marker."""
        return self.sorted_by == lex_order(self.arity)

    def np_rows(self) -> np.ndarray:
        return self.data[:self.count].cpu().numpy()

    @staticmethod
    def from_numpy(rows: np.ndarray, capacity: int = 0,
                   sorted_by: Optional[Tuple[int, ...]] = None,
                   dtype=None, device=None) -> "Relation":
        """Build a padded relation on ``device`` (default ``cuda``; raises
        if there is none) from host rows.

        ``dtype``: target store dtype — defaults to the rows' own dtype when
        that is a supported store dtype, else the process default.  A
        narrowing conversion range-checks the rows and raises
        ``OverflowError`` instead of silently corrupting keys."""
        device = resolve_device(device)
        rows = np.asarray(rows)
        if dtype is None:
            if rows.dtype in STORE_DTYPES.values():
                dtype = rows.dtype
            else:
                dtype = store_dtype()
        dtype = np.dtype(dtype)
        n = rows.shape[0]
        if n and rows.dtype != dtype and np.issubdtype(rows.dtype,
                                                       np.integer):
            lo, hi = id_range(dtype)
            rmin, rmax = int(rows.min()), int(rows.max())
            if rmin < lo or rmax > hi:
                raise OverflowError(
                    f"rows [{rmin}, {rmax}] exceed the {dtype} store id "
                    f"range [{lo}, {hi}]")
        cap = max(next_pow2(n), 1, capacity)
        arity = rows.shape[1] if rows.ndim == 2 else 1
        data = np.full((cap, arity), pad_value(dtype), dtype)
        if n:
            data[:n] = rows.reshape(n, arity)
        return Relation(torch.from_numpy(data).to(device), n, sorted_by)

    @staticmethod
    def empty(arity: int, capacity: int = 1, dtype=None,
              device=None) -> "Relation":
        device = resolve_device(device)
        dtype = np.dtype(dtype) if dtype is not None else store_dtype()
        # an empty relation is trivially sorted by any order
        return Relation(torch.full((max(capacity, 1), arity),
                                   pad_value(dtype), dtype=torch_dtype(dtype),
                                   device=device),
                        0, lex_order(arity))

    def rows_set(self):
        return {tuple(int(x) for x in r) for r in self.np_rows()}
