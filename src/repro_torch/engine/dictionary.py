"""Dictionary encoding of constants/nulls to narrow integer ids (GLog
stores terms via Trident's dictionary; we do the same at ingest).

The port's own copy of ``repro.engine.dictionary``: it hands out the same
constant and skolem ids, decodes nulls the same way, and its
``state_dict()`` / ``load_state()`` / ``mark()`` / ``rollback()`` states
are interchangeable with the reference's.  It is host-side numpy only.

Ids:
* constants: 0 .. n-1 (interned terms)
* skolem nulls: negative ids, allocated per (rule, exvar, frontier tuple) —
  matching the skolem chase the engine implements for existential rules.

Null id ``-k`` decodes to the dedicated ``Null(k)`` sentinel (never to a
string), so a genuine constant that happens to be named like a null (e.g.
``"_sk1"``) can never collide with a labelled null: ``decode`` is injective
over all allocated ids and ``encode(decode(i)) == i`` for every id the
dictionary has handed out.

Id dtype
--------
The dictionary is bound to a store dtype (default: the process
``REPRO_STORE_DTYPE``) and enforces its id range *at ingest*: the dtype's
max value is the engine's PAD sentinel and is never handed out, and an
``OverflowError`` is raised the moment an id (constant or null) would leave
the representable range — ids that silently wrap would corrupt sort keys
downstream, which is strictly worse than failing the load.

Bulk ingest
-----------
``encode_columns`` vectorizes interning over ndarray columns with one
``np.unique`` pass: the python-level dict lookup runs once per *distinct*
term, not once per occurrence — the difference between the ingest loop and
the engine being the bottleneck at 10^7+ facts.  ``encode_many`` routes
large batches through it automatically.

Integer terms never touch the python dict at all: they live in a pair of
sorted numpy arrays (value-sorted for interning via ``searchsorted``,
id-sorted for ``decode``), so a 10^7-row all-integer stream costs a few
numpy merges and ~16 bytes per distinct term instead of ~100+ bytes of
CPython dict/object overhead per term — at scale the dictionary would
otherwise dominate peak RSS regardless of the store dtype.  Routing is by
*value*, not input dtype: a python ``int``, a ``np.int32`` scalar and an
object-array cell holding the same value all intern to the same id (ints
too wide for int64 fall back to the generic dict store).
"""
from __future__ import annotations

from typing import Dict, Hashable

import numpy as np

from repro_torch.core.terms import Null
from repro_torch.engine.relation import id_range, store_dtype

# encode_many batches at least this long take the vectorized np.unique path
_BULK_THRESHOLD = 64


class Dictionary:
    def __init__(self, id_dtype=None):
        self.id_dtype = (np.dtype(id_dtype) if id_dtype is not None
                         else store_dtype())
        self._min_id, self._max_id = id_range(self.id_dtype)
        self._n_terms = 0                       # total ids handed out
        self._to_id: Dict[Hashable, int] = {}   # non-integer term -> id
        self._from_id: Dict[int, Hashable] = {}  # id -> non-integer term
        # integer-term store: (_int_vals, _int_ids) sorted by value for
        # interning, (_dec_ids, _dec_vals) sorted by id for decode (ids grow
        # monotonically, so per-batch appends keep it sorted)
        self._int_vals = np.empty(0, np.int64)
        self._int_ids = np.empty(0, np.int64)
        self._dec_ids = np.empty(0, np.int64)
        self._dec_vals = np.empty(0, np.int64)
        self._skolem: Dict[tuple, int] = {}
        self._next_null = -1

    def _check_capacity(self, needed_max: int) -> None:
        if needed_max > self._max_id:
            raise OverflowError(
                f"dictionary id {needed_max} exceeds the {self.id_dtype} "
                f"store id range [0, {self._max_id}] (PAD is reserved); "
                "use a wider REPRO_STORE_DTYPE")

    def _intern_ints_unique(self, uniq: np.ndarray) -> np.ndarray:
        """ids for a SORTED-UNIQUE int64 value array, interning new values.
        Batch-checks capacity before mutating anything."""
        n = len(self._int_vals)
        pos = np.searchsorted(self._int_vals, uniq)
        if n:
            safe = np.minimum(pos, n - 1)
            known = (pos < n) & (self._int_vals[safe] == uniq)
        else:
            known = np.zeros(len(uniq), dtype=bool)
        ids = np.empty(len(uniq), np.int64)
        if known.any():
            ids[known] = self._int_ids[pos[known]]
        new = ~known
        n_new = int(new.sum())
        if n_new:
            self._check_capacity(self._n_terms + n_new - 1)
            new_ids = np.arange(self._n_terms, self._n_terms + n_new,
                                dtype=np.int64)
            ids[new] = new_ids
            new_vals = uniq[new]
            self._int_vals = np.insert(self._int_vals, pos[new], new_vals)
            self._int_ids = np.insert(self._int_ids, pos[new], new_ids)
            self._dec_ids = np.concatenate([self._dec_ids, new_ids])
            self._dec_vals = np.concatenate([self._dec_vals, new_vals])
            self._n_terms += n_new
        return ids

    def encode(self, term) -> int:
        if isinstance(term, Null):
            # only engine-allocated nulls round-trip; a fabricated Null id
            # could collide with a future skolem allocation
            if not 1 <= term.nid <= self.num_nulls:
                raise ValueError(f"unknown null {term!r}: nulls are allocated "
                                 "by Dictionary.skolem, not encoded from the "
                                 "outside")
            return -term.nid
        if isinstance(term, (int, np.integer)):
            try:
                v = np.int64(term)
            except (OverflowError, ValueError):
                pass    # wider than int64: generic store below
            else:
                return int(self._intern_ints_unique(
                    np.asarray([v], np.int64))[0])
        i = self._to_id.get(term)
        if i is None:
            i = self._n_terms
            self._check_capacity(i)
            self._to_id[term] = i
            self._from_id[i] = term
            self._n_terms += 1
        return i

    def encode_many(self, terms):
        terms = list(terms)
        if len(terms) >= _BULK_THRESHOLD and not any(
                isinstance(t, Null) for t in terms):
            # build the object array explicitly: np.asarray would splat a
            # list of equal-length tuples into a 2D array, interning tuple
            # *elements* instead of the tuple terms themselves
            arr = np.empty((len(terms), 1), dtype=object)
            arr[:, 0] = terms
            try:
                return [int(x) for x in self.encode_columns(arr)[:, 0]]
            except (TypeError, ValueError):
                # unorderable mixed terms (or ragged tuples np.unique can't
                # compare): per-term fallback
                pass
        return [self.encode(t) for t in terms]

    def encode_columns(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized interning of an (n, arity) ndarray of terms (strings,
        ints, ... — any hashable, orderable scalars) into an (n, arity) id
        array of the dictionary's dtype.  One ``np.unique`` over the flat
        terms; per-distinct-term work only (and pure numpy for integer
        input).  Raises ``OverflowError`` before returning ids if interning
        would leave the dtype's id range."""
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows.reshape(-1, 1)
        n, ar = rows.shape
        if n == 0:
            return np.zeros((0, ar), self.id_dtype)
        flat = rows.reshape(-1)
        if flat.dtype.kind in "iub":
            if (flat.dtype.kind == "u" and flat.size
                    and int(flat.max()) > np.iinfo(np.int64).max):
                # uint64 values past int64 max would wrap under astype;
                # demote to python ints on the object path, which routes
                # over-wide ints to the generic store (same as encode())
                demoted = np.empty(flat.shape, dtype=object)
                demoted[:] = [int(v) for v in flat]
                flat = demoted
            else:
                uniq, inv = np.unique(flat.astype(np.int64),
                                      return_inverse=True)
                ids = self._intern_ints_unique(uniq)
                return ids[inv].reshape(n, ar).astype(self.id_dtype)
        uniq, inv = np.unique(flat, return_inverse=True)
        terms = uniq.tolist()
        is_int = [isinstance(t, (int, np.integer)) for t in terms]
        if all(is_int):
            try:
                vals = np.asarray(terms, np.int64)
            except (OverflowError, ValueError):
                pass    # some term wider than int64: mixed path below
            else:
                ids = self._intern_ints_unique(vals)
                return ids[inv].reshape(n, ar).astype(self.id_dtype)
        if any(is_int):
            # mixed batch (e.g. ints + floats): per-term routing keeps each
            # value in one store; rare enough that the loop is fine
            known = [self.encode(t) for t in terms]
            ids = np.asarray(known, dtype=np.int64)[inv].reshape(n, ar)
            return ids.astype(self.id_dtype)
        get = self._to_id.get
        known = [get(t) for t in terms]
        n_new = sum(1 for i in known if i is None)
        if n_new:
            # range-check the whole batch BEFORE interning anything: a
            # partial batch would hand out ids the caller never sees
            self._check_capacity(self._n_terms + n_new - 1)
            nxt = self._n_terms
            for k, (t, i) in enumerate(zip(terms, known)):
                if i is None:
                    known[k] = self._to_id[t] = nxt
                    self._from_id[nxt] = t
                    nxt += 1
            self._n_terms = nxt
        ids = np.asarray(known, dtype=np.int64)[inv].reshape(n, ar)
        return ids.astype(self.id_dtype)

    def decode(self, i: int):
        if i < 0:
            return Null(-i)
        term = self._from_id.get(i)
        if term is not None:
            return term
        j = int(np.searchsorted(self._dec_ids, i))
        if j < len(self._dec_ids) and self._dec_ids[j] == i:
            return int(self._dec_vals[j])
        raise IndexError(f"unknown dictionary id {i}")

    def skolem(self, key: tuple) -> int:
        i = self._skolem.get(key)
        if i is None:
            i = self._next_null
            if i < self._min_id:
                raise OverflowError(
                    f"skolem null id {i} exceeds the {self.id_dtype} store "
                    f"id range [{self._min_id}, -1]; use a wider "
                    "REPRO_STORE_DTYPE")
            self._next_null -= 1
            self._skolem[key] = i
        return i

    def __len__(self):
        return self._n_terms

    @property
    def num_nulls(self):
        return -self._next_null - 1

    # -- transactional ingest / checkpointing -------------------------------
    def mark(self) -> tuple:
        """O(1) rollback token for transactional ingest.  Ids grow
        monotonically and the integer-store numpy arrays are *replaced* on
        growth (never mutated in place), so holding the current array
        references plus the two counters freezes this state."""
        return (self._n_terms, self._next_null, self._int_vals,
                self._int_ids, self._dec_ids, self._dec_vals)

    def rollback(self, token: tuple) -> None:
        """Discard every id handed out since ``mark()`` returned ``token``
        (a failed ingest chunk must not leave half-interned terms behind:
        later chunks would otherwise intern around ghosts whose ids no
        store row references)."""
        n_terms, next_null, iv, ii, di, dv = token
        for t, i in [kv for kv in self._to_id.items() if kv[1] >= n_terms]:
            del self._to_id[t]
            del self._from_id[i]
        for k in [k for k, i in self._skolem.items() if i <= next_null]:
            del self._skolem[k]
        self._n_terms = n_terms
        self._next_null = next_null
        self._int_vals, self._int_ids = iv, ii
        self._dec_ids, self._dec_vals = di, dv

    def state_dict(self) -> dict:
        """Picklable snapshot of the full interning state (what the engine
        checkpoints next to the stores: encoded rows are meaningless
        without the exact id assignment that produced them)."""
        return {
            "version": 1,
            "id_dtype": self.id_dtype.str,
            "n_terms": self._n_terms,
            "next_null": self._next_null,
            "to_id": dict(self._to_id),
            "skolem": dict(self._skolem),
            "int_vals": self._int_vals.copy(),
            "int_ids": self._int_ids.copy(),
            "dec_ids": self._dec_ids.copy(),
            "dec_vals": self._dec_vals.copy(),
        }

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict()`` snapshot in place (references to this
        Dictionary stay valid).  The dtype must match: ids encoded under a
        different store dtype would not round-trip the PAD reservation."""
        if np.dtype(state["id_dtype"]) != self.id_dtype:
            raise ValueError(
                f"checkpointed dictionary dtype {state['id_dtype']} does "
                f"not match this process's {self.id_dtype} "
                "(REPRO_STORE_DTYPE changed between save and restore)")
        self._n_terms = int(state["n_terms"])
        self._next_null = int(state["next_null"])
        self._to_id = dict(state["to_id"])
        self._from_id = {i: t for t, i in self._to_id.items()}
        self._skolem = dict(state["skolem"])
        self._int_vals = np.asarray(state["int_vals"], np.int64)
        self._int_ids = np.asarray(state["int_ids"], np.int64)
        self._dec_ids = np.asarray(state["dec_ids"], np.int64)
        self._dec_vals = np.asarray(state["dec_vals"], np.int64)
