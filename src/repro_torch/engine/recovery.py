"""Durable checkpointing and crash recovery for the two-phase, fused and
sharded executors (the port of ``repro.engine.recovery``).

Set ``REPRO_CKPT_DIR`` and ``materialize`` checkpoints its host-consistent
state at round boundaries (the fused and sharded executors: at each pull
boundary, so a device-loop phase is one boundary) and resumes from the
newest valid checkpoint on the next run, whichever executor wrote it.  The
on-disk format is the reference's, file for file::

    <REPRO_CKPT_DIR>/ckpt_00000042/
        shard_0.npz        store__<pred> / delta__<pred> / base__<pred>:
                           valid rows, trimmed, in the engine's lexsort order
        dict.pkl           Dictionary.state_dict() (term <-> id interning)
        caps.pkl           _Caps.state() (converged capacity plan; fused
                           and sharded)
        MANIFEST.json      format, tag + run meta + sha256 per payload file

The two-phase and fused executors write one shard; the sharded executor
(executor tag ``"dist"``) writes one ``shard_<i>.npz`` per shard, with the
base facts on shard 0.  The loader concatenates the shards and re-sorts,
so a checkpoint restores at any shard count and on any executor: the
sharded executor re-partitions the restored rows by the full-tuple hash
its exchanges use (``distributed._tuple_hash``, whose host mirror is
``np_tuple_hash``).  ``caps.pkl`` is written by the fused and sharded
executors; a fused resume adopts it, a sharded resume only from a
sharded run at the same shard count (its capacities are per shard).
``dict.pkl`` pickles the port's own ``Null``, so a checkpoint with nulls
does not load across the two packages; the loader refuses any class of
the ``repro`` package rather than import it.

Atomicity and integrity: payloads are written into a ``.tmp`` sibling, the
manifest (with content checksums) is written and fsynced LAST, and the
directory is atomically renamed into place.  On load, every file is
re-hashed against the manifest; a corrupt or half-written checkpoint is
skipped and the next-newest valid one is used.

Resume correctness: checkpoints persist the LIVE DELTAS next to the
stores, and ``maybe_resume`` hands them back as the seed of the continued
fixpoint (a restart from the stores alone would find nothing fresh).

When checkpointing is on, a chained SIGTERM guard is installed; the flag
is polled at the boundaries, where the executor saves a final consistent
checkpoint and exits with status 143.  Every boundary also consults
``repro_torch.engine.faultinject`` (``REPRO_FAULT_SPEC``), checkpointing
on or off; injected crashes land after any due save.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import shutil

import numpy as np

from repro_torch.engine import faultinject
from repro_torch.engine.relation import Relation, host_order, lex_order
from repro_torch.train.fault import PreemptionGuard

FORMAT = 1


# ---------------------------------------------------------------------------
# env knobs
# ---------------------------------------------------------------------------
def ckpt_dir() -> str | None:
    """Checkpoint directory (``REPRO_CKPT_DIR``); None disables durability."""
    return os.environ.get("REPRO_CKPT_DIR") or None


def ckpt_every() -> int:
    """Save cadence in completed rounds (``REPRO_CKPT_EVERY``, default 1 —
    every boundary)."""
    return max(int(os.environ.get("REPRO_CKPT_EVERY", "1")), 1)


def ckpt_keep() -> int:
    """How many newest checkpoints survive GC (``REPRO_CKPT_KEEP``)."""
    return max(int(os.environ.get("REPRO_CKPT_KEEP", "3")), 1)


def kb_fingerprint(kb, mode: str) -> str:
    """Identity of a materialization run for resume matching: the rule set,
    the mode, and the store dtype (the reference's hash, byte for byte: the
    port's ``repr(Rule)`` is the reference's).  It excludes the executor
    and the device."""
    h = hashlib.sha256()
    for rule in kb.program.rules:
        h.update(repr(rule).encode())
        h.update(b"\n")
    h.update(mode.encode())
    h.update(str(np.dtype(kb.dict.id_dtype)).encode())
    return h.hexdigest()[:16]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a ``dict.pkl`` without importing the reference package."""

    def find_class(self, module, name):
        if module == "repro" or module.startswith("repro."):
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}: it was written by the "
                "reference package, whose nulls the port cannot load")
        return super().find_class(module, name)


def load_dict_state(blob: bytes) -> dict:
    """Unpickle a ``dict.pkl`` or ``caps.pkl`` blob."""
    return _PortUnpickler(io.BytesIO(blob)).load()


# ---------------------------------------------------------------------------
# durable store
# ---------------------------------------------------------------------------
class RecoveryManager:
    """Atomic, checksummed checkpoint directory store.

    ``save`` is temp-then-rename with the manifest written last; ``load``
    walks tags newest-first and returns the first checkpoint whose manifest
    parses, whose fingerprint matches, and whose payload checksums verify —
    anything else is skipped (and a crashed save's ``.tmp`` litter is
    ignored entirely)."""

    def __init__(self, directory: str, keep: int | None = None):
        self.dir = directory
        self.keep = ckpt_keep() if keep is None else keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, tag: int) -> str:
        return os.path.join(self.dir, f"ckpt_{tag:08d}")

    def tags(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("ckpt_") and os.path.isfile(
                    os.path.join(self.dir, d, "MANIFEST.json")):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def drop(self, tag: int) -> None:
        shutil.rmtree(self._path(tag), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, tag: int, meta: dict, shards, blobs: dict) -> str:
        """Write one checkpoint: ``shards`` is a list of per-shard
        ``{name: np.ndarray}`` payloads, ``blobs`` maps extra filenames to
        bytes.  Returns the committed directory path."""
        tmp = os.path.join(self.dir, f".tmp_ckpt_{tag:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        checksums = {}
        for i, payload in enumerate(shards):
            fn = f"shard_{i}.npz"
            path = os.path.join(tmp, fn)
            np.savez(path, **{k: np.asarray(v) for k, v in payload.items()})
            checksums[fn] = _sha256(path)
        for fn, data in blobs.items():
            path = os.path.join(tmp, fn)
            with open(path, "wb") as f:
                f.write(data)
            checksums[fn] = _sha256(path)
        manifest = {"format": FORMAT, "tag": tag, "meta": meta,
                    "files": checksums}
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        final = self._path(tag)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        try:                       # make the rename itself durable
            dfd = os.open(self.dir, os.O_RDONLY)
            os.fsync(dfd)
            os.close(dfd)
        except OSError:
            pass
        self._gc()
        return final

    def _gc(self) -> None:
        for tag in self.tags()[:-self.keep]:
            self.drop(tag)

    # ------------------------------------------------------------------
    def load(self, fingerprint: str | None = None):
        """Newest valid checkpoint as ``(meta, shards, blobs)``, or None."""
        for tag in reversed(self.tags()):
            got = self._load_one(tag, fingerprint)
            if got is not None:
                return got
        return None

    def _load_one(self, tag: int, fingerprint: str | None):
        d = self._path(tag)
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                manifest = json.load(f)
            if manifest.get("format") != FORMAT:
                return None
            meta = manifest["meta"]
            if fingerprint is not None and \
                    meta.get("fingerprint") != fingerprint:
                return None
            for fn, digest in manifest["files"].items():
                if _sha256(os.path.join(d, fn)) != digest:
                    return None
            shards, blobs = [], {}
            for fn in sorted(manifest["files"],
                             key=lambda n: (not n.startswith("shard_"), n)):
                path = os.path.join(d, fn)
                if fn.startswith("shard_") and fn.endswith(".npz"):
                    with np.load(path) as z:
                        shards.append({k: z[k] for k in z.files})
                else:
                    with open(path, "rb") as f:
                        blobs[fn] = f.read()
            return meta, shards, blobs
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None


# ---------------------------------------------------------------------------
# SIGTERM guard (process singleton; chained so outer handlers still run)
# ---------------------------------------------------------------------------
_GUARD = None


def preemption_guard() -> PreemptionGuard:
    global _GUARD
    if _GUARD is None:
        _GUARD = PreemptionGuard(chain=True)
    return _GUARD


# ---------------------------------------------------------------------------
# executor-facing wrapper
# ---------------------------------------------------------------------------
class EngineCheckpointer:
    """What the executors talk to.

    * ``maybe_resume(st)`` — restore ``kb`` (dictionary + stores + base)
      from the newest valid checkpoint; returns the live deltas as
      ``{pred: (n, ar) np rows}`` (empty for a finished run), or None when
      there is nothing to resume.  Sets the stats cursor and
      ``st.extra["resumed_rounds"]``; a saved capacity plan lands in
      ``caps_state`` for the fused and sharded executors to adopt.
    * ``boundary(st, state_fn, caps=None)`` — call at every committed
      round boundary.  Saves when due (cadence / preemption / ``done``),
      with the capacity plan ``caps`` when given, then runs the fault
      hooks, then honors a pending SIGTERM by exiting 143.  ``state_fn`` is
      lazy: stores are only pulled to the host when a save happens.

    Disabled (all methods cheap no-ops except the fault hooks) when
    ``REPRO_CKPT_DIR`` is unset or ``enabled=False`` (incremental delta
    calls checkpoint nothing: their lifecycle belongs to the caller)."""

    def __init__(self, kb, mode: str, executor: str,
                 enabled: bool | None = None):
        self.kb = kb
        self.mode = mode
        self.executor = executor
        self.faults = faultinject.get_faults()
        d = ckpt_dir()
        self.enabled = (d is not None if enabled is None
                        else bool(enabled) and d is not None)
        self.mgr = RecoveryManager(d) if self.enabled else None
        self.every = ckpt_every()
        self.fingerprint = kb_fingerprint(kb, mode)
        self.guard = preemption_guard() if self.enabled else None
        self._last_saved = -1
        self.caps_state = None      # from the checkpoint; executors adopt()

    # ------------------------------------------------------------------
    def maybe_resume(self, st):
        if not self.enabled:
            return None
        loaded = self.mgr.load(self.fingerprint)
        if loaded is None:
            return None
        meta, shards, blobs = loaded
        kb = self.kb
        kb.dict.load_state(load_dict_state(blobs["dict.pkl"]))
        if "caps.pkl" in blobs:
            self.caps_state = load_dict_state(blobs["caps.pkl"])
        stores, deltas, bases = {}, {}, {}
        for payload in shards:
            for key, arr in payload.items():
                kind, _, pred = key.partition("__")
                bucket = {"store": stores, "delta": deltas,
                          "base": bases}.get(kind)
                if bucket is not None:
                    bucket.setdefault(pred, []).append(arr)
        for pred, parts in stores.items():
            kb.rels[pred] = self._to_relation(pred, parts)
        for pred, parts in bases.items():
            kb.base[pred] = self._to_relation(pred, parts)
        st.rounds = int(meta["rounds"])
        st.triggers = int(meta["triggers"])
        st.derived = int(meta["derived"])
        st.extra["resumed_rounds"] = st.rounds
        st.extra["resumed_from"] = (meta.get("executor"),
                                    int(meta.get("ndev", 1)))
        self._last_saved = st.rounds
        out = {}
        for pred, parts in deltas.items():
            rows = self._gather(parts)
            if len(rows):
                out[pred] = rows
        return out

    def _gather(self, parts) -> np.ndarray:
        parts = [np.asarray(p) for p in parts if np.asarray(p).size]
        if not parts:
            return np.zeros((0, 1), self.kb.dict.id_dtype)
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
        # re-establish the engine's lex order unconditionally: shards of a
        # multi-shard checkpoint are sorted each on its own
        return np.ascontiguousarray(rows[host_order(rows)])

    def _to_relation(self, pred, parts) -> Relation:
        rows = self._gather(parts)
        ar = max(self.kb.arities.get(pred, rows.shape[1]), 1)
        if rows.shape[1] != ar:
            rows = rows.reshape(-1, ar)
        return self.kb._relation(rows, sorted_by=lex_order(ar))

    # ------------------------------------------------------------------
    def boundary(self, st, state_fn=None, caps=None, done: bool = False):
        preempt = self.guard.requested if self.guard is not None else False
        if (self.enabled and state_fn is not None
                and st.rounds > self._last_saved
                and (done or preempt
                     or st.rounds - self._last_saved >= self.every)):
            self._save(st, state_fn(), caps, done=done)
        self.faults.on_boundary(st.rounds)
        if preempt:
            raise SystemExit(143)

    def final(self, st, state_fn=None, caps=None):
        """Terminal boundary: persists the converged state (empty deltas,
        ``done`` meta) so resuming a finished run is a no-op."""
        self.boundary(st, state_fn, caps=caps, done=True)

    def _save(self, st, shards, caps, done: bool):
        meta = {"fingerprint": self.fingerprint, "executor": self.executor,
                "mode": self.mode, "rounds": st.rounds,
                "triggers": st.triggers, "derived": st.derived,
                "ndev": len(shards), "done": bool(done)}
        blobs = {"dict.pkl": pickle.dumps(
            self.kb.dict.state_dict(), protocol=pickle.HIGHEST_PROTOCOL)}
        if caps is not None:
            blobs["caps.pkl"] = pickle.dumps(
                caps.state(), protocol=pickle.HIGHEST_PROTOCOL)
        path = self.mgr.save(st.rounds, meta, shards, blobs)
        self._last_saved = st.rounds
        st.extra["checkpoints"] = st.extra.get("checkpoints", 0) + 1
        self.faults.on_checkpoint(path, st.rounds)
