"""Deterministic fault injection for the materialization engine (the port's
own copy of ``repro.engine.faultinject``; keep the two in step).

``REPRO_FAULT_SPEC`` holds a comma-separated list of fault events; each
event is ``kind[:field=value...]``.  The executors consult the injector at
their round / phase boundaries (after any due checkpoint save, so every
injected crash lands on a consistent host-side state), and the fused
executor's capacity planner consults it when it is built.

Supported events::

    crash:round=K          SIGKILL the process at the first boundary whose
                           completed-round count reaches K (rehearses node
                           loss; nothing is flushed, resume must come from
                           the last durable checkpoint)
    sigterm:round=K        deliver a real SIGTERM to self at round K — the
                           PreemptionGuard path: the executor saves a
                           checkpoint at the next boundary and exits 143
    sleep:round=K:secs=S   straggler: sleep S seconds at every boundary
                           from round K on (default 0.01)
    storm                  forced-overflow storm: the fused executor's
                           capacity planner starts every delta / join guess
                           at the floor, so every cold phase pays the full
                           double-and-retry ladder (exercises RetryBudget
                           and its CapacityError); the two-phase executor
                           has no planner and ignores it
    ckpt_corrupt:tag=K:seed=S
                           flip one seeded byte in a payload file of the
                           first checkpoint written with tag >= K
                           (exercises the checksum-validation fallback)

Faults are deterministic: the only randomness is ``random.Random(seed)``
in ``corrupt_file``.  One-shot events (crash / sigterm / ckpt_corrupt)
fire at most once per process.
"""
from __future__ import annotations

import os
import random
import signal
import time


class FaultSpec:
    """Parsed ``REPRO_FAULT_SPEC``; all hooks are no-ops when empty."""

    def __init__(self, text: str = ""):
        self.events: dict = {}
        self._fired: set = set()
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            kind, kv = fields[0], {}
            for f in fields[1:]:
                k, _, v = f.partition("=")
                kv[k] = v
            self.events[kind] = kv

    @property
    def active(self) -> bool:
        return bool(self.events)

    def _round_of(self, kind: str, default: int = 1) -> int:
        return int(self.events[kind].get("round", default))

    def tiny_caps(self) -> bool:
        """True when the planner should start delta-family guesses at the
        floor (the ``storm`` event)."""
        return "storm" in self.events

    def on_boundary(self, rounds: int) -> None:
        """Called by the executors at each completed round/phase boundary
        (after any due checkpoint save, so an injected crash always leaves
        the latest durable state behind)."""
        ev = self.events.get("sleep")
        if ev is not None and rounds >= int(ev.get("round", 1)):
            time.sleep(float(ev.get("secs", 0.01)))
        if "sigterm" in self.events and "sigterm" not in self._fired \
                and rounds >= self._round_of("sigterm"):
            self._fired.add("sigterm")
            os.kill(os.getpid(), signal.SIGTERM)
        if "crash" in self.events and "crash" not in self._fired \
                and rounds >= self._round_of("crash"):
            self._fired.add("crash")
            os.kill(os.getpid(), signal.SIGKILL)

    def on_checkpoint(self, ckpt_dir: str, tag: int) -> None:
        """Called right after a checkpoint directory is committed."""
        ev = self.events.get("ckpt_corrupt")
        if ev is None or "ckpt_corrupt" in self._fired \
                or tag < int(ev.get("tag", 0)):
            return
        self._fired.add("ckpt_corrupt")
        for name in sorted(os.listdir(ckpt_dir)):
            if name.endswith(".npz") or name.endswith(".pkl"):
                corrupt_file(os.path.join(ckpt_dir, name),
                             seed=int(ev.get("seed", 0)))
                return


def corrupt_file(path: str, seed: int = 0) -> None:
    """Flip one deterministic byte in ``path`` (the fault the checksum
    validation must catch)."""
    size = os.path.getsize(path)
    if size == 0:
        with open(path, "wb") as f:
            f.write(b"\xff")
        return
    rng = random.Random(seed)
    pos = rng.randrange(size)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


_CACHE: dict = {}


def get_faults() -> FaultSpec:
    """The process fault spec (parsed from ``REPRO_FAULT_SPEC``); cached
    per spec string so one-shot events fire once even though every
    executor entry re-reads the env."""
    text = os.environ.get("REPRO_FAULT_SPEC", "")
    spec = _CACHE.get(text)
    if spec is None:
        spec = _CACHE[text] = FaultSpec(text)
    return spec
