"""Training loop, as ``repro.train.train_loop``: the model's step, periodic
checkpoints written in the background, a preemption-safe exit and
resumption (weights, optimizer state and the data pipeline's position),
with straggler timing."""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import PreemptionGuard, StepTimer


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def train(model, data, *, steps: int, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 100, log_every: int = 10, resume: bool = True,
          log: Callable = print):
    """model: a ``repro_torch.models.model.Model`` built for training, its
    weights in place (the reference draws them here from
    ``PRNGKey(0)``); data: a pipeline with ``next()`` / ``state()`` /
    ``restore()``.  Resumes from the newest checkpoint in ``ckpt_dir``;
    on SIGTERM saves at the next step boundary and leaves the loop.
    Returns (weights by name, optimizer state, [(step, loss)] logged)."""
    params = dict(model.named_parameters())
    opt_state = OPT.init_opt_state(params, model.opt_cfg)
    start_step = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        (saved, opt_state), extra = mgr.restore((params, opt_state))
        for n, p in params.items():
            p.data.copy_(saved[n])
        del saved
        start_step = int(extra.get("step", 0))
        if "data_state" in extra:
            data.restore(extra["data_state"])
        log(f"[train] resumed from step {start_step}")

    guard = PreemptionGuard()
    timer = StepTimer()
    losses = []
    try:
        for step in range(start_step, steps):
            batch = data.next()
            with timer:
                opt_state, metrics = model.train_step(opt_state, batch, step)
                _sync(model.device)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                log(f"[train] step={step} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"med_step={timer.median*1e3:.0f}ms "
                    f"stragglers={timer.stragglers}")
            should_ckpt = mgr and (step + 1) % ckpt_every == 0
            if mgr and (should_ckpt or guard.requested or step == steps - 1):
                mgr.save(step + 1, (params, opt_state),
                         extra={"step": step + 1,
                                "data_state": data.state()},
                         blocking=guard.requested or step == steps - 1)
            if guard.requested:
                log(f"[train] preemption at step {step}: checkpointed, "
                    f"exiting")
                break
    finally:
        guard.restore()
        if mgr:
            mgr.wait()
    return params, opt_state, losses
