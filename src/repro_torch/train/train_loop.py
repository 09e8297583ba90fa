"""Training loop, as ``repro.train.train_loop``: the model's step, periodic
checkpoints written in the background, a preemption-safe exit and
resumption (weights, optimizer state and the data pipeline's position),
with straggler timing.

On a mesh (a model built with a rank's ``MeshCtx``) every rank runs the
loop on the same data; a checkpoint holds the global arrays, gathered by
every rank and written by rank 0 in the one-device format, and a resume
reshards them onto the mesh it is given (the reference's elastic
reshard-on-restore): a run saved at (2, 2) resumes at (1, 1) or (1, 2).
A SIGTERM on any rank stops every rank at the same step boundary, after
that checkpoint.  Rank 0 logs."""
from __future__ import annotations

from typing import Callable, Optional

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
    opt_state = model.init_opt_state()
    mcx = model.mcx
    lead = mcx is None or mcx.rank == 0
    start_step = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        if mcx is None:
            (saved, opt_state), extra = mgr.restore((params, opt_state))
        else:
            (saved, whole), extra = mgr.restore(_global_template(
                model, opt_state))
            opt_state = {part: {n: t.to(model.device)
                                for n, t in leaves.items()}
                         for part, leaves in model.local_state(whole)
                         .items()}
            saved = model.local_weights(saved)
            del whole
        for n, p in params.items():
            p.data.copy_(saved[n])
        del saved
        start_step = int(extra.get("step", 0))
        if "data_state" in extra:
            data.restore(extra["data_state"])
        if lead:
            log(f"[train] resumed from step {start_step}")

    def save(step, blocking):
        tree = (params, opt_state) if mcx is None else \
            (model.global_weights(), model.global_state(opt_state))
        if lead:
            mgr.save(step, tree, extra={"step": step,
                                        "data_state": data.state()},
                     blocking=blocking)

    guard = PreemptionGuard()
    timer = StepTimer()
    losses = []
    try:
        for step in range(start_step, steps):
            batch = data.next()
            with timer:
                opt_state, metrics = model.train_step(opt_state, batch, step)
                _sync(model.device)
            if lead and (step % log_every == 0 or step == steps - 1):
                loss = float(metrics["loss"])
                losses.append((step, loss))
                log(f"[train] step={step} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"med_step={timer.median*1e3:.0f}ms "
                    f"stragglers={timer.stragglers}")
            stop = _agreed(guard.requested, mcx, model.device)
            should_ckpt = mgr and (step + 1) % ckpt_every == 0
            if mgr and (should_ckpt or stop or step == steps - 1):
                save(step + 1, blocking=stop or step == steps - 1)
            if stop:
                if lead:
                    log(f"[train] preemption at step {step}: checkpointed, "
                        f"exiting")
                break
    finally:
        guard.restore()
        if mgr:
            mgr.wait()
    return params, opt_state, losses


def _agreed(flag: bool, mcx, device) -> bool:
    """Whether any rank of the mesh has ``flag`` set."""
    if mcx is None or mcx.size == 1:
        return flag
    import torch
    t = torch.tensor(float(flag), device=device)
    return bool(mcx.all_reduce(t, ("data", "model"), "max") > 0)


def _global_template(model, opt_state):
    """(weights, optimizer state) as host tensors of their whole shapes:
    the template a checkpoint of global arrays restores into."""
    import torch
    shapes = model.param_shapes()
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    weights = {n: torch.empty(shapes[n], dtype=dtypes[n]) for n in shapes}
    state = {part: {n: torch.empty(shapes[n], dtype=t.dtype)
                    for n, t in leaves.items()}
             for part, leaves in opt_state.items()}
    return weights, state
