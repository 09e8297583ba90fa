"""AdamW with float32 master weights, global-norm clipping, a warmup +
cosine schedule and an optional int8-compressed update with error
feedback: ``repro.train.optimizer``'s arithmetic on one device.

Plain functions on tensors: ``init_opt_state(params, oc) -> state`` and
``apply_updates(grads, state, params, step, oc) -> (params, state,
stats)``, with ``params``, ``grads`` and each part of ``state`` mappings
from parameter names to tensors.  They run under ``torch.no_grad()`` and
update the state and the weights in place.  ``torch.optim.AdamW`` is not
used: its weight decay reads the weight, not the master, and it does not
clip.

As on the reference, the new weight is ``p + delta`` rounded to the
weight's dtype, where ``delta`` is computed from the float32 master and
moments; the master itself only feeds the weight-decay term.  A bfloat16
weight therefore keeps none of an update smaller than half its ulp, while
its master moves (ROADMAP, Queue 3).

The reference's ZeRO-1 sharding of this state over data-parallel devices
is ROADMAP Queue 1 item 12's training half (several cards).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_SHARDING = ("sharding optimizer state over data-parallel devices is "
             "ROADMAP Queue 1 item 12 (several cards), its training half")


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_compress: bool = False     # int8 update w/ error feedback


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (0-d float32 on the CPU): linear
    warmup over ``warmup_steps``, then a cosine down to 0.1 ``lr`` at
    ``total_steps``, in the reference's float32 arithmetic."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def init_opt_state(params, oc: OptConfig) -> dict:
    """``mu``, ``nu`` (zeros) and ``master`` (a float32 copy) of every
    weight, on its device; with ``grad_compress`` also ``err`` (zeros)."""
    master = {n: p.detach().to(torch.float32, copy=True)
              for n, p in params.items()}
    state = {"mu": {n: torch.zeros_like(m) for n, m in master.items()},
             "nu": {n: torch.zeros_like(m) for n, m in master.items()},
             "master": master}
    if oc.grad_compress:
        state["err"] = {n: torch.zeros_like(m) for n, m in master.items()}
    return state


def _bias_correction(beta: float, step) -> float:
    """1 - beta^(step + 1), in float32."""
    return float(1 - beta ** (_f32(step) + 1))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares."""
    total = 0
    for g in tree.values():
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _quantize_int8(x):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    amax = torch.clamp(x.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def apply_updates(grads, state, params, step: int, oc: OptConfig):
    """One AdamW step.  ``grads`` in any float dtype (the weights' or
    float32); the state's moments and master and the weights are updated
    in place.  Returns (params, state, {"grad_norm", "lr"}), the norm a
    0-d tensor on the weights' device, ``lr`` a 0-d float32 CPU tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
    lr_f = float(lr)
    for n, g in grads.items():
        mu, nu, m = state["mu"][n], state["nu"][n], state["master"][n]
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g.square())
        del g
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + oc.eps)
        delta.add_(oc.weight_decay * m).mul_(-lr_f)
        m.add_(delta)
        if oc.grad_compress:
            err = state["err"][n]
            d_ef = delta.add_(err)
            q, s = _quantize_int8(d_ef)
            delta = q.float() * s
            torch.sub(d_ef, delta, out=err)
        p = params[n]
        p.copy_((p.float() + delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}


def zero1_spec(*args, **kwargs):
    raise NotImplementedError(_SHARDING)


def opt_state_shardings(*args, **kwargs):
    raise NotImplementedError(_SHARDING)
