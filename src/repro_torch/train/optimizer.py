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

On a mesh the state is ZeRO-1 sharded as on the reference: each leaf is
the rank's shard over "data" of its weight's largest dim that no axis
splits and dp divides (``zero1_spec``; ``opt_state_shardings`` gives every
leaf's spec).  ``ZeroLayout`` carries that layout: the gradients are
reduce-scattered into the shards, AdamW runs on them, and each new weight
shard is all-gathered back into the rank's replica.  The global norm
counts each element once over the mesh, and the int8 scale is the max
over the whole tensor, all-reduced over the mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


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


# ---------------------------------------------------------------------------
# ZeRO-1: the state's layout on a mesh
# ---------------------------------------------------------------------------
def zero1_spec(spec, shape, dp_size: int) -> tuple:
    """``spec`` (the axis each dim of a weight of whole ``shape`` is split
    over: "model", "data" or None) with the largest dim that no axis
    splits and ``dp_size`` divides also split over "data": the reference's
    ``zero1_spec`` on the port's specs.  As there, a spec that splits a dim
    over "data" already (an FSDP weight) or has no such dim is returned as
    it is."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in entries:
        return tuple(entries)
    best, best_dim = -1, None
    for i, (e, n) in enumerate(zip(entries, shape)):
        if e is None and n % dp_size == 0 and n > best:
            best, best_dim = n, i
    if best_dim is not None:
        entries[best_dim] = "data"
    return tuple(entries)


def opt_state_shardings(param_specs, param_shapes, mcx, oc: OptConfig):
    """The spec of every optimizer-state leaf ({"mu", "nu", "master"[,
    "err"]} -> {name: spec}): each weight's ``zero1_spec``."""
    one = {n: zero1_spec(param_specs[n], param_shapes[n], mcx.dp_size)
           for n in param_specs}
    out = {"mu": one, "nu": one, "master": one}
    if oc.grad_compress:
        out["err"] = one
    return out


@dataclass
class ZeroLayout:
    """One rank's optimizer state on a mesh: ``mcx`` the rank's
    ``MeshCtx``, ``param_specs`` each weight's spec and ``state_specs``
    its state's (``opt_state_shardings``).  A weight's state is the
    rank's shard along ``zero_dim`` of the weight it holds (None: the
    whole of it, where the weight is an FSDP shard or no dim fits)."""

    mcx: object
    param_specs: dict
    state_specs: dict
    zero_dim: dict = field(init=False)

    def __post_init__(self):
        self.zero_dim = {}
        for n, spec in self.state_specs.items():
            dims = [d for d, (a, b) in enumerate(zip(self.param_specs[n],
                                                     spec))
                    if b == "data" and a != "data"]
            self.zero_dim[n] = dims[0] if dims else None

    def shard(self, n: str, t):
        """The rank's shard of ``t``, held as the weight ``n`` is."""
        dim = self.zero_dim[n]
        if dim is None:
            return t
        k = t.shape[dim] // self.mcx.dp_size
        return t.narrow(dim, self.mcx.data_index * k, k)

    def reduce_grad(self, n: str, g):
        """The gradient ``g`` of the rank's rows summed over "data" into
        the rank's shard (an FSDP shard's is summed already)."""
        if "data" in self.param_specs[n]:
            return g
        dim = self.zero_dim[n]
        if dim is None:
            return self.mcx.all_reduce(g, "data")
        return self.mcx.reduce_scatter(g, dim, "data")

    def counted(self, n: str) -> bool:
        """Whether this rank counts weight ``n``'s shard in the global norm:
        each element once over the mesh (a part every rank of an axis holds
        alike only on that axis's rank 0)."""
        spec = self.state_specs[n]
        return ("model" in spec or self.mcx.model_index == 0) and \
            ("data" in spec or self.mcx.data_index == 0)


def _to_replica(p, shard, dim: int, mcx) -> None:
    """The rank's new shard of ``p`` along ``dim`` all-gathered over "data"
    into its replica ``p``."""
    p.copy_(mcx.all_gather(shard, dim, "data"))


def _global_amax(amax, layout):
    """Each tensor's max |x| over the whole tensor: the shards' maxima
    all-reduced over the mesh."""
    return layout.mcx.all_reduce(amax, ("data", "model"), "max")


@torch.no_grad()
def init_opt_state(params, oc: OptConfig, layout=None) -> dict:
    """``mu``, ``nu`` (zeros) and ``master`` (a float32 copy) of every
    weight, on its device; with ``grad_compress`` also ``err`` (zeros).
    With ``layout`` (a ``ZeroLayout``) each leaf is the rank's shard."""
    master = {n: (p if layout is None else layout.shard(n, p)).detach()
              .to(torch.float32, copy=True)
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
def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares.  With
    ``layout`` the leaves are the rank's shards: each rank sums those it
    counts (``ZeroLayout.counted``) and the sums are all-reduced over the
    mesh."""
    if layout is None:
        total = 0
        for g in tree.values():
            total = total + g.float().square().sum()
        return torch.sqrt(total)
    total = torch.zeros((), device=next(iter(tree.values())).device)
    for n, g in tree.items():
        if layout.counted(n):
            total = total + g.float().square().sum()
    return torch.sqrt(layout.mcx.all_reduce(total, ("data", "model")))


def _quantize_int8(x, amax=None):
    """Per-tensor symmetric int8 quantization, by ``amax`` (default: x's
    max |x|).  Returns (q, scale)."""
    amax = torch.clamp(x.abs().max() if amax is None else amax, min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def apply_updates(grads, state, params, step: int, oc: OptConfig,
                  layout=None):
    """One AdamW step.  ``grads`` in any float dtype (the weights' or
    float32); the state's moments and master and the weights are updated
    in place.  Returns (params, state, {"grad_norm", "lr"}), the norm a
    0-d tensor on the weights' device, ``lr`` a 0-d float32 CPU tensor.
    With ``layout`` (a ``ZeroLayout``) the gradients and state are the
    rank's shards, and each weight's new shard is gathered into it."""
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
    lr_f = float(lr)

    def apply(n, delta):
        p = params[n]
        dim = None if layout is None else layout.zero_dim[n]
        if dim is None:
            p.copy_((p.float() + delta).to(p.dtype))
        else:
            mine = layout.shard(n, p)
            _to_replica(p, (mine.float() + delta).to(p.dtype), dim,
                        layout.mcx)

    pending = []
    for n, g in grads.items():
        mu, nu, m = state["mu"][n], state["nu"][n], state["master"][n]
        # the moments and the delta with two temporaries of the leaf's
        # size at a time (FSDP and ZeRO shards train near the card's
        # memory), the same arithmetic as the reference's expressions
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        g.square_().mul_(1 - b2)
        nu.mul_(b2).add_(g)
        del g
        den = nu / bc2
        delta = (mu / bc1).div_(den.sqrt_().add_(oc.eps))
        del den
        delta.add_(oc.weight_decay * m).mul_(-lr_f)
        m.add_(delta)
        if oc.grad_compress:
            err = state["err"][n]
            if layout is not None:
                # the scale needs every shard's max: d_ef waits in err
                err.add_(delta)
                pending.append(n)
                continue
            d_ef = delta.add_(err)
            q, s = _quantize_int8(d_ef)
            delta = q.float() * s
            torch.sub(d_ef, delta, out=err)
        apply(n, delta)
    if pending:
        amax = _global_amax(torch.stack([state["err"][n].abs().max()
                                         for n in pending]), layout)
        for n, a in zip(pending, amax):
            d_ef = state["err"][n]
            q, s = _quantize_int8(d_ef, a)
            delta = q.float() * s
            d_ef.sub_(delta)
            apply(n, delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
