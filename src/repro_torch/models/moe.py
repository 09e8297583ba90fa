"""Mixture-of-Experts layer of the port: top-k routing, capacity-bounded
dispatch, a grouped expert FFN and the probability-weighted combine.

Counterpart of ``repro.models.moe`` on one device.  There the experts are
split over the model axis and either dispatch ("psum", each shard scatters
the assignments routed to its local experts, then the shards sum) or
exchange token rows ("a2a", two all-to-alls).  At one shard both are the
same computation: route in float32, give every assignment a slot
``expert * C + rank`` among the assignments to its expert (rank by a
stable sort, so earlier tokens win), send what overflows capacity ``C``
to a trash row, run every expert on its ``C`` slots as one grouped
product and add each token's ``k`` weighted outputs back.  The port runs
that one body for either ``moe_dispatch``.

The combine adds a token's ``k`` contributions in order, one (T, d) add
per rank: the reference's sequential scatter-add on the CPU, and on the
card a fixed order (a scatter-add there uses atomics, whose order, and so
whose bfloat16 rounding, changes from run to run).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import normal, param, torch_dtype


def init_moe(cfg, generator) -> nn.ParameterDict:
    """The router (d, E) in float32, the experts' (E, d, ff) / (E, ff, d)
    weights and the shared experts' in the config's dtype.  Each expert is
    drawn on its own, so no float32 copy of a whole (E, d, ff) tensor is
    ever made."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt, dev = torch_dtype(cfg.dtype), generator.device

    def experts(shape):
        w = torch.empty((E,) + shape, dtype=dt, device=dev)
        for e in range(E):
            w[e] = normal(shape, generator, dt)
        return param(w)

    p = {"router": param(normal((d, E), generator, torch.float32)),
         "w_gate": experts((d, ff)), "w_up": experts((d, ff)),
         "w_down": experts((ff, d))}
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * ff
        p["ws_gate"] = param(normal((d, sf), generator, dt))
        p["ws_up"] = param(normal((d, sf), generator, dt))
        p["ws_down"] = param(normal((sf, d), generator, dt))
    return nn.ParameterDict(p)


def _expert_ffn(wg, wu, wd, x):
    """x: (E, C, d) -> (E, C, d), one SwiGLU per expert (grouped)."""
    g = torch.bmm(x, wg)
    u = torch.bmm(x, wu)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.bmm(h, wd)


def capacity(T: int, cfg) -> int:
    """Slots per expert for ``T`` tokens, in the reference's float
    arithmetic."""
    return max(1, int(math.ceil(T * cfg.top_k * cfg.capacity_factor
                                / cfg.num_experts)))


def route(router, xt, cfg):
    """Float32 routing of xt (T, d): the softmax over experts, the top-k
    experts of each token (ties to the lower index, as ``lax.top_k``) with
    their renormalised probabilities, and the Switch-style load-balancing
    loss.  Returns (top_p (T,k), top_e (T,k), probs (T,E), aux)."""
    E, k = cfg.num_experts, cfg.top_k
    logits = torch.einsum("td,de->te", xt.float(), router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    density = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = (density * probs.mean(0)).sum() * E * cfg.router_aux_coef
    return top_p, top_e, probs, aux


def assign_slots(top_e, E: int, C: int):
    """Each assignment's slot (T*k,) in token-major order: ``e * C +`` its
    rank among the assignments to expert ``e`` (stable, so lower tokens
    first), or the trash slot ``E * C`` past capacity.  Returns (kept
    (T*k,) bool, slot (T*k,) int64)."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    rank_s = torch.arange(len(e_s), device=e_s.device) - torch.searchsorted(
        e_s, e_s, side="left")
    rank = torch.empty_like(rank_s)
    rank[order] = rank_s
    kept = rank < C
    return kept, torch.where(kept, flat_e * C + rank, E * C)


def _shared_experts(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["ws_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["ws_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["ws_down"])


def moe_fwd(p, x, cfg):
    """x: (B,S,d) -> (y (B,S,d), aux): the reference's ``shard_body`` at
    one shard, plus the shared experts where the layer has them."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(B * S, d)
    T = B * S
    top_p, top_e, _, aux = route(p["router"], xt, cfg)
    C = capacity(T, cfg)
    kept, slot = assign_slots(top_e, E, C)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    # rows past capacity all land on the trash row, which is dropped;
    # out of place, so that autograd can take the scatter
    buf = x.new_zeros((E * C + 1, d)).index_put((slot,), xt[flat_t])
    out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                      buf[:E * C].view(E, C, d)).reshape(E * C, d)
    contrib = torch.where(kept[:, None], out[slot.clamp(max=E * C - 1)], 0.0)
    contrib = (contrib * top_p.reshape(-1, 1).to(x.dtype)).view(T, k, d)
    y = torch.zeros_like(xt)
    for j in range(k):
        y = y + contrib[:, j]
    y = y.view(B, S, d)
    if "ws_gate" in p:
        y = y + _shared_experts(p, x)
    return y, aux
