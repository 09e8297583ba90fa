"""Mixture-of-Experts layer of the port: top-k routing, capacity-bounded
dispatch, a grouped expert FFN and the probability-weighted combine.

Counterpart of ``repro.models.moe``.  On one device both of the
reference's dispatches are the same computation: route in float32, give
every assignment a slot ``expert * C + rank`` among the assignments to its
expert (rank by a stable sort, so earlier tokens win), send what overflows
capacity ``C`` to a trash row, run every expert on its ``C`` slots as one
grouped product and add each token's ``k`` weighted outputs back.

On a mesh (``mcx``) the routed experts are split over "model" (E / tp a
rank), the shared experts are column- and row-parallel, and the router is
replicated, as the reference lays them out:

* ``psum``: each rank routes all its tokens (its rows of the batch; the
  data axis splits the tokens where it divides them), keeps the
  assignments to its experts, at the reference's capacity from the global
  token count, runs them, and the ranks sum their partial outputs;
* ``a2a``: where dp x tp divides the token count, tokens are split over
  data x model, each rank routes its own at the capacity of its share,
  two all-to-alls over "model" move the rows to their experts and back,
  and the load-balancing loss is a mean over the ranks; otherwise the
  ``psum`` path, as on the reference.

Under autograd, the tokens and routing weights that enter a rank's part
of the experts, the router where each rank routes its own share (a2a)
and the input of split shared experts pass ``fan_out``: their gradients
are summed over "model".

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

from repro_torch.models import layers as L
from repro_torch.models.layers import normal, param, torch_dtype


def init_moe(cfg, generator, experts=None) -> nn.ParameterDict:
    """The router (d, E) in float32, the experts' (E, d, ff) / (E, ff, d)
    weights and the shared experts' in the config's dtype.  Each expert is
    drawn on its own, so no float32 copy of a whole (E, d, ff) tensor is
    ever made; of the routed experts only those in the range ``experts``
    (all by default) are kept."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt, dev = torch_dtype(cfg.dtype), generator.device
    keep = range(E) if experts is None else experts

    def experts_w(shape):
        w = torch.empty((len(keep),) + shape, dtype=dt, device=dev)
        for e in range(E):
            we = normal(shape, generator, dt)
            if e in keep:
                w[e - keep.start] = we
        return param(w)

    p = {"router": param(normal((d, E), generator, torch.float32)),
         "w_gate": experts_w((d, ff)), "w_up": experts_w((d, ff)),
         "w_down": experts_w((ff, d))}
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


def _combine(contrib, top_p, T: int, k: int, dtype):
    """Each token's ``k`` weighted contributions (T*k, d) added in order."""
    contrib = (contrib * top_p.reshape(-1, 1).to(dtype)).view(T, k, -1)
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _dispatch(xt, p, top_p, top_e, cfg, C: int, lo: int, n_exp: int):
    """The assignments of xt (T, d) to the experts ``lo .. lo + n_exp``
    (the layer holds their weights): each to its slot ``(e - lo) * C +
    rank``, rank among the assignments to ``e`` (``assign_slots``), the
    rest (other experts', past capacity) to the trash row; the experts run
    as one grouped product and each token gets its kept outputs, weighted
    and added in order.  Returns (T, d)."""
    E, k = cfg.num_experts, cfg.top_k
    T, d = xt.shape
    kept, slot = assign_slots(top_e, E, C)
    flat_e = top_e.reshape(-1)
    if n_exp != E:
        kept = kept & (flat_e >= lo) & (flat_e < lo + n_exp)
        slot = torch.where(kept, slot - lo * C, n_exp * C)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(k)
    # rows past capacity all land on the trash row, which is dropped;
    # out of place, so that autograd can take the scatter
    buf = xt.new_zeros((n_exp * C + 1, d)).index_put((slot,), xt[flat_t])
    out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                      buf[:n_exp * C].view(n_exp, C, d)).reshape(n_exp * C, d)
    contrib = torch.where(kept[:, None], out[slot.clamp(max=n_exp * C - 1)],
                          0.0)
    return _combine(contrib, top_p, T, k, xt.dtype)


def moe_fwd(p, x, cfg, mcx=None):
    """x: (B,S,d) -> (y (B,S,d), aux): the reference's ``shard_body`` (or
    ``_moe_a2a``) for this rank, plus the shared experts where the layer
    has them.  On a mesh x is the rank's rows of the batch (all of it
    where the data axis does not split the batch, ``mcx.batch_split``)."""
    B, S, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * S, d)
    T = B * S
    if mcx is None:
        top_p, top_e, _, aux = route(p["router"], xt, cfg)
        y = _dispatch(xt, p, top_p, top_e, cfg, capacity(T, cfg), 0, E)
        y = y.view(B, S, d)
        if "ws_gate" in p:
            y = y + _shared_experts(p, x)
        return y, aux
    dp, tp = mcx.dp_size, mcx.tp_size
    T_all = T * dp if mcx.batch_split else T      # the reference's T
    shared_split = L.splits(cfg.num_shared_experts * cfg.moe_d_ff, mcx)
    if cfg.moe_dispatch == "a2a" and T_all % (dp * tp) == 0:
        y, aux = _moe_a2a(p, xt, cfg, mcx)
    else:
        y, aux = _moe_psum(p, xt, cfg, mcx, T_all)
    y = y.view(B, S, d)
    if "ws_gate" in p:
        if shared_split:
            y = y + mcx.all_reduce(_shared_experts(p, mcx.fan_out(x)))
        else:
            y = y + _shared_experts(p, x)
    return y, aux


def _aux_over(top_e, probs, cfg, mcx, axis):
    """The load-balancing loss of the tokens of every rank of ``axis``
    (equal shares): the expert density and the mean router probability
    each a mean over the ranks (the reference's ``pmean``), then their
    product summed."""
    n = mcx.axis_size(axis)
    E = cfg.num_experts
    density = F.one_hot(top_e[:, 0], E).float().mean(0)
    router_mean = probs.mean(0)
    if n > 1:
        density = mcx.all_reduce(density, axis) / n
        router_mean = mcx.all_reduce(router_mean, axis) / n
    return (density * router_mean).sum() * E * cfg.router_aux_coef


def _moe_psum(p, xt, cfg, mcx, T_all: int):
    """The ``psum`` dispatch: the rank's tokens (split over "data" where
    the batch is not but the data axis divides the tokens, then gathered
    back) routed in full, the assignments to the rank's E / tp experts run
    at the capacity of all ``T_all`` tokens, and the partial outputs
    summed over "model".  Returns (y (T, d), aux)."""
    E = cfg.num_experts
    dp, T = mcx.dp_size, xt.shape[0]
    split_here = not mcx.batch_split and dp > 1 and T % dp == 0
    if split_here:
        xt = xt.view(dp, T // dp, -1)[mcx.data_index]
    top_p, top_e, probs, aux = route(p["router"], xt, cfg)
    if (mcx.batch_split or split_here) and dp > 1:
        aux = _aux_over(top_e, probs, cfg, mcx, "data")
    n_exp = E // mcx.tp_size if L.splits(E, mcx) else E
    lo = mcx.model_index * n_exp if n_exp != E else 0
    if n_exp != E:
        y = _dispatch(mcx.fan_out(xt), p, mcx.fan_out(top_p), top_e, cfg,
                      capacity(T_all, cfg), lo, n_exp)
        y = mcx.all_reduce(y)
    else:
        y = _dispatch(xt, p, top_p, top_e, cfg, capacity(T_all, cfg), lo,
                      n_exp)
    if split_here:
        y = mcx.all_gather(y, 0, axis="data")
    return y, aux


def _moe_a2a(p, xt, cfg, mcx):
    """The ``a2a`` dispatch: the rank's share of the tokens, split over
    data x model (shard ``data_index * tp + model_index``), routed locally
    at the capacity of that share; a send buffer (tp, E / tp * C, d)
    grouped by the experts' owner goes out by one all-to-all over "model",
    the rank runs its experts on what it received, a second all-to-all
    brings the outputs back, and the shares are gathered to the rank's
    rows.  The load-balancing loss is a mean over every rank.  Returns (y
    (T, d), aux)."""
    E, k = cfg.num_experts, cfg.top_k
    dp, tp = mcx.dp_size, mcx.tp_size
    E_loc = E // tp
    T, d = xt.shape
    axis = "model" if mcx.batch_split else ("data", "model")
    n = mcx.axis_size(axis)
    T_loc = T // n
    xt_l = mcx.fan_out(xt).view(n, T_loc, d)[mcx.axis_index(axis)]
    C = capacity(T_loc, cfg)
    top_p, top_e, probs, _ = route(mcx.fan_out(p["router"]), xt_l, cfg)
    aux = _aux_over(top_e, probs, cfg, mcx, ("data", "model"))
    kept, slot = assign_slots(top_e, E, C)
    flat_t = torch.arange(T_loc, device=xt.device).repeat_interleave(k)
    send = xt_l.new_zeros((E * C + 1, d)).index_put((slot,), xt_l[flat_t])
    send = send[:E * C].view(tp, E_loc * C, d)
    recv = mcx.all_to_all(send)                      # (tp, E_loc*C, d)
    # grouped by local expert: (tp, E_loc, C, d) -> (E_loc, tp*C, d)
    recv = recv.view(tp, E_loc, C, d).transpose(0, 1).reshape(E_loc,
                                                              tp * C, d)
    out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], recv)
    out = out.view(E_loc, tp, C, d).transpose(0, 1).reshape(tp, E_loc * C, d)
    back = mcx.all_to_all(out).reshape(E * C, d)
    contrib = torch.where(kept[:, None], back[slot.clamp(max=E * C - 1)], 0.0)
    y_l = _combine(contrib, top_p, T_loc, k, xt.dtype)
    return mcx.all_gather(y_l, 0, axis), aux
