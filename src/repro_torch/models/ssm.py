"""State-space model blocks of the port: Mamba-1 (selective scan) and
Mamba-2 (SSD), the counterpart of ``repro.models.ssm`` on one device.

Both scans are chunked as on the reference: within a chunk, Mamba-1's
recurrence is an inclusive scan (a log2(c)-step doubling scan here, where
the reference takes ``lax.associative_scan``) and SSD's is in matmul form;
chunk boundary states are carried by a short sequential loop.  Operands
that the reference contracts with ``preferred_element_type=float32`` are
upcast and contracted in float32, and its casts back to the activation
dtype are kept where it makes them.

Decode carries ``(conv_state, ssm_state)`` per layer.

On a mesh (``mcx``, the rank's ``MeshCtx``) Mamba-1 splits ``d_inner``
over "model" where tp divides it, as the reference's rules do: the rank
holds its channels of ``conv_w``, ``conv_b``, ``dt_bias``, ``D``,
``A_log``, ``dt_proj`` (columns), ``out_proj`` and ``x_proj`` (rows), and
of ``in_proj`` its channels of x and its channels of z (``[x_r | z_r]``,
``models.model.shard_leaf``).  ``x_proj``'s rows make (dt_r, B, C)
partial sums, all-reduced over "model" before ``dt_proj`` and the scan;
``out_proj`` is row-parallel, then an all-reduce; the conv and scan
states are the rank's channels.  Mamba-2 (the hybrid) keeps every weight
whole on every rank and runs the SSD in full, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (fan_out, normal, pad_seq, param,
                                       splits, torch_dtype)

# Mamba-1's prefill scans at most this many float32 elements of shape
# (B, S, channels, N) at a time (1 GiB each): channels are independent until
# ``out_proj``, so ``mamba1_fwd`` scans ``d_inner`` in slices and its
# transients stay at a few GB (falcon_mamba_7b at 8 x 2048 would otherwise
# hold four 8.6 GB tensors and the scan's temporaries).
SCAN_SLICE_ELEMS = 1 << 28


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_mamba1(cfg, generator) -> nn.ParameterDict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    R, K = cfg.ssm_dt_rank, cfg.ssm_conv
    dt, dev = torch_dtype(cfg.dtype), generator.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(di, N)
    return nn.ParameterDict({
        "in_proj": param(normal((d, 2 * di), generator, dt)),
        "conv_w": param(normal((K, di), generator, dt)),
        "conv_b": param(torch.zeros(di, dtype=dt, device=dev)),
        "x_proj": param(normal((di, R + 2 * N), generator, dt)),
        "dt_proj": param(normal((R, di), generator, dt)),
        "dt_bias": param(torch.zeros(di, device=dev)),
        "A_log": param(torch.log(A)),
        "D": param(torch.ones(di, device=dev)),
        "out_proj": param(normal((di, d), generator, dt))})


def init_mamba2(cfg, generator) -> nn.ParameterDict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    K, nh, g = cfg.ssm_conv, cfg.ssm_nheads, cfg.ssm_ngroups
    dt, dev = torch_dtype(cfg.dtype), generator.device
    conv_dim = di + 2 * g * N
    return nn.ParameterDict({
        "in_proj": param(normal((d, 2 * di + 2 * g * N + nh), generator, dt)),
        "conv_w": param(normal((K, conv_dim), generator, dt)),
        "conv_b": param(torch.zeros(conv_dim, dtype=dt, device=dev)),
        "dt_bias": param(torch.zeros(nh, device=dev)),
        "A_log": param(torch.zeros(nh, device=dev)),
        "D": param(torch.ones(nh, device=dev)),
        "norm_scale": param(torch.ones(di, device=dev)),   # gated RMSNorm
        "out_proj": param(normal((di, d), generator, dt))})


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), device=x.device))


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b, state=None):
    """x: (B,S,C); w: (K,C).  Returns (y, tail), tail the last K-1 inputs
    (for decode).  A given ``state`` (B,K-1,C) is prepended.  As on the
    reference, y is a sum of K shifted products in x's dtype, then + b."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    tail = xp[:, S:] if K > 1 else x.new_zeros((B, 0, C))
    return y + b, tail


def conv1d_step(x, w, b, state):
    """x: (B,C) one step; state: (B,K-1,C).  The reference's einsum over
    K, accumulated in float32 and rounded once."""
    xp = torch.cat([state, x[:, None]], dim=1)             # (B,K,C)
    y = (xp.float() * w.float()).sum(1).to(x.dtype) + b
    return y, xp[:, 1:]


# ---------------------------------------------------------------------------
# chunked diagonal selective scan (mamba1)
#   h_t = a_t * h_{t-1} + u_t ;   a, u: (B, S, C, N)
# ---------------------------------------------------------------------------
def chunked_diag_scan(a, u, chunk: int, h0=None):
    """Every h_t, (B,S,C,N); ``a`` and ``u`` are left as they are."""
    return _diag_scan(a.clone(), u.clone(), chunk, h0)


def _diag_scan(a, u, chunk: int, h0):
    """``chunked_diag_scan`` on buffers it owns.  Where autograd records
    (grad mode on and an input that needs a gradient), the scan is
    ``_DiagScan``, whose backward is a scan of its own; otherwise it runs
    in place (``_scan_owned``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, u, h0)):
        return _DiagScan.apply(a, u, chunk, h0)
    return _scan_owned(a, u, chunk, h0)


class _DiagScan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + u_t under autograd.  The forward is
    ``_scan_owned`` on copies and saves ``a``, the states and ``h0``.  The
    backward is the adjoint recurrence in reverse time (``_adjoint``);
    then du_t = g_t, da_t = g_t h_{t-1} and dh0 = a_0 g_0."""

    @staticmethod
    def forward(ctx, a, u, chunk: int, h0):
        h = _scan_owned(a.clone(), u.clone(), chunk, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.chunk = chunk
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h, h0 = ctx.saved_tensors
        g = _adjoint(a, gh, ctx.chunk)
        h_prev = torch.cat([h.new_zeros(h[:, :1].shape) if h0 is None
                            else h0[:, None], h[:, :-1]], dim=1)
        da = g * h_prev
        dh0 = None if h0 is None else a[:, 0] * g[:, 0]
        return da, g, None, dh0


def _adjoint(a, gh, chunk):
    """g_t = dL/dh_t + a_{t+1} g_{t+1}, in reverse time: the forward's
    chunked doubling scan run on the flipped inputs, so it keeps the
    forward's memory bound."""
    a_next = torch.cat([a[:, 1:], a.new_zeros(a[:, :1].shape)], dim=1)
    return _scan_owned(a_next.flip(1), gh.flip(1).contiguous(), chunk,
                       None).flip(1)


def _scan_owned(a, u, chunk, h0):
    """``chunked_diag_scan`` on buffers it may overwrite."""
    B, S, C, N = a.shape
    c = min(chunk, S)
    pad = -S % c
    if pad:
        # identity padding: decay 1, input 0 - state passes through unchanged
        a = torch.cat([a, a.new_ones((B, pad, C, N))], dim=1)
        u = torch.cat([u, u.new_zeros((B, pad, C, N))], dim=1)
    nc = (S + pad) // c
    A_cum, U_cum = a.view(B, nc, c, C, N), u.view(B, nc, c, C, N)
    # within-chunk inclusive scan, Hillis-Steele: after the step at offset
    # k, position t holds combine(x[t-2k+1 .. t-k], x[t-k+1 .. t]) with the
    # reference's combine((al, ul), (ar, ur)) = (al * ar, ul * ar + ur);
    # each step reads one pair of buffers and writes the other
    A_nxt, U_nxt = torch.empty_like(A_cum), torch.empty_like(U_cum)
    k = 1
    while k < c:
        A_nxt[:, :, :k] = A_cum[:, :, :k]
        U_nxt[:, :, :k] = U_cum[:, :, :k]
        torch.mul(U_cum[:, :, :-k], A_cum[:, :, k:], out=U_nxt[:, :, k:])
        U_nxt[:, :, k:] += U_cum[:, :, k:]
        torch.mul(A_cum[:, :, :-k], A_cum[:, :, k:], out=A_nxt[:, :, k:])
        A_cum, A_nxt, U_cum, U_nxt = A_nxt, A_cum, U_nxt, U_cum
        k *= 2
    del A_nxt, U_nxt
    # chunk boundaries, in order: h_in(z + 1) = A_last(z) * h_in(z) + U_last(z)
    h = a.new_zeros((B, C, N)) if h0 is None else h0
    h_ins = a.new_empty((B, nc, C, N))
    for z in range(nc):
        h_ins[:, z] = h
        h = A_cum[:, z, -1] * h + U_cum[:, z, -1]
    # h_all = A_cum * h_in + U_cum, in place
    h_all = A_cum.mul_(h_ins[:, :, None]).add_(U_cum)
    return h_all.view(B, nc * c, C, N)[:, :S]


def _channel_slices(B, S, C, N, budget):
    """Slices of the channel axis whose (B, S, slice, N) tensors hold at
    most ``budget`` elements (one channel at the least)."""
    step = max(1, budget // max(1, B * S * N))
    return [slice(lo, min(lo + step, C)) for lo in range(0, C, step)]


def _split(cfg, mcx):
    """The rank's context where Mamba-1's ``d_inner`` is split over
    "model", else None."""
    return mcx if splits(cfg.d_inner, mcx) and mcx.tp_size > 1 else None


def mamba1_fwd(p, x, cfg, state=None, mcx=None):
    """x: (B,S,d) -> (B,S,d).  state=(conv_state, h) enables streaming:
    then returns (out, (conv_tail, h of the last position)).  The scan and
    its readout run over slices of ``d_inner`` of at most
    ``SCAN_SLICE_ELEMS`` elements each; no value depends on the slice.  On
    a mesh, over the rank's channels (the states too)."""
    B, S, d = x.shape
    mcx = _split(cfg, mcx)
    di, N, R = p["D"].shape[0], cfg.ssm_state, cfg.ssm_dt_rank
    xz = torch.einsum("bsd,de->bse", fan_out(x, mcx), p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    conv_state = state[0] if state is not None else None
    xin, conv_tail = causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin.float()).to(x.dtype)

    proj = torch.einsum("bsc,ce->bse", xin, p["x_proj"])
    if mcx is not None:
        proj = mcx.fan_out(mcx.all_reduce(proj))
    dt_r, Bmat, Cmat = proj.split([R, N, N], dim=-1)
    dt = torch.einsum("bsr,rc->bsc", dt_r, p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"])                      # (B,S,di)
    A = -torch.exp(p["A_log"])                             # (di,N)
    Bf, Cf, xf = Bmat.float()[:, :, None, :], Cmat.float(), xin.float()
    h0 = state[1] if state is not None else None
    ys, h_last = [], []
    for sl in _channel_slices(B, S, di, N, SCAN_SLICE_ELEMS):
        a = torch.exp(dt[..., sl, None] * A[sl])          # (B,S,c,N)
        u = dt[..., sl, None] * Bf * xf[..., sl, None]    # (B,S,c,N)
        h0_sl = None if h0 is None else h0[:, sl]
        h = _diag_scan(a, u, cfg.ssm_chunk, h0_sl)
        del a, u
        # y = einsum("bscn,bsn->bsc", h, C) as a product and a sum over N:
        # a matmul's blocking (so its rounding) would follow the slice
        ys.append((h * Cf[:, :, None, :]).sum(-1))
        h_last.append(h[:, -1].clone())
        del h
    y = torch.cat(ys, dim=-1)
    y = y + p["D"] * xf
    y = y * F.silu(z.float())
    out = torch.einsum("bsc,cd->bsd", y.to(x.dtype), p["out_proj"])
    if mcx is not None:
        out = mcx.all_reduce(out)
    if state is not None:
        return out, (conv_tail, torch.cat(h_last, dim=1))
    return out


def mamba1_step(p, x, cfg, state, mcx=None):
    """Single decode step.  x: (B,d); state=(conv_state (B,K-1,di),
    h (B,di,N)), on a mesh the rank's channels.  Returns (out (B,d), new
    state)."""
    conv_state, h = state
    mcx = _split(cfg, mcx)
    N, R = cfg.ssm_state, cfg.ssm_dt_rank
    xz = torch.einsum("bd,de->be", x, p["in_proj"])
    xin, z = xz.chunk(2, dim=-1)
    xin, conv_state = conv1d_step(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin.float()).to(x.dtype)
    proj = torch.einsum("bc,ce->be", xin, p["x_proj"])
    if mcx is not None:
        proj = mcx.all_reduce(proj)
    dt_r, Bv, Cv = proj.split([R, N, N], dim=-1)
    dt = torch.einsum("br,rc->bc", dt_r, p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                       # (B,di,N)
    u = dt[..., None] * Bv[:, None, :].float() * xin[..., None].float()
    h = a * h + u
    y = torch.einsum("bcn,bn->bc", h, Cv.float())
    y = y + p["D"] * xin.float()
    y = y * F.silu(z.float())
    out = torch.einsum("bc,cd->bd", y.to(x.dtype), p["out_proj"])
    if mcx is not None:
        out = mcx.all_reduce(out)
    return out, (conv_state, h)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (chunked, matmul form)
# ---------------------------------------------------------------------------
def _segsum(log_a):
    """log_a: (..., c).  Returns (..., c, c) with L[i,j] = sum_{j<k<=i}
    log_a[k] for j<=i else -inf."""
    c = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]             # sum_{j<k<=i}
    ar = torch.arange(c, device=log_a.device)
    return torch.where(ar[:, None] >= ar[None, :], diff, -math.inf)


def ssd_chunked(xh, log_a, Bm, Cm, chunk: int, h0=None):
    """SSD scan.  xh: (B,S,nh,hd); log_a: (B,S,nh); Bm, Cm: (B,S,g,N).
    Returns y (B,S,nh,hd) in xh's dtype and the final state (B,nh,hd,N)
    in float32.  Requires nh == N, as the reference does (see y_inter)."""
    B, S, nh, hd = xh.shape
    g, N = Bm.shape[2], Bm.shape[3]
    if nh != N:
        raise ValueError(f"Size of label 'n' for operand 1 ({nh}) does not "
                         f"match previous terms ({N}).")
    dt = xh.dtype
    rep = nh // g
    c = min(chunk, S)
    S_real = S
    pad = -S % c
    if pad:
        xh, log_a, Bm, Cm = (pad_seq(t, pad) for t in (xh, log_a, Bm, Cm))
        S = S + pad
    nc = S // c
    xc = xh.reshape(B, nc, c, nh, hd)
    la = log_a.reshape(B, nc, c, nh)
    Bc = Bm.reshape(B, nc, c, g, N).repeat_interleave(rep, dim=3).float()
    Cc = Cm.reshape(B, nc, c, g, N).repeat_interleave(rep, dim=3).float()

    # --- intra-chunk (quadratic in c, matmul form) ---
    Lmat = torch.exp(_segsum(la.movedim(-1, 2)))           # (B,nc,nh,c,c)
    scores = torch.einsum("bzchn,bzshn->bzhcs", Cc, Bc)
    scores = scores * Lmat
    del Lmat
    y_intra = torch.einsum("bzhcs,bzshd->bzchd", scores.to(dt).float(),
                           xc.float())
    del scores

    # --- chunk states: S_z = sum_j decay(end..j) B_j x_j^T ---
    cum = torch.cumsum(la, dim=2)                          # (B,nc,c,nh)
    total = cum[:, :, -1:]
    decay_to_end = torch.exp(total - cum)                  # (B,nc,c,nh)
    Bx = torch.einsum("bzshn,bzshd,bzsh->bzhdn", Bc, xc.float(),
                      decay_to_end.to(dt).float())         # (B,nc,nh,hd,N)

    # --- inter-chunk recurrence over chunk boundaries ---
    A_chunk = torch.exp(total[:, :, 0])                    # (B,nc,nh)
    h = (xh.new_zeros((B, nh, hd, N), dtype=torch.float32) if h0 is None
         else h0.float())
    h_ins = []
    for z in range(nc):
        h_ins.append(h)
        h = A_chunk[:, z, :, None, None] * h + Bx[:, z]
    h_ins = torch.stack(h_ins, dim=1)                      # (B,nc,nh,hd,N)

    # --- inter-chunk contribution to outputs ---
    # The reference's subscripts (src/repro/models/ssm.py:254) label h_ins
    # (B,nc,nh,hd,N) as "bzndn": the repeated n takes the diagonal
    # h_ins[b, z, i, d, i], not h_ins[b, z, h, d, n], and needs nh == N.
    # torch.einsum also takes a repeated subscript as a diagonal; the port
    # keeps that contraction so that it equals the reference.
    decay_from_start = torch.exp(cum)                      # (B,nc,c,nh)
    y_inter = torch.einsum("bzchn,bzndn,bzch->bzchd", Cc,
                           h_ins.to(dt).float(),
                           decay_from_start.to(dt).float())
    y = (y_intra + y_inter).reshape(B, S, nh, hd)[:, :S_real]
    return y.to(dt), h


def mamba2_fwd(p, x, cfg, state=None):
    """x: (B,S,d) -> (B,S,d); with ``state`` = (conv_state, h) also returns
    (conv_tail, final h)."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    nh, g, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_head_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * N, nh], dim=-1)
    conv_state = state[0] if state is not None else None
    xbc, conv_tail = causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, Bm, Cm = xbc.split([di, g * N, g * N], dim=-1)
    xh = xin.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, g, N)
    Cm = Cm.reshape(B, S, g, N)
    dt = _softplus(dt.float() + p["dt_bias"])              # (B,S,nh)
    A = -torch.exp(p["A_log"])                             # (nh,)
    log_a = dt * A                                         # (B,S,nh)
    xdt = xh * dt[..., None].to(xh.dtype)
    h0 = state[1] if state is not None else None
    y, h_fin = ssd_chunked(xdt, log_a, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + p["D"][:, None] * xh.float().to(y.dtype)
    y = y.reshape(B, S, di)
    # gated RMSNorm
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"]
    out = torch.einsum("bsc,cd->bsd", yf.to(x.dtype), p["out_proj"])
    if state is not None:
        return out, (conv_tail, h_fin)
    return out


def mamba2_step(p, x, cfg, state):
    """Single decode step.  x: (B,d); state=(conv (B,K-1,conv_dim),
    h (B,nh,hd,N)).  Returns (out (B,d), new state)."""
    conv_state, h = state
    di, N = cfg.d_inner, cfg.ssm_state
    nh, g, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_head_dim
    zxbcdt = torch.einsum("bd,de->be", x, p["in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * N, nh], dim=-1)
    xbc, conv_state = conv1d_step(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, Bv, Cv = xbc.split([di, g * N, g * N], dim=-1)
    xhh = xin.reshape(-1, nh, hd)
    Bv = Bv.reshape(-1, g, N).repeat_interleave(nh // g, dim=1)
    Cv = Cv.reshape(-1, g, N).repeat_interleave(nh // g, dim=1)
    dt = _softplus(dt.float() + p["dt_bias"])              # (B,nh)
    a = torch.exp(dt * -torch.exp(p["A_log"]))             # (B,nh)
    xdt = (xhh * dt[..., None].to(xhh.dtype)).float()
    u = xdt[..., :, None] * Bv.float()[..., None, :]       # (B,nh,hd,N)
    h = a[..., None, None] * h + u
    y = torch.einsum("bhdn,bhn->bhd", h, Cv.float())
    y = y + p["D"][:, None] * xhh.float()
    y = y.reshape(-1, di)
    yf = y * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["norm_scale"]
    out = torch.einsum("bc,cd->bd", yf.to(x.dtype), p["out_proj"])
    return out, (conv_state, h)
