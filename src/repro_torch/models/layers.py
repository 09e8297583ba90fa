"""NN layers of the port: norms, RoPE, MLPs, chunked (flash-style)
attention and its binary-tree causal form, one-token decode attention over
a KV cache, and MLA (multi-head latent attention) with its latent cache.

Counterpart of ``repro.models.layers``.  Without a mesh (``mcx=None``)
each function runs whole on one device.  With a ``MeshCtx``
(``repro_torch.launch.mesh``) it runs one rank's part of the reference's
sharded program, on that rank's slice of the weights
(``models.model.split_dim``):

* query heads are padded to a multiple of the tensor-parallel degree tp
  (zero rows in ``wq``, ``bq`` and ``wo``) and split over "model"; K/V
  heads are split where tp divides their count, else every rank holds all;
  prefill attention runs on the rank's heads, and the output projection is
  row-parallel, then an all-reduce over "model";
* the MLP is column-parallel in ``w_gate`` / ``w_up`` / ``b_up`` and
  row-parallel in ``w_down``, then an all-reduce.  ``explicit_tp`` (the
  reference's ``shard_map`` wrappers ``tp_col_einsum`` / ``tp_row_einsum``
  / ``_apply_mlp_explicit_tp``) computes the same function as GSPMD's
  layout there, so the port has this one path for both settings;
* decode keeps the cache split over the sequence across "model": each rank
  writes the new row only where ``pos`` falls in its chunk, attends over
  its chunk with every head (gathered), and the ranks merge by
  log-sum-exp (``merge_over_ranks``) before the row-parallel ``wo``;
* under autograd, what every rank holds whole and each rank reads only a
  part of (the input of a head- or column-split product, a K/V bias or
  projection every rank holds whole, the query / key norms) enters through
  ``fan_out``, whose gradient is summed over "model": so each rank's
  gradient of a weight it holds whole is the whole gradient.

Flags that only change sharding (``zero1``, ``fsdp``) leave the forward
pass as it is.  ``flash_vjp`` runs training and prefill attention through
``flash_attention_vjp``, whose backward recomputes the probabilities block
by block from the saved ``(q, k, v, out, m, l)``; without it autograd
differentiates ``flash_attention`` as it runs.

Conventions, as in the reference: parameters are mappings of tensors (the
modules hold them as ``nn.ParameterDict``), weights are in the config's
dtype, norms and softmax run in float32, and attention scores and the
probability-value product accumulate in float32 from the weights' dtype
(the reference's ``preferred_element_type=jnp.float32``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# the mesh: which dims a rank holds a slice of, and the decode's merge
# ---------------------------------------------------------------------------
def tp_of(mcx) -> int:
    return 1 if mcx is None else mcx.tp_size


def splits(n: int, mcx) -> bool:
    """Whether a dim of full size ``n`` is split over "model" (the
    reference's ``fits``: tp divides it)."""
    return mcx is not None and n % mcx.tp_size == 0


def fan_out(x, mcx):
    """``x`` (the same on every rank) as it enters a computation each rank
    of "model" does a part of: its gradient is summed over "model"
    (``MeshCtx.fan_out``; the identity without a mesh or autograd)."""
    return x if mcx is None else mcx.fan_out(x)


def local_part(t, dim: int, mcx):
    """The rank's slice of ``t`` (whole) along ``dim`` over "model"."""
    n = t.shape[dim] // mcx.tp_size
    return t.narrow(dim, mcx.model_index * n, n)


def merge_over_ranks(m, l, o, mcx):
    """The log-sum-exp merge of the ranks' partial attention over their
    sequence chunks (the reference's ``pmax`` / ``psum`` pair): m, l (...)
    the row max and sum, o (..., D) the unnormalised output.  A rank whose
    chunk holds no visible position has m = -1e30, so its correction is 0
    and it adds nothing.  At tp = 1 every correction is exp(0) = 1: the
    callers skip it there."""
    m_g = mcx.all_reduce(m, op="max")
    corr = torch.exp(m - m_g)
    return mcx.all_reduce(l * corr), mcx.all_reduce(o * corr[..., None])


def write_row(cache, new, pos: int, lo: int = 0) -> None:
    """The decode step's new cache row at global position ``pos``, written
    in place into ``cache`` (B, S_loc, ...), the chunk that starts at
    ``lo``, only where ``pos`` falls in it."""
    if 0 <= pos - lo < cache.shape[1]:
        cache[:, pos - lo] = new


def seq_split(t, mcx, head_dim: Optional[int] = None):
    """Prefill's cache rows t (B, S, ...) handed to the rank's sequence
    chunk (B, ceil(S / tp), ...), zero-padded past S.  Where t holds only
    the rank's heads along ``head_dim``, one all-to-all over "model" moves
    every rank's heads of each chunk to the chunk's owner; otherwise the
    rank slices its chunk."""
    tp, S = mcx.tp_size, t.shape[1]
    S_loc = -(-S // tp)
    if S_loc * tp != S:
        t = pad_seq(t, S_loc * tp - S)
    if head_dim is None:
        return t[:, mcx.model_index * S_loc:(mcx.model_index + 1) * S_loc]
    chunks = t.unflatten(1, (tp, S_loc)).movedim(1, 0)   # (tp, B, S_loc, ..)
    got = mcx.all_to_all(chunks)                         # by source rank
    return torch.cat(got.unbind(0), dim=head_dim)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight held by its module, built frozen: a model built for
    training (``models.model.build(..., training=True)``) makes its
    weights trainable."""
    return nn.Parameter(t, requires_grad=False)


def normal(shape, generator: torch.Generator, dtype: torch.dtype,
           std: float = 0.02) -> torch.Tensor:
    """``std``-scaled standard normals drawn in float32 on the generator's
    device, then cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg, device, d=None) -> nn.ParameterDict:
    d = d or cfg.d_model
    p = {"scale": param(torch.ones(d, device=device))}
    if cfg.norm_type == "layernorm":
        p["bias"] = param(torch.zeros(d, device=device))
    return nn.ParameterDict(p)


def apply_norm(p, x, cfg, eps=1e-5):
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with positions (..., S); rotates the two halves."""
    inv = rope_freqs(x.shape[-1], theta, x.device)        # (d/2,)
    ang = positions[..., None].float() * inv              # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(cfg, generator, d_ff=None) -> nn.ParameterDict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt, dev = torch_dtype(cfg.dtype), generator.device
    p = {}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = param(normal((d, ff), generator, dt))
    p["w_up"] = param(normal((d, ff), generator, dt))
    p["w_down"] = param(normal((ff, d), generator, dt))
    if cfg.mlp_type != "swiglu" and cfg.use_bias:
        p["b_up"] = param(torch.zeros(ff, dtype=dt, device=dev))
        p["b_down"] = param(torch.zeros(d, dtype=dt, device=dev))
    return nn.ParameterDict(p)


def apply_mlp(p, x, cfg, mcx=None, d_ff=None):
    """The MLP of width ``d_ff`` (``cfg.d_ff`` by default).  On a mesh
    whose tp divides the width, the rank holds columns of ``w_gate`` /
    ``w_up`` / ``b_up`` and rows of ``w_down``, and the partial outputs
    are summed over "model" before ``b_down``."""
    if splits(d_ff or cfg.d_ff, mcx):
        x = fan_out(x, mcx)
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("...d,df->...f", x, p["w_gate"])
        u = torch.einsum("...d,df->...f", x, p["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = torch.einsum("...d,df->...f", x, p["w_up"])
        if "b_up" in p:
            h = h + p["b_up"]
        if cfg.mlp_type == "squared_relu":
            h = torch.relu(h).square()
        else:
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.einsum("...f,fd->...d", h, p["w_down"])
    if splits(d_ff or cfg.d_ff, mcx):
        y = mcx.all_reduce(y)
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# ---------------------------------------------------------------------------
# GQA attention (prefill): chunked online softmax, never S x S
# ---------------------------------------------------------------------------
def init_attention(cfg, generator) -> nn.ParameterDict:
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    dt, dev = torch_dtype(cfg.dtype), generator.device
    p = {"wq": param(normal((d, H, hd), generator, dt)),
         "wk": param(normal((d, KV, hd), generator, dt)),
         "wv": param(normal((d, KV, hd), generator, dt)),
         "wo": param(normal((H, hd, d), generator, dt))}
    if cfg.use_bias:
        p["bq"] = param(torch.zeros(H, hd, dtype=dt, device=dev))
        p["bk"] = param(torch.zeros(KV, hd, dtype=dt, device=dev))
        p["bv"] = param(torch.zeros(KV, hd, dtype=dt, device=dev))
        p["bo"] = param(torch.zeros(d, dtype=dt, device=dev))
    if cfg.use_qk_norm:
        p["q_norm"] = param(torch.ones(hd, device=dev))
        p["k_norm"] = param(torch.ones(hd, device=dev))
    return nn.ParameterDict(p)


def _qk_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def pad_seq(x, pad):
    """x (B,S,...) zero-padded by ``pad`` positions along S."""
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)


def _flash_blocks(q, k, v, causal: bool, c: int, S_real: int):
    """The online-softmax forward over q-chunks (outer) and kv-chunks
    (inner) of length ``c`` (S a multiple of it), keys past ``S_real``
    masked.  Returns (out (B,S,H,Dv) float32, m, l (B,H,S) float32): the
    normalised output and each row's running max and sum.

    Under a causal mask the kv-chunks wholly after a q-chunk are skipped:
    there every score is -1e30, so the reference's step multiplies its
    running sums by exp(0) = 1 and adds exp(-1e30 - m) = 0, which leaves
    them bit for bit as they were."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    nq = S // c
    scale = 1.0 / math.sqrt(D)
    ar = torch.arange(c, device=q.device)
    outs, ms, ls = [], [], []
    for qi in range(nq):
        qb = q[:, qi * c:(qi + 1) * c].float()
        q_pos = qi * c + ar
        m = torch.full((B, H, c), -1e30, device=q.device)
        l = torch.zeros((B, H, c), device=q.device)
        acc = torch.zeros((B, H, c, Dv), device=q.device)
        for ki in range(qi + 1 if causal else nq):
            kb = k[:, ki * c:(ki + 1) * c]
            vb = v[:, ki * c:(ki + 1) * c]
            k_pos = ki * c + ar
            s_blk = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float()) * scale
            mask = (k_pos < S_real)[None, :].expand(c, c)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            s_blk = torch.where(mask, s_blk, -1e30)
            m_new = torch.maximum(m, s_blk.amax(-1))
            p_blk = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_blk.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p_blk.to(vb.dtype).float(), vb.float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.transpose(1, 2))                  # (B,c,H,Dv)
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1), torch.cat(ms, -1), torch.cat(ls, -1)


def flash_attention(q, k, v, *, causal: bool, chunk: int):
    """Chunked attention.  q: (B,S,H,D); k, v: (B,S,H,D) (kv already
    repeated to H).  Loops over q-chunks (outer) and kv-chunks (inner,
    online softmax), as the reference's ``lax.map`` over ``lax.scan``
    does; differentiated by autograd as it runs."""
    S = q.shape[1]
    c = min(chunk, S)
    pad = -S % c
    if pad:
        q, k, v = pad_seq(q, pad), pad_seq(k, pad), pad_seq(v, pad)
    out, _, _ = _flash_blocks(q, k, v, causal, c, S)
    return out[:, :S].to(q.dtype)


def _flash_bwd(causal: bool, c: int, q, k, v, out, m, l, g):
    """The reference's ``_flash_bwd``: with ``delta = rowsum(dO * O)``,
    each (q-chunk, kv-chunk) block's probabilities are recomputed from the
    saved row max and sum, and dq, dk, dv accumulate in float32 in the
    reference's order (kv-chunks within a q-chunk, q-chunks in turn).
    Fully masked causal blocks add exact zeros there and are skipped."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    nq = S // c
    scale = 1.0 / math.sqrt(D)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)    # (B,H,S)
    dq = torch.empty((B, S, H, D), device=q.device)
    dk = torch.zeros((B, S, H, D), device=q.device)
    dv = torch.zeros((B, S, H, Dv), device=q.device)
    ar = torch.arange(c, device=q.device)
    for qi in range(nq):
        qs = slice(qi * c, (qi + 1) * c)
        qb, gb = q[:, qs].float(), g[:, qs].float()
        m_i, l_i, d_i = m[..., qs], l[..., qs], delta[..., qs]
        q_pos = qi * c + ar
        dq_acc = torch.zeros((B, c, H, D), device=q.device)
        for ki in range(qi + 1 if causal else nq):
            ks = slice(ki * c, (ki + 1) * c)
            kb, vb = k[:, ks].float(), v[:, ks].float()
            s_blk = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if causal:
                k_pos = ki * c + ar
                s_blk = torch.where(q_pos[:, None] >= k_pos[None, :],
                                    s_blk, -1e30)
            p = torch.exp(s_blk - m_i[..., None]) / \
                l_i.clamp_min(1e-30)[..., None]                   # (B,H,c,c)
            dv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p, gb)
            dp = torch.einsum("bqhd,bkhd->bhqk", gb, vb)
            ds = p * (dp - d_i[..., None]) * scale
            dq_acc += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
            dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qb)
        dq[:, qs] = dq_acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` (a ``jax.custom_vjp``): the blockwise
    forward saves only ``(q, k, v, out, m, l)``, never a block of
    probabilities, and ``_flash_bwd`` recomputes them.  S must be a
    multiple of the chunk ``c``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, c: int):
        out, m, l = _flash_blocks(q, k, v, causal, c, q.shape[1])
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.c = causal, c
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _flash_bwd(ctx.causal, ctx.c, *ctx.saved_tensors, g)
        return dq, dk, dv, None, None


def flash_attention_vjp(q, k, v, *, causal: bool, chunk: int):
    """The reference's padded wrapper around ``_FlashCore``.  A causal
    sequence is zero-padded to a multiple of the chunk (padded keys come
    after every real query, so the mask hides them).  A non-causal one
    that needs padding runs ``flash_attention`` on the padded q, k and v,
    as the reference does: its padded keys are then not masked."""
    S = q.shape[1]
    c = min(chunk, S)
    pad = -S % c
    if pad:
        q, k, v = pad_seq(q, pad), pad_seq(k, pad), pad_seq(v, pad)
        if not causal:
            return flash_attention(q, k, v, causal=False, chunk=chunk)[:, :S]
    return _FlashCore.apply(q, k, v, causal, c)[:, :S]


def causal_tree_attention(q, k, v, *, chunk: int):
    """Binary-tree causal packing: causal(S) is causal attention on each
    half plus the second half's *unmasked* dense cross-attention onto the
    first, recursing until a block is at most ``chunk`` long, so the
    causal triangle is covered by dense rectangles; partial results merge
    by log-sum-exp, in the reference's order.  q, k, v: (B,S,H,D) (kv
    already repeated to H)."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def dense_block(qb, kb, vb, causal_mask):
        s_blk = torch.einsum("bqhd,bkhd->bhqk", qb.float(),
                             kb.float()) * scale
        if causal_mask:
            sq, sk = s_blk.shape[-2:]
            mask = torch.arange(sq, device=q.device)[:, None] >= \
                torch.arange(sk, device=q.device)[None, :]
            s_blk = torch.where(mask, s_blk, -1e30)
        m = s_blk.amax(-1)
        p = torch.exp(s_blk - m[..., None])
        l = p.sum(-1)
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(vb.dtype).float(),
                         vb.float())
        return m, l, o

    def merge(a, b):
        (ma, la, oa), (mb, lb, ob) = a, b
        m = torch.maximum(ma, mb)
        ca, cb = torch.exp(ma - m), torch.exp(mb - m)
        return m, la * ca + lb * cb, oa * ca[..., None] + ob * cb[..., None]

    def rec(qb, kb, vb):
        s = qb.shape[1]
        if s <= chunk:
            return dense_block(qb, kb, vb, True)
        h = s // 2
        m1, l1, o1 = rec(qb[:, :h], kb[:, :h], vb[:, :h])
        second = rec(qb[:, h:], kb[:, h:], vb[:, h:])
        rect = dense_block(qb[:, h:], kb[:, :h], vb[:, :h], False)
        m2, l2, o2 = merge(second, rect)
        return (torch.cat([m1, m2], -1), torch.cat([l1, l2], -1),
                torch.cat([o1, o2], -2))

    _, l, o = rec(q, k, v)                                 # o: (B,H,S,D)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B,S,H,D)


def repeat_kv(x, h_out: int):
    """(B,S,KV,D) -> (B,S,h_out,D) by group repetition."""
    B, S, KV, D = x.shape
    return x[:, :, :, None, :].expand(B, S, KV, h_out // KV, D).reshape(
        B, S, h_out, D)


def _kv_bias(p, name, kv_split, mcx):
    """A K/V bias (replicated over "model") for the K/V heads the rank
    computes."""
    b = fan_out(p[name], mcx)
    return local_part(b, 0, mcx) if kv_split else b


def attention_fwd(p, x, cfg, *, positions, causal=True, return_kv=False,
                  mcx=None):
    """Prefill attention.  x: (B,S,d).  On a mesh, over the rank's query
    heads (of H padded to a multiple of tp), with the K/V heads they read:
    the rank's own where tp divides KV, else every K/V head repeated to
    the padded H and cut to the rank's; then ``wo`` row-parallel and an
    all-reduce over "model".  With ``return_kv`` also the cache rows (k,
    v) (B,S,KV_l,hd), KV_l the K/V heads the rank computed."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    kv_split = splits(KV, mcx)
    x = fan_out(x, mcx)
    wk, wv = p["wk"], p["wv"]
    if not kv_split:
        wk, wv = fan_out(wk, mcx), fan_out(wv, mcx)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if "bq" in p:
        q = q + p["bq"]
        k = k + _kv_bias(p, "bk", kv_split, mcx)
        v = v + _kv_bias(p, "bv", kv_split, mcx)
    if "q_norm" in p:
        q = _qk_norm(q, fan_out(p["q_norm"], mcx))
        k = _qk_norm(k, fan_out(p["k_norm"], mcx))
    if cfg.attn_type != "nope" and cfg.rope_theta and not cfg.is_encoder:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kv_cache = (k, v) if return_kv else None
    if mcx is None or kv_split:
        k, v = repeat_kv(k, q.shape[2]), repeat_kv(v, q.shape[2])
    else:
        Hp = pad_to(H, mcx.tp_size)
        k = local_part(repeat_kv(k, Hp), 2, mcx)
        v = local_part(repeat_kv(v, Hp), 2, mcx)
    if causal and cfg.causal_tree_attn:
        out = causal_tree_attention(q, k, v, chunk=cfg.attn_chunk)
    elif cfg.flash_vjp:
        out = flash_attention_vjp(q, k, v, causal=causal,
                                  chunk=cfg.attn_chunk)
    else:
        out = flash_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if mcx is not None:
        y = mcx.all_reduce(y)
    if "bo" in p:
        y = y + p["bo"]
    if return_kv:
        return y, kv_cache
    return y


# ---------------------------------------------------------------------------
# GQA decode attention over a KV cache
# ---------------------------------------------------------------------------
def gqa_decode_attention(p, x, cache, pos: int, cfg, mcx=None):
    """One-token decode.  x: (B,1,d); cache: dict(k, v) of (B,S,KV,hd),
    on a mesh the rank's chunk of the sequence (S / tp positions from
    ``model_index * S / tp``).

    The reference's sequence-sharded attention with its log-sum-exp merge:
    the new token's K/V is written into the cache (in place here) only by
    the rank whose chunk holds ``pos``, and the token attends to the
    positions ``<= pos``.  On a mesh the rank computes its query heads and
    K/V heads, gathers every head over "model", attends over its chunk,
    merges (``merge_over_ranks``) and applies ``wo`` row-parallel, then an
    all-reduce.  Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    kv_split = splits(KV, mcx)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    x0 = x[:, 0]
    q = torch.einsum("bd,dhk->bhk", x0, p["wq"])
    k_new = torch.einsum("bd,dhk->bhk", x0, p["wk"])
    v_new = torch.einsum("bd,dhk->bhk", x0, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k_new = k_new + _kv_bias(p, "bk", kv_split, mcx)
        v_new = v_new + _kv_bias(p, "bv", kv_split, mcx)
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k_new = _qk_norm(k_new, p["k_norm"])
    if cfg.rope_theta and not cfg.is_encoder:
        at = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q[:, None], at, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], at, cfg.rope_theta)[:, 0]
    lo = 0
    if mcx is not None:
        q = mcx.all_gather(q, 1)
        if kv_split:
            k_new, v_new = mcx.all_gather(k_new, 1), mcx.all_gather(v_new, 1)
        lo = mcx.model_index * S
    H = q.shape[1]
    write_row(ck, k_new, pos, lo)
    write_row(cv, v_new, pos, lo)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float()) / math.sqrt(hd)
    valid = lo + torch.arange(S, device=x.device) <= pos
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", pr.to(cv.dtype).float(), cv.float())
    if tp_of(mcx) > 1:
        l, o = merge_over_ranks(m, l, o, mcx)
    out = (o / l.clamp_min(1e-30)[..., None]).to(q.dtype).reshape(B, H, hd)
    if mcx is not None:
        out = local_part(out, 1, mcx)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    if mcx is not None:
        y = mcx.all_reduce(y)
    if "bo" in p:
        y = y + p["bo"]
    return y[:, None], {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): queries and keys/values through low-rank latents; the
# cache holds the normed KV latent and the shared RoPE key per position
# ---------------------------------------------------------------------------
def init_mla(cfg, generator) -> nn.ParameterDict:
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt, dev = torch_dtype(cfg.dtype), generator.device
    return nn.ParameterDict({
        "wq_a": param(normal((d, qr), generator, dt)),
        "q_a_norm": param(torch.ones(qr, device=dev)),
        "wq_b": param(normal((qr, H, dn + dr), generator, dt)),
        "wkv_a": param(normal((d, kvr + dr), generator, dt)),
        "kv_a_norm": param(torch.ones(kvr, device=dev)),
        "wk_b": param(normal((kvr, H, dn), generator, dt)),
        "wv_b": param(normal((kvr, H, dv), generator, dt)),
        "wo": param(normal((H, dv, d), generator, dt))})


_rms = _qk_norm     # the reference's name for the latents' RMS norm


def mla_fwd(p, x, cfg, *, positions, return_kv=False, mcx=None):
    """MLA prefill, the non-absorbed form: per-head keys and values are
    expanded from the latent and go through ``flash_attention`` (or
    ``flash_attention_vjp`` under ``flash_vjp``) with the RoPE part of the
    key shared by every head.  x: (B,S,d).  On a mesh whose tp divides the
    heads, over the rank's heads, ``wo`` row-parallel and an all-reduce
    over "model" (else every rank runs every head).  With ``return_kv``
    also returns the cache rows (c_kv (B,S,kvr), k_rope (B,S,dr)), whole
    on every rank."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    part = fan_out if splits(cfg.num_heads, mcx) else (lambda t, m: t)
    q_lat = _rms(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_a_norm"])
    q = torch.einsum("bsr,rhk->bshk", part(q_lat, mcx), p["wq_b"])
    H = q.shape[2]                                        # (B,S,H,dn+dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])     # (B,S,kvr+dr)
    c_kv = _rms(kv_a[..., :kvr], p["kv_a_norm"])
    k_rope = apply_rope(kv_a[..., None, kvr:], positions, cfg.rope_theta)
    c_in = part(c_kv, mcx)
    k_nope = torch.einsum("bsr,rhk->bshk", c_in, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_in, p["wv_b"])
    q_full = torch.cat([q[..., :dn], q_rope], dim=-1)
    k_full = torch.cat([k_nope, part(k_rope, mcx).expand(B, S, H, dr)],
                       dim=-1)
    attend = flash_attention_vjp if cfg.flash_vjp else flash_attention
    out = attend(q_full, k_full, v, causal=True, chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if splits(cfg.num_heads, mcx):
        y = mcx.all_reduce(y)
    if return_kv:
        return y, (c_kv, k_rope[:, :, 0])
    return y


def mla_decode_attention(p, x, cache, pos: int, cfg, mcx=None):
    """One-token MLA decode, the absorbed form: the query's non-RoPE part
    is taken into the latent space through ``wk_b``, scores are taken
    against the latent cache plus the RoPE keys, and the context, taken in
    latent space, goes back out through ``wv_b`` and ``wo``.  x: (B,1,d);
    cache {"c_kv": (B,S,kvr), "k_rope": (B,S,dr)}, on a mesh the rank's
    chunk of the sequence.

    The reference's sequence-sharded body: the token's latent and RoPE key
    are written into the cache (in place) only by the rank whose chunk
    holds ``pos``, and the token attends to the positions ``<= pos``.  On
    a mesh whose tp divides the heads the rank absorbs its heads' queries
    and gathers every head over "model"; the ranks merge by log-sum-exp,
    and each takes its heads' context out through ``wv_b`` and ``wo``,
    then an all-reduce.  Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    dn, dr, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    heads_split = splits(cfg.num_heads, mcx)
    cc, ckr = cache["c_kv"], cache["k_rope"]
    S = cc.shape[1]
    x0 = x[:, 0]
    at = torch.full((B, 1), pos, device=x.device)
    q_lat = _rms(torch.einsum("bd,dr->br", x0, p["wq_a"]), p["q_a_norm"])
    q = torch.einsum("br,rhk->bhk", q_lat, p["wq_b"])
    q_rope = apply_rope(q[:, None, :, dn:], at, cfg.rope_theta)[:, 0]
    q_abs = torch.einsum("bhk,rhk->bhr", q[..., :dn], p["wk_b"])
    kv_a = torch.einsum("bd,dr->br", x0, p["wkv_a"])
    c_new = _rms(kv_a[..., :kvr], p["kv_a_norm"])
    kr_new = apply_rope(kv_a[:, None, None, kvr:], at,
                        cfg.rope_theta)[:, 0, 0]
    lo = 0
    if mcx is not None:
        if heads_split:
            q_abs, q_rope = mcx.all_gather(q_abs, 1), mcx.all_gather(q_rope, 1)
        lo = mcx.model_index * S
    write_row(cc, c_new, pos, lo)
    write_row(ckr, kr_new, pos, lo)
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), cc.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), ckr.float()))
    s = s / math.sqrt(dn + dr)
    s = torch.where(lo + torch.arange(S, device=x.device) <= pos, s, -1e30)
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(cc.dtype).float(), cc.float())
    if tp_of(mcx) > 1:
        l, ctx = merge_over_ranks(m, l, ctx, mcx)
    ctx = (ctx / l.clamp_min(1e-30)[..., None]).to(q_abs.dtype)
    if heads_split:
        ctx = local_part(ctx, 1, mcx)
    out = torch.einsum("bhr,rhk->bhk", ctx, p["wv_b"])
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    if heads_split:
        y = mcx.all_reduce(y)
    return y[:, None], {"c_kv": cc, "k_rope": ckr}
