"""Dense NN layers of the port: norms, RoPE, MLPs, chunked (flash-style)
attention and one-token decode attention over a KV cache.

Counterpart of ``repro.models.layers`` on one device: there is no mesh, so
the tensor-parallel degree is 1 and ``pad_to(H, 1) == H``.  Flags that only
change sharding or the backward pass (``explicit_tp``, ``flash_vjp``,
``remat``, ``zero1``, ``fsdp``, ``microbatches``) leave this forward pass
as it is.

Conventions, as in the reference: parameters are mappings of tensors (the
modules hold them as ``nn.ParameterDict``), weights are in the config's
dtype, norms and softmax run in float32, and attention scores and the
probability-value product accumulate in float32 from the weights' dtype
(the reference's ``preferred_element_type=jnp.float32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name."""
    return _DTYPES[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving weight: held by the module, never trained here."""
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


def apply_mlp(p, x, cfg):
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


def flash_attention(q, k, v, *, causal: bool, chunk: int):
    """Chunked attention.  q: (B,S,H,D); k, v: (B,S,H,D) (kv already
    repeated to H).  Loops over q-chunks (outer) and kv-chunks (inner,
    online softmax), as the reference's ``lax.map`` over ``lax.scan`` does.

    Under a causal mask the kv-chunks wholly after a q-chunk are skipped:
    there every score is -1e30, so the reference's step multiplies its
    running sums by exp(0) = 1 and adds exp(-1e30 - m) = 0, which leaves
    them bit for bit as they were."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    c = min(chunk, S)
    S_real = S
    if S % c:
        pad = (0, 0, 0, 0, 0, c - S % c)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        S = q.shape[1]
    nq = S // c
    scale = 1.0 / math.sqrt(D)
    ar = torch.arange(c, device=q.device)
    outs = []
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
    return torch.cat(outs, dim=1)[:, :S_real].to(q.dtype)


def repeat_kv(x, h_out: int):
    """(B,S,KV,D) -> (B,S,h_out,D) by group repetition."""
    B, S, KV, D = x.shape
    return x[:, :, :, None, :].expand(B, S, KV, h_out // KV, D).reshape(
        B, S, h_out, D)


def attention_fwd(p, x, cfg, *, positions, causal=True, return_kv=False):
    """Prefill attention.  x: (B,S,d)."""
    if causal and cfg.causal_tree_attn:
        raise NotImplementedError("causal_tree_attn is not ported: ROADMAP "
                                  "Queue 1 item 11 (causal_tree_attn)")
    H = cfg.num_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    if cfg.attn_type != "nope" and cfg.rope_theta and not cfg.is_encoder:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kv_cache = (k, v) if return_kv else None
    out = flash_attention(q, repeat_kv(k, H), repeat_kv(v, H), causal=causal,
                          chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    if return_kv:
        return y, kv_cache
    return y


# ---------------------------------------------------------------------------
# GQA decode attention over a KV cache
# ---------------------------------------------------------------------------
def gqa_decode_attention(p, x, cache, pos: int, cfg):
    """One-token decode.  x: (B,1,d); cache: dict(k, v) of (B,S,KV,hd).

    The reference's sequence-sharded attention with its log-sum-exp merge,
    at one shard.  As there, the new token's K/V is written into the cache
    (in place here) only where ``pos < S``, and the token attends to the
    positions ``<= pos``.  Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    x0 = x[:, 0]
    q = torch.einsum("bd,dhk->bhk", x0, p["wq"])
    k_new = torch.einsum("bd,dhk->bhk", x0, p["wk"])
    v_new = torch.einsum("bd,dhk->bhk", x0, p["wv"])
    if "bq" in p:
        q, k_new, v_new = q + p["bq"], k_new + p["bk"], v_new + p["bv"]
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k_new = _qk_norm(k_new, p["k_norm"])
    if cfg.rope_theta and not cfg.is_encoder:
        at = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q[:, None], at, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], at, cfg.rope_theta)[:, 0]
    if 0 <= pos < S:
        ck[:, pos] = k_new
        cv[:, pos] = v_new
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=x.device) <= pos
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", pr.to(cv.dtype).float(), cv.float())
    out = (o / l.clamp_min(1e-30)[..., None]).to(q.dtype).reshape(B, H, hd)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    if "bo" in p:
        y = y + p["bo"]
    return y[:, None], {"k": ck, "v": cv}
