"""NN layers of the port: norms, RoPE, MLPs, chunked (flash-style)
attention, one-token decode attention over a KV cache, and MLA (multi-head
latent attention) with its latent cache.

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


def mla_fwd(p, x, cfg, *, positions, return_kv=False):
    """MLA prefill, the non-absorbed form: per-head keys and values are
    expanded from the latent and go through ``flash_attention`` with the
    RoPE part of the key shared by every head.  x: (B,S,d).  With
    ``return_kv`` also returns the cache rows (c_kv (B,S,kvr), k_rope
    (B,S,dr))."""
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kvr = cfg.kv_lora_rank
    q_lat = _rms(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_a_norm"])
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])   # (B,S,H,dn+dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])     # (B,S,kvr+dr)
    c_kv = _rms(kv_a[..., :kvr], p["kv_a_norm"])
    k_rope = apply_rope(kv_a[..., None, kvr:], positions, cfg.rope_theta)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["wv_b"])
    q_full = torch.cat([q[..., :dn], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    out = flash_attention(q_full, k_full, v, causal=True,
                          chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if return_kv:
        return y, (c_kv, k_rope[:, :, 0])
    return y


def mla_decode_attention(p, x, cache, pos: int, cfg):
    """One-token MLA decode, the absorbed form: the query's non-RoPE part
    is taken into the latent space through ``wk_b``, scores are taken
    against the latent cache plus the RoPE keys, and the context, taken in
    latent space, goes back out through ``wv_b`` and ``wo``.  x: (B,1,d);
    cache {"c_kv": (B,S,kvr), "k_rope": (B,S,dr)}.

    The reference's sequence-sharded body at one shard: the token's
    latent and RoPE key are written into the cache (in place) only where
    ``0 <= pos < S``, and the token attends to the positions ``<= pos``.
    Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    dn, dr, kvr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
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
    if 0 <= pos < S:
        cc[:, pos] = c_new
        ckr[:, pos] = kr_new
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), cc.float())
         + torch.einsum("bhk,bsk->bhs", q_rope.float(), ckr.float()))
    s = s / math.sqrt(dn + dr)
    s = torch.where(torch.arange(S, device=x.device) <= pos, s, -1e30)
    m = s.amax(-1)
    pr = torch.exp(s - m[..., None])
    l = pr.sum(-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(cc.dtype).float(), cc.float())
    ctx = (ctx / l.clamp_min(1e-30)[..., None]).to(q_abs.dtype)
    out = torch.einsum("bhr,rhk->bhk", ctx, p["wv_b"])
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])
    return y[:, None], {"c_kv": cc, "k_rope": ckr}
