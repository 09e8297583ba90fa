"""Layer stacks of the port's decoder and encoder LMs: the attention
families of ``repro.models.transformer`` (``dense``, ``vlm``, ``audio``).

The reference scans a parameter pytree stacked on a leading layer axis;
here the layers are an ``nn.ModuleList`` walked in order.  KV caches keep
the reference's layout, ``{"k", "v"}`` of shape (L, B, S, KV, hd).  What
the port has not reached raises ``NotImplementedError`` naming its ROADMAP
item (``check_supported``).
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import layers as L

ATTENTION_FAMILIES = ("dense", "vlm", "audio")


# the ROADMAP item of each layer kind the port does not run yet
_MOE, _SSM = "8 (MoE and MLA forward)", "9 (SSM and hybrid forward)"
UNPORTED = {"moe": _MOE, "moe_dense": _MOE, "ssm": _SSM, "hybrid": _SSM}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported: ROADMAP Queue 1 item "
                               f"{item}")


def check_supported(cfg) -> None:
    """Raise for a configuration this slice of the port does not run."""
    if cfg.attn_type == "mla":
        raise _unported(f"{cfg.name}: MLA attention", _MOE)
    if cfg.family in UNPORTED:
        raise _unported(f"{cfg.name}: the {cfg.family} family",
                        UNPORTED[cfg.family])
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(cfg.family)
    if cfg.causal_tree_attn:
        raise _unported(f"{cfg.name}: causal_tree_attn", "11 "
                        "(causal_tree_attn)")


# ---------------------------------------------------------------------------
# per-layer init / fwd
# ---------------------------------------------------------------------------
def init_layer(cfg, generator) -> nn.ModuleDict:
    """A dense layer (the one kind ``stack_groups`` yields here)."""
    dev = generator.device
    p = {"ln_attn": L.init_norm(cfg, dev),
         "attn": L.init_attention(cfg, generator)}
    if not cfg.parallel_block:
        p["ln_mlp"] = L.init_norm(cfg, dev)
    p["mlp"] = L.init_mlp(cfg, generator)
    return nn.ModuleDict(p)


def attn_block_fwd(p, x, cfg, positions, *, causal, return_kv=False):
    h = L.apply_norm(p["ln_attn"], x, cfg)
    out = L.attention_fwd(p["attn"], h, cfg, positions=positions,
                          causal=causal, return_kv=return_kv)
    attn_y, kv = out if return_kv else (out, None)
    if cfg.parallel_block:
        # cohere-style: one shared input norm, attn + mlp in parallel
        y = x + attn_y + L.apply_mlp(p["mlp"], h, cfg)
    else:
        x = x + attn_y
        y = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return (y, kv) if return_kv else y


def attn_block_decode(p, x, cache, pos, cfg):
    h = L.apply_norm(p["ln_attn"], x, cfg)
    attn_y, cache = L.gqa_decode_attention(p["attn"], h, cache, pos, cfg)
    if cfg.parallel_block:
        return x + attn_y + L.apply_mlp(p["mlp"], h, cfg), cache
    x = x + attn_y
    h2 = L.apply_norm(p["ln_mlp"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h2, cfg), cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def stack_groups(cfg):
    """(kind, lo, hi) runs of identical layer kinds: the reference's
    stacks, each a scanned group of ``init_stack``'s ``"stacks"``."""
    check_supported(cfg)
    return [("dense", 0, cfg.num_layers)]


def init_stack(cfg, generator) -> dict:
    """Random parameters on the generator's device: the embedding (vocab
    padded to a multiple of 256, Megatron-style), the unembedding unless
    tied, the final norm and the layers."""
    dt, dev = L.torch_dtype(cfg.dtype), generator.device
    V = L.pad_to(cfg.vocab_size, 256)
    params = {"emb": L.param(L.normal((V, cfg.d_model), generator, dt))}
    if not cfg.tie_embeddings:
        params["unemb"] = L.param(L.normal((cfg.d_model, V), generator, dt))
    params["ln_final"] = L.init_norm(cfg, dev)
    params["layers"] = nn.ModuleList(
        init_layer(cfg, generator)
        for _, lo, hi in stack_groups(cfg) for _ in range(lo, hi))
    return params


# ---------------------------------------------------------------------------
# prefill: forward + emit caches
# ---------------------------------------------------------------------------
def forward_prefill(layers, x, cfg, positions):
    """x: (B,S,d) after embedding.  Returns (hidden, {"k", "v"}), the
    caches exactly as long as the prompt, as on the reference."""
    B, S = x.shape[:2]
    shape = (len(layers), B, S, cfg.num_kv_heads, cfg.head_dim)
    caches = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    for i, lp in enumerate(layers):
        x, (k, v) = attn_block_fwd(lp, x, cfg, positions,
                                   causal=not cfg.is_encoder, return_kv=True)
        caches["k"][i] = k
        caches["v"][i] = v
    return x, caches


# ---------------------------------------------------------------------------
# decode: one token, caches carried
# ---------------------------------------------------------------------------
def forward_decode(layers, x, caches, pos, cfg):
    """x: (B,1,d).  Each layer writes the token's K/V into its slice of
    ``caches`` in place (where ``pos`` is inside them); returns (hidden,
    caches)."""
    for i, lp in enumerate(layers):
        x, _ = attn_block_decode(lp, x, {"k": caches["k"][i],
                                         "v": caches["v"][i]}, pos, cfg)
    return x, caches

