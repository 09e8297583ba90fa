"""Layer stacks of the port's decoder and encoder LMs: the attention
families of ``repro.models.transformer`` (``dense``, ``vlm``, ``audio``,
``moe``).

The reference scans a parameter pytree stacked on a leading layer axis,
one stack per run of identical layer kinds (``stack_groups``); here the
layers are one ``nn.ModuleList`` walked in order.  Caches keep the
reference's layout: ``{"k", "v"}`` of shape (L, B, S, KV, hd) for GQA,
``{"c_kv": (L, B, S, kvr), "k_rope": (L, B, S, dr)}`` for MLA.  What the
port has not reached raises ``NotImplementedError`` naming its ROADMAP
item (``check_supported``).
"""
from __future__ import annotations

from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe")


# the ROADMAP item of each layer kind the port does not run yet
_SSM = "9 (SSM and hybrid forward)"
UNPORTED = {"ssm": _SSM, "hybrid": _SSM}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported: ROADMAP Queue 1 item "
                               f"{item}")


def check_supported(cfg) -> None:
    """Raise for a configuration this slice of the port does not run."""
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
def init_layer(cfg, generator, kind: str) -> nn.ModuleDict:
    """kind: dense | moe | moe_dense (MLA or GQA attention, then the
    experts, a dense FFN of width ``dense_d_ff``, or the dense FFN)."""
    dev = generator.device
    p = {"ln_attn": L.init_norm(cfg, dev)}
    if cfg.attn_type == "mla":
        p["attn"] = L.init_mla(cfg, generator)
    else:
        p["attn"] = L.init_attention(cfg, generator)
    if not cfg.parallel_block:
        p["ln_mlp"] = L.init_norm(cfg, dev)
    if kind == "moe":
        p["moe"] = MOE.init_moe(cfg, generator)
    elif kind == "moe_dense":
        p["mlp"] = L.init_mlp(cfg, generator, cfg.dense_d_ff)
    else:
        p["mlp"] = L.init_mlp(cfg, generator)
    return nn.ModuleDict(p)


def attn_block_fwd(p, x, cfg, positions, *, causal, return_kv=False):
    """As the reference: a parallel block returns y (and kv); otherwise
    (y, aux) (or (y, aux, kv)), aux the MoE's load-balancing loss or 0."""
    h = L.apply_norm(p["ln_attn"], x, cfg)
    if cfg.attn_type == "mla":
        out = L.mla_fwd(p["attn"], h, cfg, positions=positions,
                        return_kv=return_kv)
    else:
        out = L.attention_fwd(p["attn"], h, cfg, positions=positions,
                              causal=causal, return_kv=return_kv)
    attn_y, kv = out if return_kv else (out, None)
    if cfg.parallel_block:
        # cohere-style: one shared input norm, attn + mlp in parallel
        y = x + attn_y + L.apply_mlp(p["mlp"], h, cfg)
        return (y, kv) if return_kv else y
    x = x + attn_y
    h2 = L.apply_norm(p["ln_mlp"], x, cfg)
    if "moe" in p:
        mlp_y, aux = MOE.moe_fwd(p["moe"], h2, cfg)
    else:
        mlp_y, aux = L.apply_mlp(p["mlp"], h2, cfg), 0.0
    y = x + mlp_y
    return (y, aux, kv) if return_kv else (y, aux)


def attn_block_decode(p, x, cache, pos, cfg):
    h = L.apply_norm(p["ln_attn"], x, cfg)
    if cfg.attn_type == "mla":
        attn_y, cache = L.mla_decode_attention(p["attn"], h, cache, pos, cfg)
    else:
        attn_y, cache = L.gqa_decode_attention(p["attn"], h, cache, pos, cfg)
    if cfg.parallel_block:
        return x + attn_y + L.apply_mlp(p["mlp"], h, cfg), cache
    x = x + attn_y
    h2 = L.apply_norm(p["ln_mlp"], x, cfg)
    if "moe" in p:
        mlp_y, _ = MOE.moe_fwd(p["moe"], h2, cfg)
    else:
        mlp_y = L.apply_mlp(p["mlp"], h2, cfg)
    return x + mlp_y, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _layer_kinds(cfg):
    if cfg.family == "moe":
        return (["moe_dense"] * cfg.num_dense_layers
                + ["moe"] * (cfg.num_layers - cfg.num_dense_layers))
    return ["dense"] * cfg.num_layers


def stack_groups(cfg):
    """(kind, lo, hi) runs of identical layer kinds: the reference's
    stacks, each a scanned group of ``init_stack``'s ``"stacks"``."""
    check_supported(cfg)
    kinds = _layer_kinds(cfg)
    groups, start = [], 0
    for i in range(1, len(kinds) + 1):
        if i == len(kinds) or kinds[i] != kinds[start]:
            groups.append((kinds[start], start, i))
            start = i
    return groups


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
        init_layer(cfg, generator, kind)
        for kind, lo, hi in stack_groups(cfg) for _ in range(lo, hi))
    return params


# ---------------------------------------------------------------------------
# prefill: forward + emit caches
# ---------------------------------------------------------------------------
def cache_shapes(cfg, B: int, S: int) -> dict:
    """The shape of each cache of ``cfg`` for B sequences of S positions."""
    n = cfg.num_layers
    if cfg.attn_type == "mla":
        return {"c_kv": (n, B, S, cfg.kv_lora_rank),
                "k_rope": (n, B, S, cfg.qk_rope_dim)}
    shape = (n, B, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


def forward_prefill(layers, x, cfg, positions):
    """x: (B,S,d) after embedding.  Returns (hidden, caches), the caches
    exactly as long as the prompt, as on the reference."""
    B, S = x.shape[:2]
    caches = {n: x.new_empty(s) for n, s in cache_shapes(cfg, B, S).items()}
    for i, lp in enumerate(layers):
        out = attn_block_fwd(lp, x, cfg, positions, causal=not cfg.is_encoder,
                             return_kv=True)
        x, kv = out[0], out[-1]
        for name, c in zip(caches, kv):
            caches[name][i] = c
    return x, caches


# ---------------------------------------------------------------------------
# decode: one token, caches carried
# ---------------------------------------------------------------------------
def forward_decode(layers, x, caches, pos, cfg):
    """x: (B,1,d).  Each layer writes the token's cache row into its slice
    of ``caches`` in place (where ``pos`` is inside them); returns
    (hidden, caches)."""
    for i, lp in enumerate(layers):
        x, _ = attn_block_decode(lp, x, {n: c[i] for n, c in caches.items()},
                                 pos, cfg)
    return x, caches
