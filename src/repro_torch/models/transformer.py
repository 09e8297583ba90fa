"""Layer stacks of the port's LMs, the counterpart of
``repro.models.transformer``: the attention families (``dense``, ``vlm``,
``audio``, ``moe``), Mamba-1 stacks (``ssm``) and Mamba-2 stacks with a
shared attention + MLP block (``hybrid``, zamba2).

The reference scans a parameter pytree stacked on a leading layer axis,
one stack per run of identical layer kinds (``stack_groups``); here the
layers are one ``nn.ModuleList`` walked in order, and the reference's
``lax.cond`` on the hybrid's apply flag is a branch on the layer index.
Caches keep the reference's layout (``cache_shapes``): ``{"k", "v"}`` of
shape (L, B, S, KV, hd) for GQA, ``{"c_kv": (L, B, S, kvr), "k_rope":
(L, B, S, dr)}`` for MLA, ``{"ssm": (conv, h)}`` for Mamba stacks, and
for ``hybrid`` also the shared block's ``{"k", "v"}`` of shape
(n_slots, B, S, KV, hd), one slot per application.

``forward_train`` is the training forward of every family; each layer's
body runs under ``_maybe_remat`` (``cfg.remat``: ``torch.utils.checkpoint``
of the whole body for ``"full"``, or recomputing all but the matmuls'
outputs for ``"dots"``).  The multi-token-prediction head (``init_mtp``) is
built only for training: only the loss reads it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


# ---------------------------------------------------------------------------
# per-layer init / fwd
# ---------------------------------------------------------------------------
def init_layer(cfg, generator, kind: str, experts=None) -> nn.ModuleDict:
    """kind: dense | moe | moe_dense (MLA or GQA attention, then the
    experts, a dense FFN of width ``dense_d_ff``, or the dense FFN) | ssm |
    hybrid (a norm, then Mamba-1 or Mamba-2).  ``experts``: the range of
    routed experts a MoE layer keeps (all by default)."""
    dev = generator.device
    if kind in ("ssm", "hybrid"):
        init = SSM.init_mamba1 if kind == "ssm" else SSM.init_mamba2
        return nn.ModuleDict({"ln": L.init_norm(cfg, dev),
                              "ssm": init(cfg, generator)})
    p = {"ln_attn": L.init_norm(cfg, dev)}
    if cfg.attn_type == "mla":
        p["attn"] = L.init_mla(cfg, generator)
    else:
        p["attn"] = L.init_attention(cfg, generator)
    if not cfg.parallel_block:
        p["ln_mlp"] = L.init_norm(cfg, dev)
    if kind == "moe":
        p["moe"] = MOE.init_moe(cfg, generator, experts)
    elif kind == "moe_dense":
        p["mlp"] = L.init_mlp(cfg, generator, cfg.dense_d_ff)
    else:
        p["mlp"] = L.init_mlp(cfg, generator)
    return nn.ModuleDict(p)


def init_shared_block(cfg, generator) -> nn.ModuleDict:
    """zamba2's shared attention + MLP block."""
    dev = generator.device
    return nn.ModuleDict({"ln_attn": L.init_norm(cfg, dev),
                          "attn": L.init_attention(cfg, generator),
                          "ln_mlp": L.init_norm(cfg, dev),
                          "mlp": L.init_mlp(cfg, generator)})


def _mlp_width(cfg) -> int:
    """The width of a layer's dense MLP: ``dense_d_ff`` in a MoE model's
    dense layers, else ``d_ff``."""
    return cfg.dense_d_ff if cfg.family == "moe" else cfg.d_ff


def attn_block_fwd(p, x, cfg, positions, *, causal, return_kv=False,
                   mcx=None):
    """As the reference: a parallel block returns y (and kv); otherwise
    (y, aux) (or (y, aux, kv)), aux the MoE's load-balancing loss or 0.
    ``mcx``: the rank's mesh context, or None on one device."""
    h = L.apply_norm(p["ln_attn"], x, cfg)
    if cfg.attn_type == "mla":
        out = L.mla_fwd(p["attn"], h, cfg, positions=positions,
                        return_kv=return_kv, mcx=mcx)
    else:
        out = L.attention_fwd(p["attn"], h, cfg, positions=positions,
                              causal=causal, return_kv=return_kv, mcx=mcx)
    attn_y, kv = out if return_kv else (out, None)
    if cfg.parallel_block:
        # cohere-style: one shared input norm, attn + mlp in parallel
        y = x + attn_y + L.apply_mlp(p["mlp"], h, cfg, mcx, _mlp_width(cfg))
        return (y, kv) if return_kv else y
    x = x + attn_y
    h2 = L.apply_norm(p["ln_mlp"], x, cfg)
    if "moe" in p:
        mlp_y, aux = MOE.moe_fwd(p["moe"], h2, cfg, mcx)
    else:
        mlp_y, aux = L.apply_mlp(p["mlp"], h2, cfg, mcx, _mlp_width(cfg)), 0.0
    y = x + mlp_y
    return (y, aux, kv) if return_kv else (y, aux)


def attn_block_decode(p, x, cache, pos, cfg, mcx=None):
    h = L.apply_norm(p["ln_attn"], x, cfg)
    if cfg.attn_type == "mla":
        attn_y, cache = L.mla_decode_attention(p["attn"], h, cache, pos, cfg,
                                               mcx)
    else:
        attn_y, cache = L.gqa_decode_attention(p["attn"], h, cache, pos, cfg,
                                               mcx)
    if cfg.parallel_block:
        return x + attn_y + L.apply_mlp(p["mlp"], h, cfg, mcx,
                                        _mlp_width(cfg)), cache
    x = x + attn_y
    h2 = L.apply_norm(p["ln_mlp"], x, cfg)
    if "moe" in p:
        mlp_y, _ = MOE.moe_fwd(p["moe"], h2, cfg, mcx)
    else:
        mlp_y = L.apply_mlp(p["mlp"], h2, cfg, mcx, _mlp_width(cfg))
    return x + mlp_y, cache


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _layer_kinds(cfg):
    if cfg.family in ("dense", "vlm", "audio"):
        return ["dense"] * cfg.num_layers
    if cfg.family == "moe":
        return (["moe_dense"] * cfg.num_dense_layers
                + ["moe"] * (cfg.num_layers - cfg.num_dense_layers))
    if cfg.family in ("ssm", "hybrid"):
        return [cfg.family] * cfg.num_layers
    raise ValueError(cfg.family)


def hybrid_attn_slots(cfg):
    """Layer indices after which the shared block applies; the i-th is
    the shared block's cache slot i."""
    return [i for i in range(cfg.num_layers)
            if (i + 1) % cfg.hybrid_attn_every == 0]


def stack_groups(cfg):
    """(kind, lo, hi) runs of identical layer kinds: the reference's
    stacks, each a scanned group of ``init_stack``'s ``"stacks"``."""
    kinds = _layer_kinds(cfg)
    groups, start = [], 0
    for i in range(1, len(kinds) + 1):
        if i == len(kinds) or kinds[i] != kinds[start]:
            groups.append((kinds[start], start, i))
            start = i
    return groups


class MTPHead(nn.Module):
    """deepseek's multi-token-prediction head: the final-normed hidden
    state and the next token's embedding, each normed (``ln_h``,
    ``ln_e``), concatenated and projected (``proj`` (2d, d)), then one more
    layer (``layer``: MoE in a MoE model, else dense)."""

    def __init__(self, cfg, generator, experts=None):
        super().__init__()
        dt, dev = L.torch_dtype(cfg.dtype), generator.device
        self.proj = L.param(L.normal((2 * cfg.d_model, cfg.d_model),
                                     generator, dt))
        self.ln_h = L.init_norm(cfg, dev)
        self.ln_e = L.init_norm(cfg, dev)
        self.layer = init_layer(cfg, generator,
                                "moe" if cfg.family == "moe" else "dense",
                                experts)

    def items(self):
        """(name, part) pairs, as a ``ModuleDict`` gives them."""
        return [(k, getattr(self, k)) for k in ("proj", "ln_h", "ln_e",
                                                "layer")]

    def __getitem__(self, key):
        return getattr(self, key)


def _kept(module: nn.Module, prefix: str, keep) -> nn.Module:
    """``module`` with each weight replaced by ``keep(name, weight)``."""
    for name, w in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                L.param(keep(f"{prefix}.{name}", w.data)))
    return module


def init_stack(cfg, generator, mtp: bool = False, keep=None,
               experts=None) -> dict:
    """Random parameters on the generator's device: the embedding (vocab
    padded to a multiple of 256, Megatron-style), the unembedding unless
    tied, the final norm and the layers; with ``mtp`` and a config that
    has ``mtp_depth``, also the MTP head, drawn after every other weight
    so that those are the same with or without it.

    Every weight is drawn whole, in one order, so the draws do not depend
    on a mesh.  ``keep(name, weight)`` (a state-dict name) gives what the
    model holds of each, applied to each weight as it is drawn and to each
    layer once drawn; ``experts`` is the range of routed experts a MoE
    layer keeps, each drawn and then kept or dropped."""
    kept = keep or (lambda name, t: t)
    dt, dev = L.torch_dtype(cfg.dtype), generator.device
    V = L.pad_to(cfg.vocab_size, 256)
    params = {"emb": L.param(kept("emb", L.normal((V, cfg.d_model),
                                                  generator, dt)))}
    if not cfg.tie_embeddings:
        params["unemb"] = L.param(kept("unemb", L.normal((cfg.d_model, V),
                                                         generator, dt)))
    params["ln_final"] = L.init_norm(cfg, dev)
    kinds = [kind for kind, lo, hi in stack_groups(cfg)
             for _ in range(lo, hi)]
    layers = []
    for i, kind in enumerate(kinds):
        layer = init_layer(cfg, generator, kind, experts)
        layers.append(layer if keep is None
                      else _kept(layer, f"layers.{i}", keep))
    params["layers"] = nn.ModuleList(layers)
    if cfg.family == "hybrid":
        shared = init_shared_block(cfg, generator)
        params["shared"] = shared if keep is None \
            else _kept(shared, "shared", keep)
    if mtp and cfg.mtp_depth:
        head = MTPHead(cfg, generator, experts)
        params["mtp"] = head if keep is None else _kept(head, "mtp", keep)
    return params


# ---------------------------------------------------------------------------
# training / encoder forward
# ---------------------------------------------------------------------------
def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dimensions, the ones the
    reference's "dots" policy (``dots_with_no_batch_dims_saveable``)
    keeps: ``mm`` / ``addmm``, and ``bmm`` over a batch of one, which is
    how ``torch.einsum`` runs a projection such as "bsd,de->bse"."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(f, cfg):
    """``f`` as the reference's ``jax.checkpoint`` of a layer body would
    run it: as it is (``"none"``), saving only its inputs and recomputing
    the rest in the backward (``"full"``), or saving the outputs of its
    matmuls without batch dimensions and recomputing the rest
    (``"dots"``)."""
    if cfg.remat == "none":
        return f
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(f, *args, use_reentrant=False, **kw)


def forward_train(layers, x, cfg, positions, shared=None, mcx=None,
                  view=None):
    """x: hidden after embedding (B,S,d).  Returns (hidden, aux): aux the
    sum of the MoE layers' load-balancing losses (0.0 without MoE).  The
    hybrid's shared block runs after each layer of ``hybrid_attn_slots``
    (a branch on the layer index where the reference has ``lax.cond``);
    autograd adds its gradient over every use.  On a mesh (``mcx``) each
    layer runs the rank's part; ``view(module, prefix)`` gives a layer's
    weights as the layer functions read them (FSDP's gathered shards),
    called inside the layer's body so that a remat recompute gathers
    again."""
    causal = not cfg.is_encoder
    aux_total = 0.0
    see = view or (lambda module, prefix: module)
    if cfg.family in ("ssm", "hybrid"):
        slots = _slot_of(cfg)
        for i, lp in enumerate(layers):
            def body(h, lp=lp, i=i, attend=i in slots):
                lv = see(lp, f"layers.{i}")
                hn = L.apply_norm(lv["ln"], h, cfg)
                if cfg.family == "ssm":
                    h = h + SSM.mamba1_fwd(lv["ssm"], hn, cfg, mcx=mcx)
                else:
                    h = h + SSM.mamba2_fwd(lv["ssm"], hn, cfg)
                if attend:
                    h, _ = attn_block_fwd(see(shared, "shared"), h, cfg,
                                          positions, causal=causal, mcx=mcx)
                return h
            x = _maybe_remat(body, cfg)(x)
        return x, aux_total
    for i, lp in enumerate(layers):
        def body(h, lp=lp, i=i):
            out = attn_block_fwd(see(lp, f"layers.{i}"), h, cfg, positions,
                                 causal=causal, mcx=mcx)
            return (out, 0.0) if cfg.parallel_block else out
        x, da = _maybe_remat(body, cfg)(x)
        aux_total = aux_total + da
    return x, aux_total


# ---------------------------------------------------------------------------
# prefill: forward + emit caches
# ---------------------------------------------------------------------------
def cache_shapes(cfg, B: int, S: int, tp: int = 1) -> dict:
    """The shape of each cache of ``cfg`` for B sequences of S positions
    (the reference's ``Model.cache_specs``): a tuple of shapes for the
    ``"ssm"`` states (conv in the config's dtype, h in float32).  ``tp``:
    a rank's share of Mamba-1's channels where tp divides ``d_inner``."""
    n = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        K = cfg.ssm_conv
        if cfg.family == "ssm":
            di = cfg.d_inner // tp if cfg.d_inner % tp == 0 else cfg.d_inner
            conv = (n, B, K - 1, di)
            h = (n, B, di, cfg.ssm_state)
            return {"ssm": (conv, h)}
        conv = (n, B, K - 1, cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state)
        h = (n, B, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
        kv = (len(hybrid_attn_slots(cfg)), B, S, cfg.num_kv_heads,
              cfg.head_dim)
        return {"ssm": (conv, h), "k": kv, "v": kv}
    if cfg.attn_type == "mla":
        return {"c_kv": (n, B, S, cfg.kv_lora_rank),
                "k_rope": (n, B, S, cfg.qk_rope_dim)}
    shape = (n, B, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


def _empty_caches(x, cfg, B, S, tp=1) -> dict:
    """Caches of ``cache_shapes`` on x's device, in x's dtype (the SSM
    states h in float32)."""
    out = {}
    for name, shape in cache_shapes(cfg, B, S, tp).items():
        if name == "ssm":
            conv, h = shape
            out[name] = (x.new_empty(conv),
                         x.new_empty(h, dtype=torch.float32))
        else:
            out[name] = x.new_empty(shape)
    return out


def _slot_of(cfg) -> dict:
    """{layer index: its shared-block cache slot}; empty but for
    ``hybrid``."""
    if cfg.family != "hybrid":
        return {}
    return {li: si for si, li in enumerate(hybrid_attn_slots(cfg))}


def _to_seq_split(name, rows, cfg, mcx):
    """One layer's cache rows from prefill (the K/V heads the rank
    computed, or the MLA latent whole) as the rank's sequence chunk with
    every K/V head: one all-to-all where the rank computed its K/V heads
    only, else its chunk cut out."""
    head_dim = 2 if name in ("k", "v") and L.splits(cfg.num_kv_heads,
                                                    mcx) else None
    return L.seq_split(rows, mcx, head_dim)


def forward_prefill(layers, x, cfg, positions, shared=None, mcx=None):
    """x: (B,S,d) after embedding; ``shared`` is the hybrid's shared block.
    Returns (hidden, caches), the K/V caches exactly as long as the prompt,
    as on the reference.  On a mesh (``mcx``) the attention caches (the
    hybrid's shared block's too) are the rank's chunk of the sequence,
    ceil(S / tp) positions (zero past S), handed over from the head split
    layer by layer; Mamba-1's states are the rank's channels, Mamba-2's
    whole."""
    B, S = x.shape[:2]
    tp = L.tp_of(mcx)
    S_loc = -(-S // tp)
    caches = _empty_caches(x, cfg, B, S_loc, tp)
    if cfg.family in ("ssm", "hybrid"):
        conv, h = caches["ssm"]
        slots = _slot_of(cfg)
        for i, lp in enumerate(layers):
            hn = L.apply_norm(lp["ln"], x, cfg)
            zero = (conv.new_zeros(conv.shape[1:]), h.new_zeros(h.shape[1:]))
            if cfg.family == "ssm":
                y, (conv[i], h[i]) = SSM.mamba1_fwd(lp["ssm"], hn, cfg,
                                                    state=zero, mcx=mcx)
            else:
                y, (conv[i], h[i]) = SSM.mamba2_fwd(lp["ssm"], hn, cfg,
                                                    state=zero)
            x = x + y
            if i in slots:
                x, _, kv = attn_block_fwd(shared, x, cfg, positions,
                                          causal=True, return_kv=True,
                                          mcx=mcx)
                for name, c in zip(("k", "v"), kv):
                    caches[name][slots[i]] = c if mcx is None else \
                        _to_seq_split(name, c, cfg, mcx)
        return x, caches
    for i, lp in enumerate(layers):
        out = attn_block_fwd(lp, x, cfg, positions, causal=not cfg.is_encoder,
                             return_kv=True, mcx=mcx)
        x, kv = out[0], out[-1]
        for name, c in zip(caches, kv):
            caches[name][i] = c if mcx is None else \
                _to_seq_split(name, c, cfg, mcx)
    return x, caches


# ---------------------------------------------------------------------------
# decode: one token, caches carried
# ---------------------------------------------------------------------------
def forward_decode(layers, x, caches, pos, cfg, shared=None, mcx=None):
    """x: (B,1,d).  Each layer writes its new state, or the token's cache
    row (where ``pos`` is inside the caches; on a mesh, inside the rank's
    chunk), into its slice of ``caches`` in place; returns (hidden,
    caches)."""
    if cfg.family in ("ssm", "hybrid"):
        conv, h = caches["ssm"]
        slots = _slot_of(cfg)
        for i, lp in enumerate(layers):
            hn = L.apply_norm(lp["ln"], x[:, 0], cfg)
            if cfg.family == "ssm":
                y, (conv[i], h[i]) = SSM.mamba1_step(
                    lp["ssm"], hn, cfg, (conv[i], h[i]), mcx)
            else:
                y, (conv[i], h[i]) = SSM.mamba2_step(lp["ssm"], hn, cfg,
                                                     (conv[i], h[i]))
            x = x + y[:, None]
            if i in slots:
                si = slots[i]
                x, _ = attn_block_decode(shared, x, {"k": caches["k"][si],
                                                     "v": caches["v"][si]},
                                         pos, cfg, mcx)
        return x, caches
    for i, lp in enumerate(layers):
        x, _ = attn_block_decode(lp, x, {n: c[i] for n, c in caches.items()},
                                 pos, cfg, mcx)
    return x, caches
