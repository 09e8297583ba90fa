"""Model facade of the port: the serving and training steps of
``repro.models.model`` for every family it ships (dense, MoE and MLA
decoders, encoders, Mamba-1 and zamba2's Mamba-2 hybrid), as an
``nn.Module``.

``build(cfg, device=None)`` returns a ``Model`` whose ``prefill_step(batch)``
and ``decode_step(caches, token, pos)`` keep the reference's names, inputs
and outputs, so one test can drive both.  Weights are drawn from an
explicit ``torch.Generator`` on the model's device, or carried over from
the reference's parameter pytree with ``params_from_reference``.  Serving
runs under ``torch.inference_mode()``.

``build(..., training=True)`` makes the weights trainable and adds the
multi-token-prediction head where the config has one (only the loss reads
it; at deepseek's full width it is one more MoE layer of about 11.5 B
parameters, so a serving model holds none).  Then ``loss_fn(batch)`` and
``train_step(opt_state, batch, step)`` run the reference's loss (chunked
cross-entropy, the MTP term, the MoE aux) and its step (microbatches
accumulated in float32, AdamW from ``train/optimizer.py``); the weights
are updated in place.

On a mesh (``build(..., mesh=ctx)``, a rank's ``MeshCtx``) a model built
for training trains the rank's part, with the reference's arithmetic:
every rank is given the whole batch and takes its rows (``bspec``); the
cross-entropy is vocab-parallel (``ce_loss``); the loss's denominators
are summed over "data", so each rank's loss is its share of the global
one, and the gradients are summed over "data" into each rank's ZeRO-1
shard (``train/optimizer.py``'s ``zero1_spec``), on which AdamW runs
before the new weights are gathered back.  With ``cfg.fsdp`` every weight
of two or more dims is also held as its shard over "data"
(``param_spec``), gathered where a layer reads it.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.relation import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT


def embed(tokens, table, mcx=None):
    """tokens (B,S) ints; table (V,d) -> (B,S,d).  With ``mcx`` the table
    is the rank's rows of a vocabulary split over "model": a masked local
    gather, then an all-reduce (the reference's vocab-parallel gather);
    without, a plain gather of a whole table."""
    if mcx is None:
        return table[tokens]
    V_loc = table.shape[0]
    idx = tokens - mcx.model_index * V_loc
    ok = (idx >= 0) & (idx < V_loc)
    x = torch.where(ok[..., None], table[idx.clamp(0, V_loc - 1)], 0)
    return mcx.all_reduce(x)


def logits_fn(h, unemb_t, cfg, mcx=None):
    """Full logits for the last position (h: (B,1,d)) -> (B,V) float32,
    padded vocabulary rows at -1e30.  With ``mcx`` unemb_t is the rank's
    vocabulary rows: their logits, gathered along the vocabulary over
    "model"."""
    logits = torch.einsum("bsd,vd->bsv", h.float(), unemb_t.float())
    if mcx is not None:
        logits = mcx.all_gather(logits, 2)
    pad = torch.arange(logits.shape[2], device=h.device) >= cfg.vocab_size
    return torch.where(pad, -1e30, logits[:, 0])


def _unemb_t(params, cfg):
    """Vocab-major unembedding matrix (V, d)."""
    if cfg.tie_embeddings:
        return params["emb"]
    return params["unemb"].T


def _ce_chunk_vocab_split(hb, unemb_t, tb, mb, vocab_size: int, mcx):
    """``_ce_chunk`` where unemb_t is the rank's rows of a vocabulary split
    over "model": the float32 logits of its rows; the row max (carrying no
    gradient: the log-sum-exp's does not depend on it) and the sum of
    exponentials all-reduced over "model", max then sum; the label's logit
    taken by the rank that owns its row and summed over "model"."""
    logits = torch.einsum("bcd,vd->bcv", hb.float(), unemb_t.float())
    V_loc = unemb_t.shape[0]
    lo = mcx.model_index * V_loc
    pad = lo + torch.arange(V_loc, device=hb.device) >= vocab_size
    logits = torch.where(pad, -1e30, logits)
    m = mcx.all_reduce(logits.detach().amax(-1, keepdim=True), op="max")
    lse = torch.log(mcx.all_reduce(torch.exp(logits - m).sum(-1))) + m[..., 0]
    idx = tb - lo
    own = (idx >= 0) & (idx < V_loc)
    lab = logits.gather(-1, idx.clamp(0, V_loc - 1)[..., None])[..., 0]
    lab = mcx.all_reduce(torch.where(own, lab, 0.0))
    return ((lse - lab) * mb).sum()


def _ce_chunk(hb, unemb_t, tb, mb, vocab_size: int):
    """Summed masked cross-entropy of one chunk: float32 logits (B,c,V),
    padded vocabulary rows at -1e30."""
    logits = torch.einsum("bcd,vd->bcv", hb.float(), unemb_t.float())
    pad = torch.arange(unemb_t.shape[0], device=hb.device) >= vocab_size
    logits = torch.where(pad, -1e30, logits)
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    lab = logits.gather(-1, tb[..., None])[..., 0]
    return ((lse - lab) * mb).sum()


def ce_loss(h, unemb_t, targets, mask, cfg, mcx=None):
    """h: (B,S,d) final-normed; unemb_t: (V,d) [vocab-major]; targets
    (B,S).  Returns (sum_loss, sum_mask).  The sequence goes in chunks of
    ``loss_chunk`` (zero-padded), summed in order as the reference's scan
    does; under autograd each chunk is checkpointed, so its (B,c,V)
    logits are recomputed in the backward and the whole (B,S,V) never
    exists.  With ``mcx`` unemb_t is the rank's vocabulary rows
    (``_ce_chunk_vocab_split``): a rank never holds more than (B,c,V/tp)
    logits, and the sums are the rank's rows' (its batch rows)."""
    B, S, _ = h.shape
    c = min(cfg.loss_chunk, S)
    pad = -S % c
    if pad:
        h = torch.cat([h, h.new_zeros((B, pad, h.shape[2]))], 1)
        targets = torch.cat([targets, targets.new_zeros((B, pad))], 1)
        mask = torch.cat([mask, mask.new_zeros((B, pad))], 1)
    targets = targets.long()
    total = torch.zeros((), device=h.device)
    fn = _ce_chunk
    if mcx is not None:
        fn = functools.partial(_ce_chunk_vocab_split, mcx=mcx)
        h = mcx.fan_out(h)
    for i in range(0, S + pad, c):
        args = (h[:, i:i + c], unemb_t, targets[:, i:i + c],
                mask[:, i:i + c], cfg.vocab_size)
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, *args, use_reentrant=False)
        else:
            total = total + fn(*args)
    return total, mask.sum()


def _batch_rows(batch) -> int:
    return len(batch["tokens"] if "tokens" in batch else batch["embeddings"])


class Model(nn.Module):
    """A decoder (or encoder) LM on one device, or one rank's part of it on
    a mesh (``mesh``, a ``MeshCtx``): the rank's slice of every weight
    (``split_dim``), its rows of each batch and its chunk of each cache's
    sequence."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False, mesh=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device != dev:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        self.mcx = mesh
        self.opt_cfg = OPT.OptConfig(grad_compress=cfg.grad_compress)
        self.for_training = training
        # each weight's spec: the axis each of its dims is split over
        # ("model", "data" or None), over its whole shape (``param_spec``)
        self.specs = {}
        keep = experts = None
        if mesh is not None and (mesh.tp_size > 1 or _fsdp(cfg, mesh,
                                                           training)):
            if mesh.tp_size > 1 and cfg.num_experts and \
                    L.splits(cfg.num_experts, mesh):
                n = cfg.num_experts // mesh.tp_size
                experts = range(mesh.model_index * n,
                                (mesh.model_index + 1) * n)

            def keep(name, t):
                shape = tuple(t.shape)
                if experts is not None and _routed_expert(name):
                    # drawn as the rank's experts only
                    shape = (cfg.num_experts,) + shape[1:]
                spec = param_spec(name, shape, cfg, mesh, training)
                self.specs[name] = spec
                if experts is not None and _routed_expert(name):
                    return local_leaf(name, t, spec, cfg, mesh,
                                      model_done=True)
                return local_leaf(name, t, spec, cfg, mesh)
        params = T.init_stack(cfg, generator, mtp=training, keep=keep,
                              experts=experts)
        self.emb = params["emb"]
        if "unemb" in params:
            self.unemb = params["unemb"]
        self.ln_final = params["ln_final"]
        self.layers = params["layers"]
        self.shared = params.get("shared")
        self.mtp = params.get("mtp")
        for name, w in self.named_parameters():
            self.specs.setdefault(name, (None,) * w.dim())
        self._fsdp = any("data" in sp for sp in self.specs.values())
        if training:
            self.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    @property
    def _vocab_mcx(self):
        """The mesh context where the vocabulary is split over "model"
        (tp > 1 divides the padded vocabulary), else None (a whole
        table)."""
        V = L.pad_to(self.cfg.vocab_size, 256)
        return self.mcx if L.tp_of(self.mcx) > 1 and L.splits(V, self.mcx) \
            else None

    def _rows(self, x, mcx):
        """The rank's rows of a batch-like input (all without a mesh)."""
        x = torch.as_tensor(x, device=self.device)
        return x if mcx is None else x[mcx.batch_rows(x.shape[0])]

    def _embed_inputs(self, batch, mcx=None, emb=None):
        """The rank's rows of the batch embedded (by ``emb``, the table as
        the rank reads it: ``self.emb`` by default)."""
        if self.cfg.input_mode == "embeddings":
            x = self._rows(batch["embeddings"], mcx)
            return x.to(L.torch_dtype(self.cfg.dtype))
        return embed(self._rows(batch["tokens"], mcx),
                     self.emb if emb is None else emb, self._vocab_mcx)

    def _logits(self, h):
        h = L.apply_norm(self.ln_final, h, self.cfg)
        top = dict(self.named_parameters(recurse=False))
        return logits_fn(h, _unemb_t(top, self.cfg), self.cfg,
                         self._vocab_mcx)

    def _mesh_for(self, n: int):
        """The mesh context for a batch of ``n`` rows (None without a
        mesh)."""
        return None if self.mcx is None else self.mcx.for_batch(n)

    def _tokens(self, logits, mcx):
        """Greedy tokens of the rank's rows, gathered over "data" where the
        batch is split there: every rank returns the whole batch's."""
        tok = logits.argmax(-1).to(torch.int32)
        if mcx is not None and mcx.batch_split and mcx.dp_size > 1:
            tok = mcx.all_gather(tok, 0, axis="data")
        return tok

    # ---------------- prefill / decode -------------------------------------
    @torch.inference_mode()
    def prefill(self, batch):
        """(logits of the last position (B,V) float32, caches).  On a mesh
        the batch is the whole one; the logits and caches are the rank's
        rows (and its chunk of each cache's sequence)."""
        mcx = self._mesh_for(_batch_rows(batch))
        x = self._embed_inputs(batch, mcx)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        h, caches = T.forward_prefill(self.layers, x, self.cfg, positions,
                                      self.shared, mcx)
        return self._logits(h[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, caches, token, pos):
        """(logits (B,V) float32, caches) for one token at ``pos``; the
        caches (K/V rows, SSM states) are updated in place and returned.
        On a mesh ``token`` is the whole batch's and the logits the rank's
        rows."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        mcx = self._mesh_for(len(token))
        if cfg.input_mode == "embeddings":
            x = self._rows(token, mcx).to(L.torch_dtype(cfg.dtype))
        else:
            x = embed(self._rows(token, mcx)[:, None], self.emb,
                      self._vocab_mcx)
        h, caches = T.forward_decode(self.layers, x, caches, int(pos), cfg,
                                     self.shared, mcx)
        return self._logits(h), caches

    def prefill_step(self, batch):
        """batch {"tokens": (B,S)} or {"embeddings": (B,S,d)} -> (next
        token (B,) int32, caches of the prompt's length)."""
        logits, caches = self.prefill(batch)
        return self._tokens(logits, self._mesh_for(_batch_rows(batch))), \
            caches

    def decode_step(self, caches, token, pos):
        """token: (B,) ints (or (B,1,d) embeddings); pos: int."""
        logits, caches = self.decode(caches, token, pos)
        return self._tokens(logits, self._mesh_for(len(token))), caches

    # ---------------- training ------------------------------------------------
    def _view(self, module, prefix: str):
        """``module``'s weights as the layer functions read them: the
        module itself, or with FSDP nested dicts whose shards over "data"
        are gathered (each gather's gradient is reduce-scattered)."""
        if not self._fsdp:
            return module
        out = {}
        for k, v in module.items():
            name = f"{prefix}.{k}"
            out[k] = self._weight(name, v) if isinstance(v, nn.Parameter) \
                else self._view(v, name)
        return out

    def _weight(self, name: str, w):
        """The weight ``name`` whole over "data" (FSDP's gather)."""
        for dim, axis in enumerate(self.specs[name]):
            if axis == "data":
                w = self.mcx.all_gather(w, dim, "data")
        return w

    def loss_fn(self, batch):
        """(loss, {"ce": ce}) of ``batch`` ({"tokens" or "embeddings",
        "labels", optional "mask"}): the masked mean cross-entropy, plus
        0.3 times the MTP head's (predicting the token after the label)
        where the model holds one, plus the MoE load-balancing aux.

        On a mesh ``batch`` is the whole batch and the rank reads its rows;
        the loss and ``ce`` are the global ones, and the loss's gradient
        is that of the rank's share: its rows' masked sums over the
        global mask sums (all-reduced over "data"), plus the aux (global
        already), so that the shares' gradients summed over "data" are
        the loss's."""
        cfg = self.cfg
        mcx = None
        if self.mcx is not None:
            n = _batch_rows(batch)
            if self.mcx.bspec(n) is None:
                raise ValueError(f"a batch of {n} rows does not split over "
                                 f"{self.mcx.dp_size} data ranks")
            mcx = self.mcx.for_batch(n)
        vocab = self._vocab_mcx
        emb = self._weight("emb", self.emb)
        x = self._embed_inputs(batch, mcx, emb)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        h, aux = T.forward_train(self.layers, x, cfg, positions, self.shared,
                                 mcx, self._view)
        ln_final = self._view(self.ln_final, "ln_final")
        h = L.apply_norm(ln_final, h, cfg)
        unemb_t = emb if cfg.tie_embeddings else \
            self._weight("unemb", self.unemb).T
        labels = self._rows(batch["labels"], mcx)
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, device=self.device) if mask is None
                else self._rows(mask, mcx))

        def denominator(d):
            return d if mcx is None else mcx.all_reduce(d, "data")
        total, denom = ce_loss(h, unemb_t, labels, mask, cfg, vocab)
        ce = total / denominator(denom).clamp_min(1.0)
        loss = ce
        if cfg.mtp_depth and self.mtp is not None \
                and cfg.input_mode == "tokens":
            # multi-token prediction: predict t+2 from [h_t ; emb(label_t)]
            mp = self._view(self.mtp, "mtp")
            hcat = torch.cat([L.apply_norm(mp["ln_h"], h, cfg),
                              L.apply_norm(mp["ln_e"],
                                           embed(labels, emb, vocab), cfg)],
                             dim=-1)
            h2 = torch.einsum("bsd,de->bse", hcat, mp["proj"])
            y = T.attn_block_fwd(mp["layer"], h2, cfg, positions,
                                 causal=True, mcx=mcx)
            y = y[0] if isinstance(y, tuple) else y
            mask2 = mask.clone()
            mask2[:, -1] = 0.0
            t2, d2 = ce_loss(L.apply_norm(ln_final, y, cfg), unemb_t,
                             torch.roll(labels, -1, dims=1), mask2, cfg,
                             vocab)
            loss = loss + 0.3 * t2 / denominator(d2).clamp_min(1.0)
        if mcx is not None and mcx.dp_size > 1:
            # the value is the global loss; the gradient the share's
            share = loss.detach()
            loss = loss + (mcx.all_reduce(share, "data") - share)
            ce = mcx.all_reduce(ce.detach(), "data")
        return loss + aux, {"ce": ce}

    def _grads(self, params, batch):
        """(loss, metrics, gradients of the loss in the weights' dtypes);
        a weight the loss does not read gets zeros, as under
        ``jax.value_and_grad``."""
        loss, met = self.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in met.items()},
                dict(zip(params, grads)))

    # ---------------- the mesh's layout of weights and optimizer state ------
    def param_specs(self) -> dict:
        """{name: spec} of every weight (``param_spec``: the axis each dim
        is split over)."""
        return dict(self.specs)

    def param_shapes(self) -> dict:
        """{name: whole shape} of every weight (padded query heads
        included)."""
        out = {}
        for name, w in self.named_parameters():
            shape = list(w.shape)
            for dim, axis in enumerate(self.specs[name]):
                if axis is not None:
                    shape[dim] *= self.mcx.axis_size(axis)
            out[name] = tuple(shape)
        return out

    def _state_layout(self):
        """The optimizer's layout on the mesh (``OPT.ZeroLayout``), or None
        without a mesh."""
        if self.mcx is None:
            return None
        specs = OPT.opt_state_shardings(self.param_specs(),
                                        self.param_shapes(), self.mcx,
                                        self.opt_cfg)["master"]
        return OPT.ZeroLayout(self.mcx, self.param_specs(), specs)

    def init_opt_state(self) -> dict:
        """The optimizer state of this model's weights: on a mesh each
        leaf the rank's ZeRO-1 shard."""
        return OPT.init_opt_state(dict(self.named_parameters()),
                                  self.opt_cfg, self._state_layout())

    def global_weights(self) -> dict:
        """{name: the whole weight} (every rank must call it)."""
        return {n: w.detach() if self.mcx is None else
                global_leaf(n, w, self.specs[n], self.cfg, self.mcx)
                for n, w in self.named_parameters()}

    def global_state(self, opt_state) -> dict:
        """The optimizer state with each leaf whole (every rank must call
        it)."""
        lay = self._state_layout()
        if lay is None:
            return opt_state
        return {part: {n: global_leaf(n, t, lay.state_specs[n], self.cfg,
                                      self.mcx)
                       for n, t in leaves.items()}
                for part, leaves in opt_state.items()}

    def local_weights(self, whole: dict) -> dict:
        """The rank's parts of whole weights (``global_weights``'s
        inverse)."""
        if self.mcx is None:
            return whole
        return {n: local_leaf(n, t, self.specs[n], self.cfg, self.mcx)
                for n, t in whole.items()}

    def local_state(self, whole: dict) -> dict:
        """The rank's shards of a whole optimizer state (a checkpoint's,
        saved on any mesh)."""
        lay = self._state_layout()
        if lay is None:
            return whole
        return {part: {n: local_leaf(n, t, lay.state_specs[n], self.cfg,
                                     self.mcx)
                       for n, t in leaves.items()}
                for part, leaves in whole.items()}

    def train_step(self, opt_state, batch, step: int):
        """One optimizer step on ``batch``; the weights are updated in
        place.  With ``cfg.microbatches`` M > 1 the batch is cut into M
        equal parts whose gradients accumulate in float32 and are divided
        by M (the reported ``ce`` is then the mean loss, as on the
        reference).  Returns (opt_state, {"loss", "ce", "grad_norm",
        "lr"}).

        On a mesh every rank is given the whole batch, and each
        microbatch's rows split over "data".  The accumulated gradients
        are reduce-scattered over "data" once, after the last microbatch,
        into the rank's ZeRO-1 shard (the reference reduce-scatters each
        microbatch's: the same sums in another order); an FSDP shard's
        gradient is reduce-scattered by its gather's backward."""
        if not self.for_training:
            raise ValueError("a serving Model: build(cfg, ..., "
                             "training=True) to train")
        params = dict(self.named_parameters())
        M = self.cfg.microbatches
        n_rows = len(batch["labels"])
        if n_rows % M:
            raise ValueError(f"a batch of {n_rows} rows does not split into "
                             f"{M} microbatches")
        if M == 1:
            loss, met, grads = self._grads(params, batch)
        else:
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            loss = 0.0
            rows = n_rows // M
            for i in range(M):
                mb = {k: v[i * rows:(i + 1) * rows]
                      for k, v in batch.items()}
                l, _, g = self._grads(params, mb)
                for n, gi in g.items():
                    grads[n] += gi.float()
                del g
                loss = loss + l
            for g in grads.values():
                g.div_(M)
            loss = loss / M
            met = {"ce": loss}
        lay = self._state_layout()
        if lay is not None:
            for n in grads:     # each whole gradient freed once reduced
                grads[n] = lay.reduce_grad(n, grads[n])
        _, opt_state, stats = OPT.apply_updates(grads, opt_state, params,
                                                step, self.opt_cfg, lay)
        return opt_state, {"loss": loss, **met, **stats}


def pad_caches(caches, length: int, mesh=None):
    """Caches zero-padded along the sequence to ``length`` positions, the
    layout in which ``decode_step`` appends each new token's cache row
    (K/V, or the MLA latent and RoPE key).  The ``"ssm"`` states have no
    sequence axis and pass through as they are.

    On a mesh (``mesh``, the rank's ``MeshCtx``) each cache is the rank's
    chunk, and the padded length is rounded up to a multiple of tp; where
    the chunk length changes, the chunks are gathered over "model" (rows
    past the prompt are zeros), padded or cut, and each rank keeps its
    new chunk."""
    out = {}
    tp = L.tp_of(mesh)
    length = L.pad_to(length, tp)
    for name, c in caches.items():
        if name == "ssm":
            out[name] = c
            continue
        if mesh is not None:
            if c.shape[2] * tp == length:
                out[name] = c
                continue
            c = mesh.all_gather(c, 2)[:, :, :length]
        padded = c.new_zeros(c.shape[:2] + (length,) + c.shape[3:])
        padded[:, :, :c.shape[2]] = c
        out[name] = padded if mesh is None else \
            L.local_part(padded, 2, mesh).clone()
    return out


def build(cfg: ModelConfig, device=None,
          generator: Optional[torch.Generator] = None,
          training: bool = False, mesh=None) -> Model:
    """A ``Model`` with random weights on ``device`` (the card unless the
    caller names one), drawn from ``generator`` (seed 0 by default); with
    ``training``, trainable and with its MTP head.  Kept under the
    reference's name (``repro.models.model.build``), so callers of either
    package build a model the same way.

    With ``mesh`` (a ``MeshCtx``) the model is that rank's part: every
    weight is drawn whole from the generator, as without a mesh, and the
    rank keeps its slice (``shard_leaf``), so a tp = k model holds the tp
    = 1 model's weights, plus zero query heads where tp does not divide
    them.  The peak while building is the rank's shard plus one layer
    whole (of a MoE layer's routed experts one at a time: each is drawn,
    then kept or dropped)."""
    return Model(cfg, device, generator, training, mesh)


# ---------------------------------------------------------------------------
# parameter rules on a mesh: the reference's ``_spec_for_leaf``
# ---------------------------------------------------------------------------
def _routed_expert(name: str) -> bool:
    parts = name.split(".")
    return "moe" in parts and parts[-1] in ("w_gate", "w_up", "w_down")


def _mamba1_in_proj(name: str, cfg: ModelConfig) -> bool:
    parts = name.split(".")
    return cfg.family == "ssm" and "ssm" in parts and parts[-1] == "in_proj"


def _fsdp(cfg: ModelConfig, mcx, training: bool) -> bool:
    """Whether weights are also held as shards over "data": FSDP, for
    training only (serving keeps the tensor-parallel layout)."""
    return training and cfg.fsdp and mcx is not None and mcx.dp_size > 1


def split_dim(name: str, shape, cfg: ModelConfig, tp: int) -> tuple:
    """(dim, padded): the dim of the weight ``name`` (a state-dict name;
    ``shape`` its whole shape) of which each of tp ranks holds a 1/tp
    slice, None where every rank holds it whole; and the size that dim is
    zero-padded to first (the query heads of GQA attention, padded to a
    multiple of tp), else None.  The reference's rules: vocabulary rows of
    ``emb`` / ``unemb``; query heads of ``wq`` / ``bq`` / ``wo``; K/V heads
    of ``wk`` / ``wv`` where tp divides them (``bk``, ``bv`` whole); MLA's
    heads of ``wq_b`` / ``wk_b`` / ``wv_b`` / ``wo``; the MLP's width
    (``w_gate``, ``w_up``, ``b_up`` by column, ``w_down`` by row); a MoE
    layer's routed experts, and the shared experts' width; Mamba-1's
    ``d_inner`` (``in_proj``, ``conv_w``, ``dt_proj`` by column, the rest
    by row; ``in_proj``'s slice is the rank's channels of x and of z,
    ``shard_leaf``); norms, the router, MLA's down projections, Mamba-2's
    weights and every bias of the output whole."""
    parts = name.split(".")
    leaf = parts[-1]

    def fits(dim):
        return dim if shape[dim] % tp == 0 else None

    if leaf == "emb":
        return fits(0), None
    if leaf == "unemb":
        return fits(1), None
    if "attn" in parts and cfg.attn_type != "mla":
        Hp = L.pad_to(cfg.num_heads, tp)
        if leaf == "wq":
            return 1, Hp
        if leaf in ("wo", "bq"):
            return 0, Hp
        if leaf in ("wk", "wv"):
            return fits(1), None
        return None, None
    if "attn" in parts:
        if leaf in ("wq_b", "wk_b", "wv_b"):
            return fits(1), None
        return (fits(0) if leaf == "wo" else None), None
    if "moe" in parts:
        if leaf in ("w_gate", "w_up", "w_down", "ws_down"):
            return fits(0), None
        return (fits(1) if leaf in ("ws_gate", "ws_up") else None), None
    if "mlp" in parts:
        if leaf in ("w_gate", "w_up"):
            return fits(1), None
        return (fits(0) if leaf in ("w_down", "b_up") else None), None
    if "ssm" in parts and cfg.family == "ssm":
        if cfg.d_inner % tp:
            return None, None
        return (1 if leaf in ("in_proj", "conv_w", "dt_proj") else 0), None
    return None, None


def param_spec(name: str, shape, cfg: ModelConfig, mcx,
               training: bool = False) -> tuple:
    """The axis each dim of the weight ``name`` (``shape`` its whole
    shape) is split over on the mesh of ``mcx``: "model" where
    ``split_dim`` says (tp > 1), and with FSDP (``cfg.fsdp``, training,
    dp > 1) "data" on the dim ``zero1_spec`` picks, for weights of two or
    more dims (the reference's rule, on the port's per-layer shapes);
    None elsewhere."""
    spec = [None] * len(shape)
    tp = L.tp_of(mcx)
    shape = list(shape)
    if tp > 1:
        dim, padded = split_dim(name, shape, cfg, tp)
        if dim is not None:
            spec[dim] = "model"
            shape[dim] = padded or shape[dim]
    if _fsdp(cfg, mcx, training) and len(shape) >= 2:
        spec = list(OPT.zero1_spec(spec, shape, mcx.dp_size))
    return tuple(spec)


def shard_leaf(name: str, t: torch.Tensor, cfg: ModelConfig, mcx):
    """The rank's part over "model" of the weight ``name`` (``t`` whole):
    padded and sliced as ``split_dim`` says, as a tensor of its own (the
    whole one can be freed).  Mamba-1's ``in_proj`` (d, 2 d_inner) =
    [x | z] gives the rank its channels of x and its channels of z."""
    if mcx is None or mcx.tp_size == 1:
        return t
    dim, padded = split_dim(name, t.shape, cfg, mcx.tp_size)
    if dim is None:
        return t
    if _mamba1_in_proj(name, cfg):
        return L.local_part(t.unflatten(1, (2, -1)), 2, mcx).flatten(1, 2) \
            .clone()
    if padded is not None and t.shape[dim] < padded:
        pad = list(t.shape)
        pad[dim] = padded - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim)
    return L.local_part(t, dim, mcx).clone()


def local_leaf(name: str, t: torch.Tensor, spec, cfg: ModelConfig, mcx,
               model_done: bool = False):
    """The rank's part of the weight (or optimizer state) ``name`` whose
    whole is ``t``, by ``spec``: its slice over "model" (``shard_leaf``,
    unless ``model_done``: ``t`` is that already), then its slice over
    "data" of each dim the spec splits there."""
    if "model" in spec and not model_done:
        t = shard_leaf(name, t, cfg, mcx)
    for dim, axis in enumerate(spec):
        if axis == "data":
            n = t.shape[dim] // mcx.dp_size
            t = t.narrow(dim, mcx.data_index * n, n).clone()
    return t


def global_leaf(name: str, t: torch.Tensor, spec, cfg: ModelConfig, mcx):
    """The whole of the weight (or optimizer state) ``name`` from the
    rank's part ``t`` (``local_leaf``'s inverse; padded query heads
    kept): all-gathered over "data", then over "model".  Every rank of the
    mesh must call it, in the same order."""
    t = t.detach()
    for dim, axis in enumerate(spec):
        if axis == "data":
            t = mcx.all_gather(t, dim, "data")
    for dim, axis in enumerate(spec):
        if axis == "model":
            if _mamba1_in_proj(name, cfg):
                t = mcx.all_gather(t.unflatten(1, (2, -1)), 2).flatten(1, 2)
            else:
                t = mcx.all_gather(t, dim)
    return t


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------
def _tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as numpy stores jax's) as a
    CPU tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(tree, cfg: ModelConfig,
                          training: bool = False, mesh=None) -> dict:
    """The port's state dict of the reference's parameter pytree (numpy
    arrays): ``emb``, ``unemb``, ``ln_final``, ``stacks`` (deepseek's
    ``moe_dense`` stack, then its ``moe`` stack; one ``ssm`` or ``hybrid``
    stack), each stack with its leading layer axis, and the hybrid's
    ``shared`` block.  Load it with ``Model.load_state_dict``.

    ``mtp`` is carried only with ``training``, for a model built for
    training: the multi-token-prediction head is read only by the loss,
    and a serving ``Model`` holds none.

    With ``mesh`` (a rank's ``MeshCtx``) each global array is sliced to
    the rank (``local_leaf``: over "model", and with ``training`` and
    ``cfg.fsdp`` over "data" too).  The arrays come from a reference built
    on the same mesh shape, so its padded query heads are the port's."""
    sd = {"emb": _tensor(tree["emb"])}
    if "unemb" in tree:
        sd["unemb"] = _tensor(tree["unemb"])
    for k, a in tree["ln_final"].items():
        sd[f"ln_final.{k}"] = _tensor(a)
    for part, leaves in tree.get("shared", {}).items():
        for name, a in leaves.items():
            sd[f"shared.{part}.{name}"] = _tensor(a)
    for (_, lo, hi), stack in zip(T.stack_groups(cfg), tree["stacks"]):
        for part, leaves in stack.items():
            for name, a in leaves.items():
                a = np.asarray(a)
                for j in range(hi - lo):
                    sd[f"layers.{lo + j}.{part}.{name}"] = _tensor(a[j])
    if training and "mtp" in tree:
        mtp = tree["mtp"]
        sd["mtp.proj"] = _tensor(mtp["proj"])
        for norm in ("ln_h", "ln_e"):
            for k, a in mtp[norm].items():
                sd[f"mtp.{norm}.{k}"] = _tensor(a)
        for part, leaves in mtp["layer"].items():
            for name, a in leaves.items():
                sd[f"mtp.layer.{part}.{name}"] = _tensor(a)
    if mesh is not None:
        sd = {k: local_leaf(k, v, param_spec(k, v.shape, cfg, mesh,
                                              training), cfg, mesh)
              for k, v in sd.items()}
    return sd
