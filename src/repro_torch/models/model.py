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
"""
from __future__ import annotations

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


def embed(tokens, table):
    """tokens (B,S) ints; table (V,d) -> (B,S,d): a plain gather (the
    reference's vocab-parallel gather at one device)."""
    return table[tokens]


def logits_fn(h, unemb_t, cfg):
    """Full logits for the last position (h: (B,1,d)) -> (B,V) float32,
    padded vocabulary rows at -1e30."""
    logits = torch.einsum("bsd,vd->bsv", h.float(), unemb_t.float())
    pad = torch.arange(unemb_t.shape[0], device=h.device) >= cfg.vocab_size
    return torch.where(pad, -1e30, logits[:, 0])


def _unemb_t(params, cfg):
    """Vocab-major unembedding matrix (V, d)."""
    if cfg.tie_embeddings:
        return params["emb"]
    return params["unemb"].T


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


def ce_loss(h, unemb_t, targets, mask, cfg):
    """h: (B,S,d) final-normed; unemb_t: (V,d) [vocab-major]; targets
    (B,S).  Returns (sum_loss, sum_mask).  The sequence goes in chunks of
    ``loss_chunk`` (zero-padded), summed in order as the reference's scan
    does; under autograd each chunk is checkpointed, so its (B,c,V)
    logits are recomputed in the backward and the whole (B,S,V) never
    exists."""
    B, S, _ = h.shape
    c = min(cfg.loss_chunk, S)
    pad = -S % c
    if pad:
        h = torch.cat([h, h.new_zeros((B, pad, h.shape[2]))], 1)
        targets = torch.cat([targets, targets.new_zeros((B, pad))], 1)
        mask = torch.cat([mask, mask.new_zeros((B, pad))], 1)
    targets = targets.long()
    total = torch.zeros((), device=h.device)
    for i in range(0, S + pad, c):
        args = (h[:, i:i + c], unemb_t, targets[:, i:i + c],
                mask[:, i:i + c], cfg.vocab_size)
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            total = total + _ce_chunk(*args)
    return total, mask.sum()


class Model(nn.Module):
    """A decoder (or encoder) LM on one device."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 training: bool = False):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device != dev:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        self.opt_cfg = OPT.OptConfig(grad_compress=cfg.grad_compress)
        self.for_training = training
        params = T.init_stack(cfg, generator, mtp=training)
        self.emb = params["emb"]
        if "unemb" in params:
            self.unemb = params["unemb"]
        self.ln_final = params["ln_final"]
        self.layers = params["layers"]
        self.shared = params.get("shared")
        self.mtp = params.get("mtp")
        if training:
            self.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def _embed_inputs(self, batch):
        if self.cfg.input_mode == "embeddings":
            x = torch.as_tensor(batch["embeddings"], device=self.device)
            return x.to(L.torch_dtype(self.cfg.dtype))
        return embed(torch.as_tensor(batch["tokens"], device=self.device),
                     self.emb)

    def _logits(self, h):
        h = L.apply_norm(self.ln_final, h, self.cfg)
        top = dict(self.named_parameters(recurse=False))
        return logits_fn(h, _unemb_t(top, self.cfg), self.cfg)

    # ---------------- prefill / decode -------------------------------------
    @torch.inference_mode()
    def prefill(self, batch):
        """(logits of the last position (B,V) float32, caches)."""
        x = self._embed_inputs(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        h, caches = T.forward_prefill(self.layers, x, self.cfg, positions,
                                      self.shared)
        return self._logits(h[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, caches, token, pos):
        """(logits (B,V) float32, caches) for one token at ``pos``; the
        caches (K/V rows, SSM states) are updated in place and returned."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        token = torch.as_tensor(token, device=self.device)
        if cfg.input_mode == "embeddings":
            x = token.to(L.torch_dtype(cfg.dtype))
        else:
            x = embed(token[:, None], self.emb)
        h, caches = T.forward_decode(self.layers, x, caches, int(pos), cfg,
                                     self.shared)
        return self._logits(h), caches

    def prefill_step(self, batch):
        """batch {"tokens": (B,S)} or {"embeddings": (B,S,d)} -> (next
        token (B,) int32, caches of the prompt's length)."""
        logits, caches = self.prefill(batch)
        return logits.argmax(-1).to(torch.int32), caches

    def decode_step(self, caches, token, pos):
        """token: (B,) ints (or (B,1,d) embeddings); pos: int."""
        logits, caches = self.decode(caches, token, pos)
        return logits.argmax(-1).to(torch.int32), caches

    # ---------------- training ------------------------------------------------
    def loss_fn(self, batch):
        """(loss, {"ce": ce}) of ``batch`` ({"tokens" or "embeddings",
        "labels", optional "mask"}): the masked mean cross-entropy, plus
        0.3 times the MTP head's (predicting the token after the label)
        where the model holds one, plus the MoE load-balancing aux."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        h, aux = T.forward_train(self.layers, x, cfg, positions, self.shared)
        h = L.apply_norm(self.ln_final, h, cfg)
        top = dict(self.named_parameters(recurse=False))
        unemb_t = _unemb_t(top, cfg)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        mask = batch.get("mask")
        mask = (torch.ones(labels.shape, device=self.device) if mask is None
                else torch.as_tensor(mask, device=self.device))
        total, denom = ce_loss(h, unemb_t, labels, mask, cfg)
        ce = total / denom.clamp_min(1.0)
        loss = ce
        if cfg.mtp_depth and self.mtp is not None \
                and cfg.input_mode == "tokens":
            # multi-token prediction: predict t+2 from [h_t ; emb(label_t)]
            mp = self.mtp
            hcat = torch.cat([L.apply_norm(mp.ln_h, h, cfg),
                              L.apply_norm(mp.ln_e, embed(labels, self.emb),
                                           cfg)], dim=-1)
            h2 = torch.einsum("bsd,de->bse", hcat, mp.proj)
            y = T.attn_block_fwd(mp.layer, h2, cfg, positions, causal=True)
            y = y[0] if isinstance(y, tuple) else y
            mask2 = mask.clone()
            mask2[:, -1] = 0.0
            t2, d2 = ce_loss(L.apply_norm(self.ln_final, y, cfg), unemb_t,
                             torch.roll(labels, -1, dims=1), mask2, cfg)
            loss = loss + 0.3 * t2 / d2.clamp_min(1.0)
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

    def train_step(self, opt_state, batch, step: int):
        """One optimizer step on ``batch``; the weights are updated in
        place.  With ``cfg.microbatches`` M > 1 the batch is cut into M
        equal parts whose gradients accumulate in float32 and are divided
        by M (the reported ``ce`` is then the mean loss, as on the
        reference).  Returns (opt_state, {"loss", "ce", "grad_norm",
        "lr"})."""
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
        _, opt_state, stats = OPT.apply_updates(grads, opt_state, params,
                                                step, self.opt_cfg)
        return opt_state, {"loss": loss, **met, **stats}


def pad_caches(caches, length: int):
    """Caches zero-padded along the sequence to ``length`` positions, the
    layout in which ``decode_step`` appends each new token's cache row
    (K/V, or the MLA latent and RoPE key).  The ``"ssm"`` states have no
    sequence axis and pass through as they are."""
    out = {}
    for name, c in caches.items():
        if name == "ssm":
            out[name] = c
            continue
        padded = c.new_zeros(c.shape[:2] + (length,) + c.shape[3:])
        padded[:, :, :c.shape[2]] = c
        out[name] = padded
    return out


def build(cfg: ModelConfig, device=None,
          generator: Optional[torch.Generator] = None,
          training: bool = False) -> Model:
    """A ``Model`` with random weights on ``device`` (the card unless the
    caller names one), drawn from ``generator`` (seed 0 by default); with
    ``training``, trainable and with its MTP head.  Kept under the
    reference's name (``repro.models.model.build``), so callers of either
    package build a model the same way."""
    return Model(cfg, device, generator, training)


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
                          training: bool = False) -> dict:
    """The port's state dict of the reference's parameter pytree (numpy
    arrays): ``emb``, ``unemb``, ``ln_final``, ``stacks`` (deepseek's
    ``moe_dense`` stack, then its ``moe`` stack; one ``ssm`` or ``hybrid``
    stack), each stack with its leading layer axis, and the hybrid's
    ``shared`` block.  Load it with ``Model.load_state_dict``.

    ``mtp`` is carried only with ``training``, for a model built for
    training: the multi-token-prediction head is read only by the loss,
    and a serving ``Model`` holds none."""
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
    return sd
