"""Model facade of the port: the serving steps of ``repro.models.model``
for the attention LMs (dense, MoE and MLA decoders, and encoders), as an
``nn.Module``.

``build(cfg, device=None)`` returns a ``Model`` whose ``prefill_step(batch)``
and ``decode_step(caches, token, pos)`` keep the reference's names, inputs
and outputs, so one test can drive both.  Weights are drawn from an
explicit ``torch.Generator`` on the model's device, or carried over from
the reference's parameter pytree with ``params_from_reference``.  Serving
runs under ``torch.inference_mode()``.  The training side (``ce_loss``,
``loss_fn``, ``train_step``, MTP heads) is not ported and raises; a
``Model`` holds no MTP parameters, which only the training loss reads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.relation import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_TRAINING = ("the training side is not ported: ROADMAP Queue 1 item 10 "
             "(training)")


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


def ce_loss(*args, **kwargs):
    raise NotImplementedError(_TRAINING)


class Model(nn.Module):
    """An attention decoder (or encoder) LM on one device."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device != dev:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        params = T.init_stack(cfg, generator)
        self.emb = params["emb"]
        if "unemb" in params:
            self.unemb = params["unemb"]
        self.ln_final = params["ln_final"]
        self.layers = params["layers"]

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
        h, caches = T.forward_prefill(self.layers, x, self.cfg, positions)
        return self._logits(h[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, caches, token, pos):
        """(logits (B,V) float32, caches) for one token at ``pos``; the
        caches are updated in place and returned."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        token = torch.as_tensor(token, device=self.device)
        if cfg.input_mode == "embeddings":
            x = token.to(L.torch_dtype(cfg.dtype))
        else:
            x = embed(token[:, None], self.emb)
        h, caches = T.forward_decode(self.layers, x, caches, int(pos), cfg)
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

    # ---------------- not ported ---------------------------------------------
    def loss_fn(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    def train_step(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)


def pad_caches(caches, length: int):
    """Caches zero-padded along the sequence to ``length`` positions, the
    layout in which ``decode_step`` appends each new token's cache row
    (K/V, or the MLA latent and RoPE key)."""
    out = {}
    for name, c in caches.items():
        padded = c.new_zeros(c.shape[:2] + (length,) + c.shape[3:])
        padded[:, :, :c.shape[2]] = c
        out[name] = padded
    return out


def build(cfg: ModelConfig, device=None,
          generator: Optional[torch.Generator] = None) -> Model:
    """A ``Model`` with random weights on ``device`` (the card unless the
    caller names one), drawn from ``generator`` (seed 0 by default).  Kept
    under the reference's name (``repro.models.model.build``), so callers
    of either package build a model the same way."""
    return Model(cfg, device, generator)


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


def params_from_reference(tree, cfg: ModelConfig) -> dict:
    """The port's state dict of the reference's parameter pytree (numpy
    arrays): ``emb``, ``unemb``, ``ln_final`` and ``stacks`` (deepseek's
    ``moe_dense`` stack, then its ``moe`` stack), each stack with its
    leading layer axis.  Load it with ``Model.load_state_dict``.

    ``mtp`` is left out on purpose: the multi-token-prediction head is read
    only by the reference's training loss (ROADMAP Queue 1 item 10), never
    by serving, and at deepseek's full width it is one more MoE layer of
    about 11.5 B parameters.  The port's serving ``Model`` holds none."""
    T.check_supported(cfg)
    sd = {"emb": _tensor(tree["emb"])}
    if "unemb" in tree:
        sd["unemb"] = _tensor(tree["unemb"])
    for k, a in tree["ln_final"].items():
        sd[f"ln_final.{k}"] = _tensor(a)
    for (_, lo, hi), stack in zip(T.stack_groups(cfg), tree["stacks"]):
        for part, leaves in stack.items():
            for name, a in leaves.items():
                a = np.asarray(a)
                for j in range(hi - lo):
                    sd[f"layers.{lo + j}.{part}.{name}"] = _tensor(a[j])
    return sd

