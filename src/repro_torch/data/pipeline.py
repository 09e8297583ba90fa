"""Tokenized data streams for the port's LMs, deterministic and
checkpointable, as ``repro.data.pipeline``'s.

* ``SyntheticTokens``: a seeded random token stream.
* ``KBLinearizer``: a *materialized KB* (the port's ``EngineKB``) as token
  sequences ``[PRED] [ARG0] ... [SEP]``; the vocabulary is the dictionary's
  ids.  Its stream equals the reference's token for token; the reference
  builds one Python list per fact, this copy builds one array per predicate
  and applies the same shuffle as a permutation of rows.

Both expose ``state()`` / ``restore(state)`` so that the input position
lives in a checkpoint.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, st):
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def next(self):
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _fact_tokens(kb, n_pred: int, n_const: int):
    """Each fact as its token row, in the reference's order (predicates in
    ``kb.rels`` order, rows in store order): the flat tokens and each
    row's length."""
    preds = sorted(kb.rels)
    pred_id = {p: i for i, p in enumerate(preds)}
    flat, lengths = [], []
    for p, rel in kb.rels.items():
        ar = kb.arities[p]
        rows = rel.np_rows()[:, :ar].astype(np.int64)
        args = np.where(rows >= 0, 2 + n_pred + rows,
                        2 + n_pred + n_const - rows - 1)
        n = rows.shape[0]
        seq = np.concatenate([np.full((n, 1), 2 + pred_id[p]), args,
                              np.ones((n, 1), np.int64)], axis=1)
        flat.append(seq.reshape(-1))
        lengths.append(np.full(n, ar + 2))
    return np.concatenate(flat), np.concatenate(lengths)


class KBLinearizer:
    """Linearize dictionary-encoded facts into LM token sequences."""

    def __init__(self, kb, batch: int, seq: int, seed: int = 0):
        # token layout: [0]=PAD [1]=SEP, predicates and constants follow
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        n_pred = len(kb.rels)
        n_const = len(kb.dict)
        self.vocab_size = 2 + n_pred + n_const + kb.dict.num_nulls
        flat, lengths = _fact_tokens(kb, n_pred, n_const)
        if not len(lengths):
            self.stream = np.zeros(8, np.int32)
            return
        # the reference's ``rng.shuffle(rows)`` on the list of rows: the
        # same swaps as ``permutation`` applies to ``arange``
        perm = np.random.default_rng(seed).permutation(len(lengths))
        starts = np.cumsum(lengths) - lengths
        out_len = lengths[perm]
        out_start = np.cumsum(out_len) - out_len
        offset = np.arange(int(out_len.sum())) - np.repeat(out_start, out_len)
        self.stream = flat[np.repeat(starts[perm], out_len) + offset].astype(
            np.int32)

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def restore(self, st):
        self.step = int(st["step"])

    def next(self):
        n = self.batch * (self.seq + 1)
        start = (self.step * n) % max(len(self.stream) - n - 1, 1)
        self.step += 1
        if len(self.stream) < n + 1:
            reps = (n + 1) // len(self.stream) + 1
            buf = np.tile(self.stream, reps)[:n + 1]
        else:
            buf = self.stream[start:start + n + 1]
            if len(buf) < n + 1:
                buf = np.concatenate([buf, self.stream[:n + 1 - len(buf)]])
        toks = buf[:n].reshape(self.batch, self.seq + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
