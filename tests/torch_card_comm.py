"""Collectives for processes that share one card: the collectives class
``ProcessMesh(..., comm=CardComm)`` takes where several mesh ranks run on
one device, as ``chip_smoke.py`` phase 18 and the card tests do.  NCCL
refuses two ranks on one device, and gloo alone carries CUDA tensors
through the host; so each collective moves its operand through staging
buffers on the card and uses the gloo group only to order the ranks.
Only ``torch`` is imported."""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import _ProcessComm


class CardComm(_ProcessComm):
    """The collectives of processes sharing one card.  Each process holds a
    staging buffer of ``STAGE`` bytes on the card, which every other maps
    (CUDA IPC); a collective moves its operand through the buffers in
    chunks: each process writes its chunk, the group meets (a
    synchronize, then a gloo barrier), each reads the others' chunks and
    combines them in rank order (so the ranks of a group agree, as thread
    ranks do), and the group meets again before the buffers are
    reused.  gloo itself carries no tensor: through the host it moves
    about 0.7 GB/s, the card's copies are three orders faster."""

    STAGE = 1 << 28

    def __init__(self, dp: int, tp: int, procs: tuple, device="cuda"):
        super().__init__(dp, tp, procs)
        from torch.multiprocessing.reductions import reduce_tensor
        self.whole = self.groups[tuple(range(dp * tp))]
        self.device = torch.device(device)
        self.peers = []
        if self.dist.get_rank() not in procs:
            return
        self.buf = torch.empty(self.STAGE, dtype=torch.uint8,
                               device=self.device)
        handles = [None] * len(procs)
        self.dist.all_gather_object(handles, reduce_tensor(self.buf),
                                    group=self.whole)
        me = procs.index(self.dist.get_rank())
        self.peers = [self.buf if q == me else fn(*args)
                      for q, (fn, args) in enumerate(handles)]

    def _meet(self, ranks) -> None:
        torch.cuda.synchronize(self.device)
        self.dist.barrier(group=self.groups[ranks])

    def _stage(self, q, dtype, n):
        """The first ``n`` elements of mesh rank ``q``'s buffer as
        ``dtype``."""
        size = torch.empty((), dtype=dtype).element_size()
        return self.peers[q][:n * size].view(dtype)

    def _per(self, dtype) -> int:
        return self.STAGE // torch.empty((), dtype=dtype).element_size()

    def all_reduce(self, x, ranks, pos, op):
        flat = x.contiguous().view(-1)
        out = torch.empty_like(flat)
        per = self._per(x.dtype)
        for lo in range(0, flat.numel(), per):
            k = min(per, flat.numel() - lo)
            self._stage(ranks[pos], x.dtype, k).copy_(flat[lo:lo + k])
            self._meet(ranks)
            acc = out[lo:lo + k]
            acc.copy_(self._stage(ranks[0], x.dtype, k))
            for q in ranks[1:]:
                if op == "sum":
                    acc.add_(self._stage(q, x.dtype, k))
                else:
                    torch.maximum(acc, self._stage(q, x.dtype, k), out=acc)
            self._meet(ranks)
        return out.view(x.shape)

    def all_gather(self, x, ranks, pos, dim):
        # each rank's x is read from the buffers straight into its slice
        # of the result (an FSDP weight's gather makes no second copy)
        n, s = len(ranks), x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * s
        out = x.new_empty(shape)
        self._gather_into(x.contiguous(), ranks, pos,
                          [out.narrow(dim, i * s, s) for i in range(n)])
        return out

    def _gather_into(self, x, ranks, pos, parts) -> None:
        """Every rank's contiguous ``x`` into ``parts`` (views of ``x``'s
        shape, one for each rank of the group): in chunks of elements
        where the parts are contiguous, else of ``x``'s rows (dim 0), and
        row by row where a row is larger than a buffer."""
        per = self._per(x.dtype)
        if all(p.is_contiguous() for p in parts):
            x, parts = x.view(-1), [p.view(-1) for p in parts]
        unit = x[0].numel()
        if unit > per:
            for r in range(x.shape[0]):
                self._gather_into(x[r], ranks, pos, [p[r] for p in parts])
            return
        step = per // unit
        for lo in range(0, x.shape[0], step):
            k = min(step, x.shape[0] - lo)
            rows = (k,) + tuple(x.shape[1:])
            self._stage(ranks[pos], x.dtype, k * unit).view(rows).copy_(
                x[lo:lo + k])
            self._meet(ranks)
            for p, q in zip(parts, ranks):
                p[lo:lo + k].copy_(self._stage(q, x.dtype, k * unit)
                                   .view(rows))
            self._meet(ranks)

    def all_to_all(self, x, ranks, pos):
        n = len(ranks)
        rows = x.contiguous().view(n, -1)
        r = rows.shape[1]
        out = torch.empty_like(rows)
        per = max(1, self._per(x.dtype) // n)
        for lo in range(0, r, per):
            k = min(per, r - lo)
            self._stage(ranks[pos], x.dtype, n * k).view(n, k).copy_(
                rows[:, lo:lo + k])
            self._meet(ranks)
            for i, q in enumerate(ranks):
                out[i, lo:lo + k] = self._stage(q, x.dtype, n * k).view(
                    n, k)[pos]
            self._meet(ranks)
        return out.view(x.shape)

    def reduce_scatter(self, x, ranks, pos, dim):
        # rank j's part is x's slice j along ``dim``.  Where ``dim`` is not
        # 0 the parts are staged in chunks of their rows (dim 0), so that
        # the operand (an FSDP weight's whole gradient) is not copied
        # first; each rank reads its part of every staged chunk and sums
        # them in rank order
        n = len(ranks)
        m = x.shape[dim] // n
        parts = [x.narrow(dim, j * m, m) for j in range(n)]
        out = torch.empty(parts[0].shape, dtype=x.dtype, device=x.device)
        unit = out[0].numel() if dim != 0 else 1
        if dim == 0 or n * unit > self._per(x.dtype):
            parts = [p.reshape(-1) for p in parts]      # chunks of elements
            acc_of, unit = out.view(-1), 1
        else:
            acc_of = out
        rest = acc_of.shape[1:]
        per = max(1, self._per(x.dtype) // (n * unit))
        for lo in range(0, acc_of.shape[0], per):
            k = min(per, acc_of.shape[0] - lo)

            def staged(q):
                return self._stage(q, x.dtype, n * k * unit).view(
                    (n, k) + rest)
            mine = staged(ranks[pos])
            for j in range(n):
                mine[j].copy_(parts[j][lo:lo + k])
            self._meet(ranks)
            acc = acc_of[lo:lo + k]
            acc.copy_(staged(ranks[0])[pos])
            for q in ranks[1:]:
                acc.add_(staged(q)[pos])
            self._meet(ranks)
        return out
