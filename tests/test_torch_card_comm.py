"""``CardComm`` (``tests/torch_card_comm.py``), the collectives of
processes that share one card, on the CPU: its ranks are threads here and
its staging buffers CPU tensors, with a barrier in place of the
synchronize and the gloo barrier.  Each collective equals thread ranks'
(``_ThreadComm``) to the bit, in both of ``reduce_scatter``'s chunkings
(rows of the parts, elements) and across chunk boundaries."""
import threading

import pytest
import torch

from repro_torch.launch.mesh import _ThreadComm
from torch_card_comm import CardComm

N = 4
RANKS = tuple(range(N))


def _on_threads(stage, fn):
    """``fn(comm, pos)`` on N threads through CardComm over staging
    buffers of ``stage`` bytes; the results in rank order."""
    bufs = [torch.empty(stage, dtype=torch.uint8) for _ in range(N)]
    barrier = threading.Barrier(N, timeout=60)

    class OnThreads(CardComm):
        STAGE = stage

        def __init__(self):          # noqa: D107 - no process group
            self.peers = bufs

        def _meet(self, ranks):
            barrier.wait()
    out = [None] * N

    def rank(pos):
        out[pos] = fn(OnThreads(), pos)
    threads = [threading.Thread(target=rank, args=(p,)) for p in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _thread_ranks(fn):
    comm = _ThreadComm(1, N)
    out = [None] * N

    def rank(pos):
        out[pos] = fn(comm, pos)
    threads = [threading.Thread(target=rank, args=(p,)) for p in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


# 512 B: a part's row is larger than a chunk (element chunks, many);
# 16 KiB: rows; 1 MiB: one chunk
@pytest.mark.parametrize("stage", [1 << 9, 1 << 14, 1 << 20])
@pytest.mark.parametrize("kind,dim", [
    ("reduce_scatter", 0), ("reduce_scatter", 1), ("reduce_scatter", 2),
    ("all_gather", 0), ("all_gather", 1), ("all_gather", 2),
    ("all_reduce", None), ("all_to_all", None)])
def test_card_collectives_equal_thread_ranks(kind, dim, stage):
    gen = torch.Generator().manual_seed(0)
    # all_gather's rows of 180 elements pass a 512 B buffer (row by row)
    shape = [N, 6, 5, 7] if kind == "all_to_all" else \
        [6, 20, 9] if kind == "all_gather" else [6, 5, 7]
    if kind == "reduce_scatter":
        shape[dim] = 8 * N
    xs = [torch.randn(*shape, generator=gen) for _ in range(N)]

    def call(comm, pos):
        args = {"reduce_scatter": (dim,), "all_gather": (dim,),
                "all_reduce": ("sum",), "all_to_all": ()}[kind]
        return getattr(comm, kind)(xs[pos], RANKS, pos, *args)
    got = _on_threads(stage, call)
    want = _thread_ranks(call)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
        assert g.is_contiguous()
