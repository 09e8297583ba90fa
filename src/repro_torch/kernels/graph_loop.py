"""CUDA graph capture and the device-side loop of the fused executor:
wrapper over ``csrc/graph_loop.cu``.

Replaces the reference's ``lax.while_loop`` over whole rounds
(``src/repro/engine/fused.py``, ``_build_fixpoint``).  ``capture`` records
a function's launches as a CUDA graph on a side stream (PyTorch's
``CUDAGraph``); ``WhileLoop`` puts a captured loop iteration under a
conditional WHILE node, so that a whole linear phase runs from one launch
and the host reads its result once.  The iteration must end by writing its
continue flag into the int32 ``cont`` buffer.

The plain version of the loop is the host loop of the fused executor's
CPU path (``repro_torch.engine.fused._HostLoop``): run the iteration,
read the flag, repeat.

Nothing here runs eagerly in place of a graph: a capture that fails, a
graph the driver refuses, or a launch that fails raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# device-loop launches (one per phase run on the card); apart from the
# four kernels' counts in ``kernels.ops.launch_counts``
LAUNCHES = {"graph_loop": 0}

_SIDE_STREAMS: dict = {}


def capture(fn, keep_graph: bool = False):
    """Capture ``fn()`` as a CUDA graph on a side stream of the current
    device.  Returns (graph, fn's outputs, launches per kernel recorded in
    the graph).  The wrappers' calls during the capture are taken back out
    of the launch counts; a replay adds them (``KO.add_launches``), and
    under a cost recorder the launches' dict (a ``KO.Made``) also holds
    the capture's count in ``cost``, which a replay adds too.
    Raises if anything in ``fn`` cannot be captured."""
    from repro_torch.analysis import cost
    from repro_torch.kernels import ops as KO
    dev = torch.cuda.current_device()
    side = _SIDE_STREAMS.get(dev)
    if side is None:
        side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
             else torch.cuda.CUDAGraph())
    side.wait_stream(torch.cuda.current_stream())
    with KO.uncounted() as made, torch.cuda.stream(side):
        # the capture's own bookkeeping ops are not the program's work
        with cost.suspended():
            graph.capture_begin()
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass            # the capture was invalidated by the error
            raise
        with cost.suspended():
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out, made


class WhileLoop:
    """An instantiated outer graph that runs the captured iteration
    ``graph`` (captured with ``keep_graph=True``) while the device int32
    ``cont`` is nonzero."""

    def __init__(self, graph: torch.cuda.CUDAGraph, cont: torch.Tensor):
        if cont.dtype != torch.int32 or cont.numel() != 1 or not cont.is_cuda:
            raise ValueError("cont must be one int32 on the card")
        self.body = graph              # keeps the body's memory pool alive
        self.cont = cont
        self.device = cont.device
        self.graph = ctypes.c_void_p()
        self.exec = ctypes.c_void_p()
        lib = build.library()
        with torch.cuda.device(self.device):
            err = lib.rt_while_graph_create(
                graph.raw_cuda_graph(), cont.data_ptr(),
                ctypes.byref(self.graph), ctypes.byref(self.exec))
        if err:
            raise RuntimeError(
                "rt_while_graph_create: CUDA error "
                f"{err} ({lib.rt_error_string(err).decode()}): the card "
                "refused a conditional WHILE node around the captured "
                "iteration")

    def launch(self) -> None:
        """Run the loop on the current stream (asynchronously)."""
        if not self.exec:
            raise RuntimeError("launch of a closed WhileLoop")
        build.launch("rt_graph_launch", self.device, self.exec)
        LAUNCHES["graph_loop"] += 1

    def close(self) -> None:
        if self.exec or self.graph:
            build.library().rt_graph_destroy(self.graph, self.exec)
        self.graph = ctypes.c_void_p()
        self.exec = ctypes.c_void_p()
        self.body = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
