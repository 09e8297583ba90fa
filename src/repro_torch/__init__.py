"""PyTorch / CUDA port of the trigger-graph materialization engine.

It mirrors the layout and public names of the JAX package ``repro`` (its
reference): ``EngineKB``, ``materialize``, ``MatStats``, ``Relation``,
``SORT_STATS`` and ``HOST_SYNC_STATS``, and it reads the same
``REPRO_STORE_DTYPE`` and ``REPRO_SORTED_STORE`` environment settings, so
one test can drive both packages.  It imports neither ``jax`` nor
anything of ``repro``.  Stores live on the card unless the caller passes
``device="cpu"``; the sort, dedup and probe inner loops are CUDA kernels
written for Hopper (``repro_torch.kernels``).
"""
from repro_torch.engine.materialize import EngineKB, MatStats, materialize
from repro_torch.engine.ops import HOST_SYNC_STATS, SORT_STATS
from repro_torch.engine.relation import Relation

__all__ = ["EngineKB", "HOST_SYNC_STATS", "MatStats", "Relation",
           "SORT_STATS", "materialize"]
