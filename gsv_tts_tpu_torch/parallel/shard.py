"""Data-parallel inference over the ranks of a mesh (counterpart of
``gsv_tts_tpu/parallel/shard.py``).

JAX shards one continuous-batching wave's slots over the ``dp`` devices and
replicates the params.  Here each dp rank is a process holding the same
params (each rank loads the same checkpoint) and ``B/dp`` of the wave's
slots; the engine's host loop runs on every rank over the whole wave, its
per-chunk reads all-gathered over dp (``runtime/t2s_session.py``).  Each
rank's local wave takes its own kernels by its local size
(``t2s_session.step_path``): K2 for 2..8 local slots, K1 for one — a wave of
one slot, and the tail compacted to one, is replicated and stepped by K1 on
every rank.
"""
from __future__ import annotations

from ..runtime.t2s_session import T2SEngine
from . import mesh as pmesh


class DataParallelEngine(T2SEngine):
    """``T2SEngine`` whose batched generation splits slots over the mesh's
    ``dp`` ranks (the ``tp`` dim, if any, is not used: params stay whole).

    Use with batch-size buckets that are multiples of the dp size; each rank
    holds ``B/dp`` continuous-batching slots.  Every rank calls the same
    generation with the same arguments and an equally seeded generator."""

    def __init__(self, *args, mesh, **kwargs):
        super().__init__(*args, **kwargs)
        dp = pmesh.axis(mesh, "dp")
        for b in self.buckets:
            if b > 1 and b % dp[1] != 0:
                raise ValueError(f"batch bucket {b} not divisible by dp axis {dp[1]}")
        self.mesh = mesh
        self._dp = dp
