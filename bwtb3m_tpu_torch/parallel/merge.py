"""Lane-sharded gap chains: one pair merge's lanes cut over the ranks.

Port of ``bwtb3m_tpu/parallel/merge.py``.  Every rank holds the same
runner (the right region's rank rows, the text, the gt bits: replicated)
and walks its contiguous part of the lanes through
``csrc/gap_chain.cu::bwt_gap_chain_mk`` into a histogram of its own; the
histograms meet once, at the end, in one ``all_reduce(SUM)``, the samples
in one ``all_reduce(MAX)`` and the final ranks in one ``all_gather``.
That code is ``ops/gapbatch.py::BatchedGapRunner`` under a mesh, and
``ShardedGapRunner`` puts one runner under one.

The reference's batched-level counterparts (``sharded_batched_chain_fn``,
``sharded_batched_anchor_fn``) are the same code: a batched level is a
``BatchedGapRunner`` of several merges, and cutting its lane axis gives
whole merges to ranks (``engine/merge_scaled.py`` passes its mesh to
every level's runner).
"""

from __future__ import annotations

import numpy as np

from ..ops.gapbatch import word_values


class ShardedGapRunner:
    """A ``BatchedGapRunner`` (a pair merge is a batch of one) with its
    lanes sharded over ``mesh``: ``compute`` leaves the summed histogram,
    the final ranks and the samples on the wrapped runner, so its views
    (``gap_checksum``, ``harvest_samples``) and the engine's zip work
    unchanged, and returns the histogram as int64."""

    def __init__(self, mesh, runner):
        if runner.lane_bucket % mesh.world:
            raise ValueError("lane_bucket %d does not divide by %d ranks"
                             % (runner.lane_bucket, mesh.world))
        runner.mesh = mesh
        self.mesh = mesh
        self.r = runner

    def compute(self, anchor_lookback: int = 64) -> np.ndarray:
        self.r.compute(anchor_lookback)
        return word_values(self.r.focc, self.r.gap).cpu().numpy()
