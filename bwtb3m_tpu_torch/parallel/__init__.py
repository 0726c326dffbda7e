"""Multi-rank execution over ``torch.distributed``: the sharded suffix
sort (``engine=sharded``), lane-sharded and rank-range-sharded merges.

Port of ``bwtb3m_tpu/parallel/``, one process per rank in place of
JAX's one controller over a device mesh (``mesh.py``)."""

from .doubling import sharded_bwt, suffix_array_sharded
from .mesh import make_mesh

__all__ = ["make_mesh", "suffix_array_sharded", "sharded_bwt"]
