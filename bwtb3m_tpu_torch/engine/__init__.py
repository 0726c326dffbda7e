"""Orchestration: BwtOptions -> compute_bwt() -> BwtResult, check_bwt,
compute_ssa and the other sampled-SA entry points."""

from .api import compute_bwt
from .options import BwtOptions
from .result import BwtResult
from .ssa import (compute_isa_from_preisa, compute_sa_device, compute_ssa,
                  select_ssa)
from .verify import check_bwt

__all__ = ["BwtOptions", "BwtResult", "compute_bwt", "check_bwt",
           "compute_ssa", "compute_isa_from_preisa", "compute_sa_device",
           "select_ssa"]
