"""Device operations of the port: the doubling sort, rank rows, LF walks.

Not carried over from ``bwtb3m_tpu/ops``, and why:

- ``rank_packed.py`` (bit-plane packed ``OccTable``): it only fed the
  Pallas LF walk; the port's rows are ``focc_bp.py``'s and ``focc.py``'s
  under the hand kernels, and the legacy engine it served is mapped onto
  the scaled engine (``engine/api.py``);
- ``idx64.py`` (uint32 gathers and scatters): torch indexes with int64;
- ``gap.py`` (the legacy engine's chains): mapped, as above;
- the TPU and relay workarounds: shape bucketing and caps on compile
  variants, the CPU fallback for small inputs, relay-driven dispatch
  fusion; a CUDA launch needs none of them.
"""
