"""bwtb3m_tpu_torch — the PyTorch / CUDA port of ``bwtb3m_tpu``.

The JAX package ``bwtb3m_tpu`` stays the reference; this package computes
the same files with PyTorch on an NVIDIA GPU (Hopper, ``sm_90a``).  It
imports ``torch`` and never ``jax``, and nothing of ``bwtb3m_tpu``: it
keeps its own copies of the reference's host-side modules under the same
names, ``io/`` (input types, the RLB1 codec, the sidecar formats),
``native/`` (the C++ host codecs, built by g++ at first use into
``build/``) and ``util/`` (argument parsing, logging, serialization).
The tests hold the copies to the reference byte for byte.

Layer map of the ported slice:

  engine/   BwtOptions -> compute_bwt() -> BwtResult, check_bwt (checkbwt),
            compute_ssa (bwtcomputessa), compute_isa_from_preisa
            (hwtPreIsaToIsa), select_ssa, compute_sa_device; the scaled
            blockwise merge engine with batched levels and checkpoints
  ops/      prefix-doubling suffix sorts (torch.sort), the rank-row build,
            plain rank / LF queries and batched backward-search steps, the
            device zip, the LF-walk (with the FM index's locate and decode
            visits), gap-chain and Kasai kernels (csrc/*.cu, built with
            nvcc at first use into build/)
  index/    the FM index (queries on the device over the rank rows), the
            bidirectional index; .hwt / .rlhwt, DNR1, sampled SA / ISA,
            BWA export and the compressed suffix tree, host numpy
  apps/     probeScanDna and allHamDna over the FM index
  cli/      ``python -m bwtb3m_tpu_torch <tool>`` for the ported tools

Every device computation runs on an explicit ``torch.device``
(``device=`` on the CLI, ``cuda`` by default); nothing falls back to the
CPU when CUDA is missing.
"""

__version__ = "0.1.0"
