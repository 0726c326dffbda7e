"""The FM index and its structures (host numpy files; queries on the card).

``bitvector``, ``huffman``, ``wavelet`` (``.hwt`` / ``.rlhwt``),
``dnarank`` (DNR1), ``sampled`` (``.sa`` / ``.isa``), ``bwa`` (BWA export)
and ``cst`` are host code, as in the reference; ``fm`` answers its
queries over the rank rows on the card, and ``bidir`` over bit-plane
rows.  The submodules are imported by name (``index.fm`` pulls in the
device ops)."""
