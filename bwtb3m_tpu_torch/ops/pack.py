"""k-bit packing of symbol tensors, LSB first.

Port of ``bwtb3m_tpu/ops/pack.py`` (``pack_bits_device``,
``unpack_bits_device``) for the two widths the merge engine's regions use
(``devzip.bits_for``): ``bits=4`` puts the earlier symbol in the low
nibble of a byte, ``bits=8`` is one symbol per byte.  This is the layout
of ``bwtb3m_tpu/io/compact.py`` and of the merge engine's region bytes
(``engine/checkpoint.py`` writes them as they are).  The functions run on
the tensor's device; the reference's 1-D staging rules were an XLA:TPU
tiling limit and do not carry over.
"""

from __future__ import annotations

import torch


def _check_bits(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return 8 // bits


def pack_bits(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer symbols [n] -> packed uint8 [n*bits/8].  ``n*bits`` must
    be a multiple of 8 (callers pad first); symbols are masked to
    ``bits`` bits."""
    per = _check_bits(bits)
    n = symbols.shape[0]
    if n % per:
        raise ValueError("pad to byte alignment before packing")
    s = symbols.to(torch.uint8) & ((1 << bits) - 1)
    out = torch.zeros(n // per, dtype=torch.uint8, device=s.device)
    for k in range(per):
        out |= s[k::per] << (k * bits)
    return out


def unpack_bits(data: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Packed uint8 bytes -> uint8 symbols [n]."""
    per = _check_bits(bits)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=data.device)
    data = data.to(torch.uint8)
    out = torch.empty(data.shape[0] * per, dtype=torch.uint8,
                      device=data.device)
    for k in range(per):
        out[k::per] = (data >> (k * bits)) & ((1 << bits) - 1)
    return out[:n]
