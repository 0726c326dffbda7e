"""k-bit packing of symbol tensors, LSB first.

Port of ``bwtb3m_tpu/ops/pack.py`` (``pack_bits_device``,
``unpack_bits_device``) for the widths the merge engine's regions use
(``devzip.bits_for``): ``bits=4`` puts the earlier symbol in the low
nibble of a byte, ``bits=8`` is one symbol per byte, ``bits=16`` (more
than 256 distinct symbols, which the reference packs as int32) two
little-endian bytes per symbol, unpacked as the int16 of its uint16
bits, and ``bits=32`` (more than 65,536 distinct symbols) four
little-endian bytes per symbol, unpacked as int32.  This is the layout
of ``bwtb3m_tpu/io/compact.py`` and of the merge engine's region bytes
(``engine/checkpoint.py`` writes them as they are).  The functions run on
the tensor's device; the reference's 1-D staging rules were an XLA:TPU
tiling limit and do not carry over.
"""

from __future__ import annotations

import torch


def _check_bits(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, or 16 or 32, got {bits}")
    return 8 // bits


# the little-endian widths of dense ids: the most symbols each holds
# (ops/wavelet_rows.py::symbol_dtype gives their tensors' dtype)
_WORDS = {16: 1 << 16, 32: 1 << 21}


def pack_bits(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer symbols [n] -> packed uint8 [n*bits/8].  ``n*bits`` must
    be a multiple of 8 (callers pad first); symbols are masked to
    ``bits`` bits."""
    if bits in _WORDS:
        from .wavelet_rows import as_symbols
        return as_symbols(symbols, _WORDS[bits]).contiguous().view(
            torch.uint8)
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
    """Packed uint8 bytes -> uint8 symbols [n] (int16 of uint16 bits for
    ``bits=16``, int32 for ``bits=32``)."""
    if bits in _WORDS:
        from .wavelet_rows import symbol_dtype
        return data.to(torch.uint8)[:bits // 8 * n].contiguous().view(
            symbol_dtype(_WORDS[bits]))
    per = _check_bits(bits)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=data.device)
    data = data.to(torch.uint8)
    out = torch.empty(data.shape[0] * per, dtype=torch.uint8,
                      device=data.device)
    for k in range(per):
        out[k::per] = (data >> (k * bits)) & ((1 << bits) - 1)
    return out[:n]
