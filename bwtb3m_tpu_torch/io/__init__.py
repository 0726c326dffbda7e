from .compact import (
    CompactArrayWriter,
    pack_bits,
    read_compact,
    unpack_bits,
    write_compact,
    read_compact_header,
)
from .rl import RLReader, rl_decode, rl_encode
from . import formats

__all__ = [
    "CompactArrayWriter",
    "pack_bits",
    "unpack_bits",
    "read_compact",
    "write_compact",
    "read_compact_header",
    "RLReader",
    "rl_decode",
    "rl_encode",
    "formats",
]
