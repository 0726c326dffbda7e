"""Construction options — the port's ``BwtOptions``.

Same fields, defaults and ``key=value`` CLI surface as
``bwtb3m_tpu/engine/options.py`` (which cannot be imported without JAX:
its package imports the device engine), plus ``device``.  One option set
drives both packages.  ``mem`` keeps its meaning: blocks of ``mem / 16``
symbols, at most 2^27, so every output is byte-identical between the
packages; what fits the device is decided where it is needed, from the
device's own report (``util/devices.py::device_budget``), not from
these options.  ``engine=merge-legacy`` runs the scaled merge engine,
whose files are the reference's legacy engine's; ``engine=sharded`` runs
the sharded suffix sort over the ranks of a process group
(``engine/api.py``, ``parallel/``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..util.args import ArgInfo


@dataclasses.dataclass
class BwtOptions:
    input_path: str
    input_type: str = "bytestream"
    output_filename: Optional[str] = None
    sa_sampling_rate: int = 32
    isa_sampling_rate: int = 262144
    mem: int = 2 * 1024 ** 3
    num_threads: int = 8                  # host advisory
    bwt_only: bool = False
    tmp_prefix: Optional[str] = None
    sparse_tmp_prefix: Optional[str] = None
    copy_input_to_memory: bool = False
    large_lcp_thres: int = 16384
    verbose: int = 1
    bwt_codec: str = "rl"            # rl | rlh
    engine: str = "auto"             # auto | doubling | merge | merge-legacy | sharded
    # symbols per block of the merge engine, and the largest text the
    # single-block sort takes: mem / 16, as in the reference package
    max_block_symbols: Optional[int] = None
    preisa_sampling_rate: Optional[int] = None  # None = adaptive
    # run a level's pair merges as one lane population when its state
    # fits the device (batchmerges=0: always pair by pair; same outputs)
    batch_merges: bool = True
    checkpoint: bool = True
    checkpoint_min_symbols: int = 1 << 26
    # bounded host memory: the text is a read-only memory map
    host_mem: Optional[int] = None
    lane_bucket: Optional[int] = None
    # the torch device every device step runs on ("cuda", "cuda:N", "cpu")
    device: str = "cuda"

    def __post_init__(self):
        if self.max_block_symbols is None:
            self.max_block_symbols = min(1 << 27, max(1 << 10, self.mem // 16))
        if self.output_filename is None:
            self.output_filename = self.input_path + ".bwt"
        if self.tmp_prefix is None:
            self.tmp_prefix = self.output_filename + "_tmp"
        if self.sparse_tmp_prefix is None:
            self.sparse_tmp_prefix = self.tmp_prefix + "_sparse"

    @property
    def base_name(self) -> str:
        """Output base: 'x.bwt' -> 'x' so sidecars are x.hist, x.preisa..."""
        out = self.output_filename
        return out[:-4] if out.endswith(".bwt") else out

    @classmethod
    def from_arginfo(cls, ai: ArgInfo) -> "BwtOptions":
        if not ai.restargs:
            raise ValueError("no input file given")
        return cls(
            input_path=ai.restargs[0],
            input_type=ai.get("inputtype", "bytestream"),
            output_filename=ai.get("outputfilename") or None,
            sa_sampling_rate=ai.get_int("sasamplingrate", 32),
            isa_sampling_rate=ai.get_int("isasamplingrate", 262144),
            mem=ai.get_int("mem", 2 * 1024 ** 3),
            num_threads=ai.get_int("numthreads", 8),
            bwt_only=ai.get_bool("bwtonly", False),
            tmp_prefix=ai.get("tmpprefix") or None,
            sparse_tmp_prefix=ai.get("sparsetmpprefix") or None,
            copy_input_to_memory=ai.get_bool("copyinputtomemory", False),
            large_lcp_thres=ai.get_int("largelcpthres", 16384),
            verbose=ai.get_int("verbose", 1),
            bwt_codec=ai.get("bwtcodec", "rl"),
            engine=ai.get("engine", "auto"),
            preisa_sampling_rate=(
                ai.get_int("preisasamplingrate", 0) or None),
            batch_merges=ai.get_bool("batchmerges", True),
            checkpoint=ai.get_bool("checkpoint", True),
            checkpoint_min_symbols=ai.get_int("checkpointminsize",
                                              1 << 26),
            host_mem=ai.get_int("hostmem", 0) or None,
            lane_bucket=ai.get_int("lanes", 0) or None,
            device=ai.get("device", "cuda"),
        )
