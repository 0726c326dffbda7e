"""``hostmem=`` in the port: bounded host memory gives the same files.

After ``tests/test_checkpoint.py::test_hostmem_text_spill`` and
``::test_bounded_ingestion_memmap_load``: with ``host_mem`` set the text
reaches the merge engine as a read-only memory map (the input file for a
bytestream, a chunk-decoded spill for pac), goes to the device in
chunks, every output is byte-identical to the unbounded build's and to
the reference package's, and no spill file is left behind.
"""

import filecmp
import glob

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.io.pac import write_pac
from bwtb3m_tpu_torch.engine import BwtOptions, api, check_bwt, compute_bwt
from bwtb3m_tpu_torch.engine import merge_scaled


def _same_files(tmp_path, a, b, exts=("bwt", "hist", "preisa")):
    for ext in exts:
        assert filecmp.cmp(tmp_path / ("%s.%s" % (a, ext)),
                           tmp_path / ("%s.%s" % (b, ext)),
                           shallow=False), (a, b, ext)


@pytest.mark.parametrize("itype", ["bytestream", "pac"])
def test_hostmem_build_is_byte_identical(tmp_path, monkeypatch, itype):
    rng = np.random.default_rng(4)
    if itype == "bytestream":
        data = rng.integers(97, 101, 6000, dtype=np.uint8)
        inp = str(tmp_path / "h.bin")
        data.tofile(inp)
        text = data
    else:
        text = rng.integers(0, 4, 6001, dtype=np.uint8)
        inp = str(tmp_path / "h.pac")
        write_pac(inp, text)
    kw = dict(input_path=inp, input_type=itype, engine="merge",
              bwt_only=True, max_block_symbols=2048,
              preisa_sampling_rate=256, verbose=0, lane_bucket=32)
    jax_compute_bwt(JaxOptions(output_filename=str(tmp_path / "j.bwt"),
                               host_mem=1000, **kw))
    compute_bwt(BwtOptions(output_filename=str(tmp_path / "a.bwt"),
                           device="cpu", **kw))

    seen = []
    real = merge_scaled.blockwise_bwt_scaled

    def probe(symbols, *a, **k):
        seen.append(symbols)
        return real(symbols, *a, **k)

    monkeypatch.setattr(merge_scaled, "blockwise_bwt_scaled", probe)
    res = compute_bwt(BwtOptions(output_filename=str(tmp_path / "b.bwt"),
                                 device="cpu", host_mem=1000, **kw))
    assert len(seen) == 1 and isinstance(seen[0], np.memmap)
    assert not seen[0].flags.writeable
    _same_files(tmp_path, "a", "b")
    _same_files(tmp_path, "j", "b")
    assert glob.glob(str(tmp_path / "*_text*.u8")) == []
    assert check_bwt(res, text, device="cpu")


def test_hostmem_spills_a_loaded_text(tmp_path):
    """``_spill_text``: a text already in memory moves to a memmap under
    tmp_prefix when text + BWT would pass hostmem, and stays otherwise."""
    from bwtb3m_tpu_torch.util.log import VerboseLog
    text = np.arange(5000, dtype=np.uint8)
    opts = BwtOptions(input_path="x", host_mem=9999,
                      output_filename=str(tmp_path / "s.bwt"))
    spilled, path = api._spill_text(text, opts, VerboseLog(0))
    assert isinstance(spilled, np.memmap) and path.endswith("_text.u8")
    np.testing.assert_array_equal(np.asarray(spilled), text)
    opts.host_mem = 10000
    kept, path2 = api._spill_text(text, opts, VerboseLog(0))
    assert kept is text and path2 is None
    again, path3 = api._spill_text(spilled, opts, VerboseLog(0))
    assert again is spilled and path3 is None


def test_hostmem_single_block_path(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.integers(97, 101, 3000, dtype=np.uint8)
    inp = str(tmp_path / "d.bin")
    data.tofile(inp)
    kw = dict(input_path=inp, preisa_sampling_rate=256, verbose=0,
              device="cpu")
    compute_bwt(BwtOptions(output_filename=str(tmp_path / "a.bwt"), **kw))
    compute_bwt(BwtOptions(output_filename=str(tmp_path / "b.bwt"),
                           host_mem=1000, **kw))
    _same_files(tmp_path, "a", "b", ("bwt", "hist", "preisa", "sa", "isa",
                                     "hwt"))
