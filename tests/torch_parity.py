"""Helpers of the ``test_torch_parity_*`` files: one build with each
package on the same input, and the comparison of their files."""

from __future__ import annotations

import json

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt

SAMPLE_EXTS = (".sa", ".isa", ".hwt")
BWT_EXTS = (".bwt", ".hist", ".preisa")


def build_both(tmp_path, inp, **kw):
    """``compute_bwt`` of the port (on the CPU) and of the reference on
    the input file ``inp``, into ``port.*`` and ``ref.*`` beside it:
    {"port": (base, result), "ref": (base, result)}."""
    outs = {}
    for name, run, opts, extra in (
            ("port", compute_bwt, BwtOptions, {"device": "cpu"}),
            ("ref", jax_compute_bwt, JaxOptions, {})):
        out = str(tmp_path / ("%s.bwt" % name))
        res = run(opts(input_path=str(inp), output_filename=out, verbose=0,
                       **kw, **extra))
        outs[name] = (out[:-4], res)
    return outs


def assert_same_files(outs, exts):
    """The files ``exts`` of both builds byte for byte, and their
    ``.meta`` with the ``files`` maps popped (the names differ)."""
    for ext in exts:
        with open(outs["port"][0] + ext, "rb") as a, \
                open(outs["ref"][0] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    metas = {k: json.load(open(v[0] + ".meta")) for k, v in outs.items()}
    files = {k: m.pop("files") for k, m in metas.items()}
    assert metas["port"] == metas["ref"]
    assert sorted(files["port"]) == sorted(files["ref"])
