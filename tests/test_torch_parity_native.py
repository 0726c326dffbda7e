"""The cases of ``tests/test_native.py``, the port's native library
against the reference's.

``sais`` (the SA-IS baseline and host oracle) returns the reference's
array on random, periodic, pacterm, 1-symbol and empty texts, the naive
suffix order, the circular order on pacterm input, and there the port's
doubling sort's SA.  The LZ4 codec round-trips and cross-decodes with
the pure-Python codec of ``io/lz4io.py``; the Kasai PLCP equals the
Python oracle.  ``gt0`` is not carried over (the module's docstring
says why), so its cases have no counterpart.
"""

import numpy as np
import pytest

from bwtb3m_tpu_torch import native
from bwtb3m_tpu_torch.ops.doubling import suffix_array
from oracle import naive_circular_sa, random_string
from test_torch_hostlayer import _reference_library


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    with _reference_library(
            lambda: tmp_path_factory.mktemp("ref_native")) as ref:
        yield ref


@pytest.fixture(scope="module")
def port_lib():
    assert native.get_lib() is not None, native._error


def _texts():
    rng = np.random.default_rng(7)
    pacterm = rng.integers(1, 5, 1000).astype(np.int32)
    pacterm[-1] = 0
    return {
        "random": rng.integers(0, 4, 3000),
        "bytes": rng.integers(0, 256, 2000),
        "periodic": np.tile(rng.integers(0, 3, 7), 300),
        "poly-A": np.zeros(500, np.int64),
        "pacterm": pacterm,
        "one-symbol": np.array([3]),
        "empty": np.zeros(0, np.int64),
    }


TEXTS = _texts()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_sais_equals_reference(name, ref_native, port_lib):
    text = TEXTS[name].astype(np.int32)
    got = native.sais(text)
    want = ref_native.sais(text)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 17, 200, 1000])
def test_sais_matches_circular_oracle_on_pacterm(n, port_lib):
    """A unique smallest terminator: the circular rotation order is the
    suffix order of T$, which sais and the port's doubling sort give."""
    t = np.random.default_rng(n).integers(1, 5, n).astype(np.int32)
    t[-1] = 0
    sa = native.sais(t)
    np.testing.assert_array_equal(sa, naive_circular_sa(t))
    np.testing.assert_array_equal(sa, suffix_array(t, 5, "cpu")[0])


@pytest.mark.parametrize("sigma", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 5, 64, 500])
def test_sais_plain_suffix_order(n, sigma, port_lib):
    t = np.random.default_rng(8 + n + sigma).integers(
        0, sigma, n).astype(np.int32)
    expect = sorted(range(n), key=lambda i: (list(t[i:]) + [-1]))
    assert list(native.sais(t)) == expect


def test_native_lz4_roundtrip(ref_native, port_lib):
    rng = np.random.default_rng(0)
    for data in [b"", b"a", b"abcabcabc" * 500,
                 bytes(rng.integers(0, 4, 50000, dtype=np.uint8)),
                 bytes(rng.integers(0, 256, 10000, dtype=np.uint8))]:
        comp = native.lz4_compress(data)
        assert comp == ref_native.lz4_compress(data)
        assert native.lz4_decompress(comp, len(data)) == data


def test_native_lz4_cross_python(port_lib):
    from bwtb3m_tpu_torch.io import lz4io
    data = b"the quick brown fox " * 300
    comp_nat = native.lz4_compress(data)
    assert lz4io.lz4_decompress_block(comp_nat, len(data)) == data
    comp_py = lz4io.lz4_compress_block(data)
    assert native.lz4_decompress(comp_py, len(data)) == data


def test_native_kasai_matches_oracle(ref_native, port_lib):
    from bwtb3m_tpu_torch.lcp.plcp import kasai_plcp
    text = random_string(500, 4, seed=9)
    sa = naive_circular_sa(text)
    got = native.kasai_plcp(text, sa)
    np.testing.assert_array_equal(got, ref_native.kasai_plcp(text, sa))
    backup, native._lib, native._tried = native._lib, None, True
    try:
        py = kasai_plcp(text, sa)
    finally:
        native._lib = backup
    np.testing.assert_array_equal(got, py)
