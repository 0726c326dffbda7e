"""The port's device PLCP route against the JAX package's, as
``tests/test_plcp_device.py``: ``compute_plcp_device`` on random,
repetitive and run-length texts, the device encoder against the host
encoder and the reference's, ``write_plcp_bytes`` read back by both
packages' decoders, and ``compute_plcp_device`` fed by the port's own
``compute_sa_device``.  Exact equality; on the CPU the Kasai walk runs
its plain version."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.lcp import plcp as R
from bwtb3m_tpu.ops.doubling import suffix_array as ref_suffix_array
from bwtb3m_tpu_torch.lcp import plcp as P
from oracle import naive_circular_sa


def _sa(text, sigma):
    sa, _isa, _bwt = ref_suffix_array(text, sigma)
    return np.asarray(sa, np.int64)


def _text(kind, n=5000):
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        return rng.integers(0, 4, n).astype(np.int32)
    if kind == "repetitive":
        seg = rng.integers(0, 4, 61)
        text = np.tile(seg, n // 61 + 1)[:n].astype(np.int32)
        text[rng.integers(0, n, 25)] = rng.integers(0, 4, 25)
        return text
    return np.repeat(rng.integers(0, 4, n // 40 + 1), 40)[:n].astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "repetitive", "runs"])
def test_plcp_device_matches_reference(kind):
    text = _text(kind)
    sa = _sa(text, 4)
    got = P.compute_plcp_device(text, 4, torch.from_numpy(sa), lanes=128,
                                device="cpu")
    want = R.compute_plcp_device(text, 4, jnp.asarray(sa.astype(np.uint32)),
                                 lanes=128)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), R.kasai_plcp(text, sa))


def test_encode_device_matches_host(tmp_path):
    rng = np.random.default_rng(3)
    n = 3000
    text = rng.integers(0, 4, n).astype(np.int32)
    plcp_dev = P.compute_plcp_device(text, 4, torch.from_numpy(_sa(text, 4)),
                                     lanes=64, device="cpu")
    plcp = plcp_dev.numpy().astype(np.int64)
    nbits, by = P.encode_plcp_bits_device(plcp_dev)
    bits_host = P.encode_plcp_bits(plcp)
    assert nbits == len(bits_host)
    np.testing.assert_array_equal(
        np.unpackbits(by, bitorder="little")[:nbits], bits_host)
    ref_nbits, ref_by = R.encode_plcp_bits_device(
        jnp.asarray(plcp.astype(np.uint32)))
    assert (nbits, by.tobytes()) == (ref_nbits, ref_by.tobytes())
    port, ref = str(tmp_path / "p.lcpbit"), str(tmp_path / "r.lcpbit")
    P.write_plcp_bytes(port, n, nbits, by)
    R.write_plcp_bytes(ref, n, ref_nbits, ref_by)
    assert open(port, "rb").read() == open(ref, "rb").read()
    host = str(tmp_path / "h.lcpbit")
    P.write_plcp_file(host, plcp)
    assert open(host, "rb").read() == open(port, "rb").read()
    for dec in (P.PLCPBitDecoder(port, n=n), R.PLCPBitDecoder(port, n=n)):
        np.testing.assert_array_equal(dec.all(), plcp)
    assert P.encode_plcp_bits_device(plcp_dev[:0])[0] == 0


def test_compute_plcp_device_from_compute_sa_device(tmp_path):
    """The port's ``compute_sa_device`` (the harvest walk at rate 1) feeds
    ``compute_plcp_device``, as the genome path does on the card."""
    from bwtb3m_tpu_torch.engine import (BwtOptions, compute_bwt,
                                         compute_sa_device)

    rng = np.random.default_rng(9)
    data = rng.integers(97, 101, 4096, dtype=np.uint8)
    inp = str(tmp_path / "t.bin")
    data.tofile(inp)
    res = compute_bwt(BwtOptions(input_path=inp, bwt_only=True,
                                 preisa_sampling_rate=256, verbose=0,
                                 device="cpu"))
    sa_dev, n = compute_sa_device(res.bwt_path, device="cpu")
    text = data.astype(np.int32)
    want_sa = naive_circular_sa(text)
    np.testing.assert_array_equal(sa_dev.numpy(), want_sa)
    plcp = P.compute_plcp_device(text, 256, sa_dev, lanes=100, device="cpu")
    np.testing.assert_array_equal(plcp.numpy().astype(np.int64),
                                  R.kasai_plcp(text, want_sa))
    # the dense codes with nibble windows give the same values
    dense = P.compute_plcp_device(text - 97, 4, sa_dev, lanes=100,
                                  device="cpu")
    assert torch.equal(dense, plcp)
