"""The cases of ``tests/test_pack_device.py``, the port's
``ops/pack.py`` against the reference's device packers and the host
codec of ``io/compact.py``, at the widths the port's regions pack (4
and 8 bits; ``tests/test_torch_devzip.py`` pins its refusal of the
others).  Compact files of every width go through ``io/compact.py``,
which ``tests/test_torch_parity_io.py`` holds to the reference's, so
``load_compact_to_device`` and the other widths have no counterpart."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from bwtb3m_tpu.ops.pack import pack_bits_device, unpack_bits_device
from bwtb3m_tpu_torch.io import compact
from bwtb3m_tpu_torch.ops.pack import pack_bits, unpack_bits


@pytest.mark.parametrize("n", [999, 960, 1])
@pytest.mark.parametrize("bits", [4, 8])
def test_device_unpack_matches_host(bits, n):
    sym = np.random.default_rng(bits + n).integers(0, 1 << bits, n,
                                                   dtype=np.int32)
    packed = compact.pack_bits(sym, bits)
    got = unpack_bits(torch.from_numpy(packed), bits, n)
    np.testing.assert_array_equal(got.numpy(), sym)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(unpack_bits_device(jnp.asarray(packed), bits,
                                                   n)))


@pytest.mark.parametrize("bits", [4, 8])
def test_device_pack_roundtrip(bits):
    sym = np.random.default_rng(bits + 10).integers(0, 1 << bits, 960,
                                                    dtype=np.int32)
    got = pack_bits(torch.from_numpy(sym), bits).numpy()
    np.testing.assert_array_equal(got, compact.pack_bits(sym, bits))
    np.testing.assert_array_equal(
        got, np.asarray(pack_bits_device(jnp.asarray(sym), bits)))
    np.testing.assert_array_equal(
        unpack_bits(torch.from_numpy(got), bits, 960).numpy(), sym)
