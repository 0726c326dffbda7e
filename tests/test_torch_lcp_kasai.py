"""The Kasai walk's plain version (``ops/kasai.py::kasai_plain``, what the
wrapper runs on CPU tensors and what the CUDA kernel is held to on the
card) against the reference's ``_kasai_chunk2_impl``, state carried over
by ``kasai_inputs_from_jax``: after 1, 7 and 2,048 steps, then resumed
to the end, on nibble windows (sigma 4) and byte windows (sigma 200),
texts whose length is no multiple of a window, a text of one symbol
(l reaches n), a slab that starts past 0, more lanes than positions and
lanes that are done at the start.  The text words against the
reference's word for word.  Exact equality."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from bwtb3m_tpu.lcp import plcp as R
from bwtb3m_tpu.ops.doubling import suffix_array as ref_suffix_array
from bwtb3m_tpu_torch.lcp.plcp import _pack_text_words
from bwtb3m_tpu_torch.ops import kasai as K


def _text(kind, n):
    rng = np.random.default_rng(n)
    if kind == "sigma4":
        return rng.integers(0, 4, n).astype(np.int32), 4
    if kind == "sigma200":
        return rng.integers(0, 200, n).astype(np.int32), 200
    if kind == "repeats":
        seg = rng.integers(0, 4, 97)
        text = np.tile(seg, n // 97 + 1)[:n].astype(np.int32)
        text[rng.integers(0, n, 5)] = rng.integers(0, 4, 5)
        return text, 4
    return np.zeros(n, np.int32), 4           # "ones": l reaches n


def _reference_state(text, sigma, lanes, a=0, b=None):
    """The reference's arrays for the slab [a, b), as its device and slab
    paths set them up (its own words, Phi with rank 0 at 0, a drop slot
    after the slab's PLCP)."""
    n = len(text)
    b = n if b is None else b
    sa, isa, _bwt = ref_suffix_array(text, sigma)
    sa, isa = np.asarray(sa, np.int64), np.asarray(isa, np.int64)
    phi = np.zeros(n, np.uint32)
    phi[sa[1:]] = sa[:-1]
    bounds = np.linspace(a, b, min(lanes, b - a) + 1).astype(np.int64)
    state = (R._pack_text_words(text, sigma), phi[a:b],
             isa[a:b].astype(np.uint32), np.zeros(b - a + 1, np.uint32),
             bounds[:-1].astype(np.uint32), np.zeros(len(bounds) - 1,
                                                     np.uint32),
             bounds[1:].astype(np.uint32))
    return state, sa


def _ref_steps(state, steps, bits, n, a):
    words, phi, isa, plcp, p, l, pend = state
    out = R._kasai_chunk2(steps, bits, *(jnp.asarray(x) for x in (
        words, phi, isa, plcp, p, l, pend)), jnp.uint32(n), jnp.uint32(a))
    return tuple(np.asarray(x) for x in out)


def _ref_to_end(state, bits, n, a):
    words, phi, isa, plcp, p, l, pend = state
    while (p < pend).any():
        plcp, p, l = _ref_steps((words, phi, isa, plcp, p, l, pend), 2048,
                                bits, n, a)
    return plcp, p, l


def _assert_state(port, ref, slab):
    plcp, p, l = port
    rplcp, rp, rl = ref
    # the reference's drop slot (index slab) holds whatever a lane that
    # did not commit wrote there; the port writes nothing
    np.testing.assert_array_equal(plcp[:slab].numpy().view(np.uint32),
                                  rplcp[:slab])
    np.testing.assert_array_equal(p.numpy(), rp.astype(np.int64))
    np.testing.assert_array_equal(l.numpy(), rl.astype(np.int64))


@pytest.mark.parametrize("kind,n,lanes,slab", [
    ("sigma4", 3001, 64, None),        # 3001 % 8 != 0
    ("sigma200", 2003, 64, None),      # 2003 % 4 != 0
    ("repeats", 4099, 2, None),        # still walking after 2,048 steps
    ("ones", 515, 16, None),           # every rotation equal: l == n
    ("sigma4", 3001, 64, (1024, 2048)),    # a slab with a > 0
    ("sigma200", 2003, 48, (1500, 2003)),  # the last slab, a > 0
    ("sigma4", 301, 4096, None),       # more lanes than positions
])
def test_plain_matches_reference_mid_walk(kind, n, lanes, slab):
    text, sigma = _text(kind, n)
    bits = 4 if sigma <= 16 else 8
    a, b = slab or (0, n)
    state, sa = _reference_state(text, sigma, lanes, a, b)
    for steps in (1, 7, 2048):
        port = K.kasai_plain(*K.kasai_inputs_from_jax(*state), n, a, bits,
                             steps=steps)
        _assert_state(port, _ref_steps(state, steps, bits, n, a), b - a)
    # both resume from the 2,048-step state and run to the end
    mid = _ref_steps(state, 2048, bits, n, a)
    if kind == "repeats":
        assert (mid[1] < state[6]).all()
    ref_end = _ref_to_end(state[:3] + mid + state[6:], bits, n, a)
    words, phi, isa, _plcp, _p, _l, pend = K.kasai_inputs_from_jax(*state)
    plcp, p, l = port
    port_end = K.kasai_walk(words, phi, isa, plcp, p, l, pend, n, a, bits)
    _assert_state(port_end, ref_end, b - a)
    assert bool((port_end[1] == pend).all())
    want = R.kasai_plcp(text, sa)[a:b]
    np.testing.assert_array_equal(port_end[0][:b - a].numpy(), want)
    if kind == "ones":
        assert int(port_end[0].max()) == n


def test_lanes_done_at_the_start():
    """A lane with p == pend takes no step and writes nothing, in both."""
    text, sigma = _text("sigma4", 1000)
    state, _sa = _reference_state(text, sigma, 10)
    words, phi, isa, plcp, p, l, pend = state
    p = p.copy()
    p[3] = pend[3]              # lane 3 is done
    pend = pend.copy()
    pend[7] = p[7]              # lane 7 owns nothing
    state = (words, phi, isa, plcp, p, l, pend)
    for steps in (5, 300):
        port = K.kasai_plain(*K.kasai_inputs_from_jax(*state), 1000, 0, 4,
                             steps=steps)
        _assert_state(port, _ref_steps(state, steps, 4, 1000, 0), 1000)
        assert int(port[1][3]) == int(pend[3]) and int(port[1][7]) == p[7]


@pytest.mark.parametrize("sigma,n", [(4, 1), (4, 8), (4, 1003), (16, 77),
                                     (17, 1003), (200, 4), (256, 4097)])
def test_text_words_equal_the_reference(sigma, n):
    text = np.random.default_rng(n).integers(0, sigma, n).astype(np.int32)
    words = _pack_text_words(text, sigma, "cpu")
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  R._pack_text_words(text, sigma))


def test_wrapper_takes_plain_on_cpu_and_refuses_other_devices():
    text, sigma = _text("sigma4", 500)
    state, _sa = _reference_state(text, sigma, 16)
    args = K.kasai_inputs_from_jax(*state)
    before = K.kasai_walk.launches
    taken = torch.zeros(len(args[4]), dtype=torch.int32)
    got = K.kasai_walk(*args, 500, 0, 4, taken=taken)
    assert K.kasai_walk.launches == before      # no kernel on the CPU
    # a commit step per position, and at least one more where l grows
    assert 500 < int(taken.sum()) < 4 * 500
    want = K.kasai_plain(*K.kasai_inputs_from_jax(*state), 500, 0, 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no Kasai kernel"):
        K.kasai_walk(*meta, 500, 0, 4)
    with pytest.raises(ValueError, match="bits"):
        K.kasai_plain(*args, 500, 0, 5)
