"""The Kasai walk's plain version (``ops/kasai.py::kasai_plain``, what the
wrapper runs on CPU tensors and what the CUDA kernel is held to on the
card) against the reference's ``_kasai_chunk2_impl``, state carried over
by ``kasai_inputs_from_jax`` (the port takes p0 = SA[0] where the
reference takes ISA): after 1, 7 and 2,048 steps, then resumed to the
end, on nibble windows (sigma 4) and byte windows (sigma 200), texts
whose length is no multiple of a window, a text of one symbol (l reaches
n), a slab that starts past 0, more lanes than positions and lanes that
are done at the start; and on ragged lanes (bounds off multiples of 8,
lanes shorter than 8 positions, p0 inside a lane and at a lane's edge),
10,000-symbol repeats and windows that wrap past n.  The text words
against the reference's word for word.  Exact equality."""

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


def _reference_state(text, sigma, lanes, a=0, b=None, bounds=None):
    """The reference's arrays for the slab [a, b), as its device and slab
    paths set them up (its own words, Phi with rank 0 at 0, a drop slot
    after the slab's PLCP), lanes cut as ``np.linspace`` cuts them unless
    ``bounds`` gives the cuts."""
    n = len(text)
    b = n if b is None else b
    sa, isa, _bwt = ref_suffix_array(text, sigma)
    sa, isa = np.asarray(sa, np.int64), np.asarray(isa, np.int64)
    phi = np.zeros(n, np.uint32)
    phi[sa[1:]] = sa[:-1]
    if bounds is None:
        bounds = np.linspace(a, b, min(lanes, b - a) + 1).astype(np.int64)
    state = (R._pack_text_words(text, sigma), phi[a:b],
             isa[a:b].astype(np.uint32), np.zeros(b - a + 1, np.uint32),
             bounds[:-1].astype(np.uint32), np.zeros(len(bounds) - 1,
                                                     np.uint32),
             bounds[1:].astype(np.uint32))
    return state, sa


def _port(state, sa):
    """The port's arguments for the reference's state: p0 = SA[0] from
    the same SA in place of the reference's ISA."""
    return K.kasai_inputs_from_jax(state[0], state[1], int(sa[0]),
                                   *state[3:])


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
        port = K.kasai_plain(*_port(state, sa), n, a, bits, steps=steps)
        _assert_state(port, _ref_steps(state, steps, bits, n, a), b - a)
    # both resume from the 2,048-step state and run to the end
    mid = _ref_steps(state, 2048, bits, n, a)
    if kind == "repeats":
        assert (mid[1] < state[6]).all()
    ref_end = _ref_to_end(state[:3] + mid + state[6:], bits, n, a)
    words, phi, p0, _plcp, _p, _l, pend = _port(state, sa)
    plcp, p, l = port
    port_end = K.kasai_walk(words, phi, p0, plcp, p, l, pend, n, a, bits)
    _assert_state(port_end, ref_end, b - a)
    assert bool((port_end[1] == pend).all())
    want = R.kasai_plcp(text, sa)[a:b]
    np.testing.assert_array_equal(port_end[0][:b - a].numpy(), want)
    if kind == "ones":
        assert int(port_end[0].max()) == n


def test_lanes_done_at_the_start():
    """A lane with p == pend takes no step and writes nothing, in both."""
    text, sigma = _text("sigma4", 1000)
    state, sa = _reference_state(text, sigma, 10)
    words, phi, isa, plcp, p, l, pend = state
    p = p.copy()
    p[3] = pend[3]              # lane 3 is done
    pend = pend.copy()
    pend[7] = p[7]              # lane 7 owns nothing
    state = (words, phi, isa, plcp, p, l, pend)
    for steps in (5, 300):
        port = K.kasai_plain(*_port(state, sa), 1000, 0, 4, steps=steps)
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
    state, sa = _reference_state(text, sigma, 16)
    args = _port(state, sa)
    before = K.kasai_walk.launches
    taken = torch.zeros(len(args[4]), dtype=torch.int32)
    got = K.kasai_walk(*args, 500, 0, 4, taken=taken)
    assert K.kasai_walk.launches == before      # no kernel on the CPU
    # a commit step per position, and at least one more where l grows
    assert 500 < int(taken.sum()) < 4 * 500
    want = K.kasai_plain(*_port(state, sa), 500, 0, 4)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t
            for t in args]
    with pytest.raises(ValueError, match="no Kasai kernel"):
        K.kasai_walk(*meta, 500, 0, 4)
    with pytest.raises(ValueError, match="bits"):
        K.kasai_plain(*args, 500, 0, 5)


def _ragged_bounds(n, p0, where, seed):
    """Lane cuts over [0, n) off multiples of 8, with lanes of 1-7
    positions among them, and p0 strictly inside a lane ("inside") or
    starting one ("edge", followed by a lane of one position)."""
    rng = np.random.default_rng(seed)
    cuts = set(rng.choice(np.arange(1, n), 40, replace=False).tolist())
    for c in rng.choice(np.arange(8, n - 16), 6, replace=False):
        cuts.update(int(c) + d for d in (0, 1, 3, 10))     # lanes of 1, 2, 7
    cuts = {c for c in cuts if 0 < c < n and c % 8}
    if where == "inside":
        cuts -= set(range(p0 - 3, p0 + 4))
    else:
        cuts.update({p0, p0 + 1} & set(range(1, n)))
    bounds = np.array(sorted(cuts | {0, n}), np.int64)
    assert (np.diff(bounds) < 8).any() and (np.diff(bounds) > 8).any()
    return bounds


def _wrapping_text(n, seed):
    """Random DNA codes whose last 600 symbols repeat its first 600: the
    rotation at n - 600 shares more than 600 symbols with the rotation at
    0, so its window runs across n."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n).astype(np.int32)
    text[n - 600:] = text[:600]
    return text


def _repeats_text(n, seed, length=10_000):
    """Random DNA codes with two more copies of a 10,000-symbol segment."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, n).astype(np.int32)
    for dst in (12_000, 23_000):
        text[dst:dst + length] = text[500:500 + length]
    return text


@pytest.mark.parametrize("kind,where", [
    ("sigma4", "inside"), ("sigma4", "edge"), ("sigma200", "inside"),
    ("sigma200", "edge"), ("repeats10k", "inside"), ("wrap", "edge")])
def test_plain_with_p0_matches_reference_on_ragged_lanes(kind, where):
    """p0 in place of ISA, step for step against the reference on lanes
    whose bounds are no multiples of 8, lanes shorter than 8 positions,
    p0 inside a lane or at a lane's edge, 10,000-symbol repeats (lanes
    that extend for 1,250 steps) and a window that wraps past n."""
    if kind == "repeats10k":
        text, sigma = _repeats_text(36_011, 3), 4
    elif kind == "wrap":
        text, sigma = _wrapping_text(5_003, 4), 4
    else:
        text, sigma = _text(kind, 2_999 if kind == "sigma4" else 3_001)
    n = len(text)
    bits = 4 if sigma <= 16 else 8
    sa = np.asarray(ref_suffix_array(text, sigma)[0], np.int64)
    bounds = _ragged_bounds(n, int(sa[0]), where, n)
    state, sa = _reference_state(text, sigma, 0, bounds=bounds)
    lane_of_p0 = np.searchsorted(bounds, sa[0], side="right") - 1
    assert (bounds[lane_of_p0] == sa[0]) == (where == "edge")
    for steps in (1, 7, 2048):
        port = K.kasai_plain(*_port(state, sa), n, 0, bits, steps=steps)
        _assert_state(port, _ref_steps(state, steps, bits, n, 0), n)
    mid = _ref_steps(state, 2048, bits, n, 0)
    ref_end = _ref_to_end(state[:3] + mid + state[6:], bits, n, 0)
    words, phi, p0, _plcp, _p, _l, pend = _port(state, sa)
    plcp, p, l = port
    port_end = K.kasai_plain(words, phi, p0, plcp, p, l, pend, n, 0, bits)
    _assert_state(port_end, ref_end, n)
    want = R.kasai_plcp(text, sa)
    np.testing.assert_array_equal(port_end[0][:n].numpy(), want)
    if kind == "repeats10k":
        assert int(want.max()) >= 10_000
    if kind == "wrap":
        assert int((np.arange(n) + want).max()) > n
