"""``engine=merge-legacy`` and ``BWTB3M_SORT=ls``, mapped onto the port.

The reference sends ``engine=merge-legacy`` to its round-1 engine (full
SA and ISA per block, no alphabet compaction); the port runs its scaled
merge engine.  On DNA, a periodic text, poly-A, bytes over 200 symbols
and UTF-8 over 300 and 5,000 code points, with ``bwtonly=1`` and ``=0``,
the port's ``.bwt .hist .preisa`` (and ``.sa .isa .hwt``) are the
reference's byte for byte and the ``.meta`` differs only in the names of
the files.  Texts whose rotations come in equal copies (powers of a
shorter string) get every file from their root, at every rate, from a
root of at most ``max_block_symbols`` or past it (k = 2, 3, 7; sigma 4
and 300 code points); ``<output>.stop`` stops the root's build.  Past
65,536 distinct symbols: ``tests/test_torch_merge_alphabet32.py``.

``BWTB3M_SORT=ls`` selects the reference's tie-compacted doubling; the
port runs its one doubling sort, whose SA, ranks and BWT equal the
reference's under ``ls`` on five texts.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.ops.doubling import suffix_array
from torch_parity import assert_same_files, build_both


def _utf8(rng, nsym, n, base):
    cps = rng.integers(base, base + nsym, n)
    cps[:nsym] = base + np.arange(nsym)
    rng.shuffle(cps)
    return "".join(map(chr, cps)).encode()


def _texts():
    rng = np.random.default_rng(11)
    dna = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    dna[3000:3400] = dna[1000:1400]                 # a repeat
    return {
        "dna": (dna.tobytes(), "bytestream"),
        "periodic": ((b"ACGTTG" * 600)[:3001], "bytestream"),
        "poly-A": (b"A" * 2000, "bytestream"),
        "bytes200": (rng.integers(30, 231, 5000).astype(np.uint8).tobytes(),
                     "bytestream"),
        "utf8-300": (_utf8(rng, 300, 4000, 0x100), "utf-8"),
        "utf8-5000": (_utf8(rng, 5000, 6000, 0x4E00), "utf-8"),
    }


TEXTS = _texts()


def _build_both(tmp_path, data, itype, mem=8192, **kw):
    inp = tmp_path / "t.in"
    inp.write_bytes(data)
    return build_both(tmp_path, inp, input_type=itype, engine="merge-legacy",
                      mem=mem, **kw)


@pytest.mark.parametrize("bwtonly", [1, 0])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_merge_legacy_writes_the_reference_files(tmp_path, name, bwtonly):
    data, itype = TEXTS[name]
    outs = _build_both(tmp_path, data, itype, bwt_only=bool(bwtonly))
    exts = (".bwt", ".hist", ".preisa")
    if not bwtonly:
        exts += (".sa", ".isa", ".hwt")
    assert_same_files(outs, exts)


@pytest.mark.parametrize("data,rate", [
    pytest.param(b"AA", 1, id="AA"), pytest.param(b"ACAC", 1, id="ACAC"),
    pytest.param(b"ACGTTG" * 4, 1, id="ACGTTG^4"),
    pytest.param(b"ACGTTG" * 300, 7, id="ACGTTG^300"),
    pytest.param(b"A" * 700, 32, id="A^700")])
def test_merge_legacy_equal_rotations(tmp_path, data, rate):
    """Equal rotations lie in position order in the legacy engine's .sa;
    the port writes every file from the sort of the text's root."""
    outs = _build_both(tmp_path, data, "bytestream", mem=1024,
                       bwt_only=False, sa_sampling_rate=rate,
                       isa_sampling_rate=rate)
    assert_same_files(outs, (".bwt", ".hist", ".preisa", ".sa", ".isa",
                              ".hwt"))


ROOT = np.random.default_rng(3).choice(np.frombuffer(b"ACGT", np.uint8),
                                       1500).tobytes()


def _power_texts():
    rng = np.random.default_rng(17)
    root305 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 305).tobytes()
    cjk = rng.integers(0, 300, 400)
    cjk[:300] = np.arange(300)
    root_utf8 = "".join(chr(0x4E00 + int(c)) for c in cjk).encode()
    return {
        "ROOT^2": (ROOT * 2, "bytestream", 1024),
        "ROOT^3": (ROOT * 3, "bytestream", 1024),
        "305^7": (root305 * 7, "bytestream", 256),
        "utf8-300^2": (root_utf8 * 2, "utf-8", 256),
    }


POWER_TEXTS = _power_texts()


@pytest.mark.parametrize("bwtonly", [0, 1])
@pytest.mark.parametrize("name", sorted(POWER_TEXTS))
def test_merge_legacy_root_past_one_block(tmp_path, name, bwtonly):
    """A power text whose root passes max_block_symbols: with bwtonly=0
    every file comes from a scaled-engine build of the root (its SA by
    the select visit, its ISA by the harvest visit); every file is the
    reference legacy engine's."""
    data, itype, mbs = POWER_TEXTS[name]
    outs = _build_both(tmp_path, data, itype, max_block_symbols=mbs,
                       bwt_only=bool(bwtonly))
    exts = (".bwt", ".hist", ".preisa")
    if not bwtonly:
        exts += (".sa", ".isa", ".hwt")
    assert_same_files(outs, exts)
    assert not list(tmp_path.glob("*_root*"))      # the root's files went


@pytest.mark.parametrize("p,k,srate,irate,hostmem", [
    pytest.param(1100, 3, 7, 10, None, id="p1100-k3-s7-i10"),
    pytest.param(1031, 2, 3, 7, None, id="p1031-k2-s3-i7"),
    pytest.param(1100, 2, 5, 4, 1024, id="p1100-k2-s5-i4-hostmem"),
    pytest.param(1031, 3, 3, 7, 1024, id="p1031-k3-s3-i7-hostmem-g1")])
def test_power_samples_past_one_block_equal_a_naive_sa(tmp_path, p, k, srate,
                                                       irate, hostmem):
    """The scaled route's .bwt, .preisa, .sa and .isa against a naive
    sort of the rotations of u^k, equal rotations in position order, at
    rates that are multiples of neither k nor p; with ``hostmem=`` the
    text is a memory map (the period is found chunk by chunk, the root
    is a view of the map), and at g = gcd(irate, prate, p) = 1 the
    harvest keeps ISA_u at every position on the device."""
    from oracle import naive_circular_sa

    from bwtb3m_tpu_torch.io.rl import rl_decode

    from bwtb3m_tpu_torch.io import formats
    root = np.random.default_rng(p).choice(np.frombuffer(b"ACGT", np.uint8),
                                           p)
    text = np.tile(root, k)
    inp = tmp_path / "t.in"
    inp.write_bytes(text.tobytes())
    res = compute_bwt(BwtOptions(
        input_path=str(inp), engine="merge-legacy", max_block_symbols=1024,
        sa_sampling_rate=srate, isa_sampling_rate=irate, host_mem=hostmem,
        verbose=0, device="cpu"))
    sa = naive_circular_sa(text)
    isa = np.empty_like(sa)
    isa[sa] = np.arange(len(sa))
    np.testing.assert_array_equal(rl_decode(res.bwt_path),
                                  text[(sa - 1) % len(text)])
    ranks, positions, _rate = res.load_preisa()
    np.testing.assert_array_equal(ranks, isa[positions])
    got_sa = formats.read_sampled_array(str(inp) + ".sa")
    got_isa = formats.read_sampled_array(str(inp) + ".isa")
    assert got_sa[0] == srate and got_isa[0] == irate
    np.testing.assert_array_equal(got_sa[1], sa[::srate])
    np.testing.assert_array_equal(got_isa[1], isa[::irate])


def _sort_texts():
    rng = np.random.default_rng(5)
    block = rng.integers(0, 4, 97)
    return {
        "dna": (rng.integers(0, 4, 5000), 4),
        "period-4": (np.tile([0, 1, 2, 3], 1250), 4),
        "poly-A": (np.zeros(3000, np.int64), 4),
        "30 copies of 97": (np.tile(block, 30), 4),
        "bytes200": (rng.integers(0, 200, 5000), 200),
    }


SORT_TEXTS = _sort_texts()


@pytest.mark.parametrize("name", sorted(SORT_TEXTS))
def test_sort_ls_equals_reference(monkeypatch, name):
    text, sigma = SORT_TEXTS[name]
    monkeypatch.setenv("BWTB3M_SORT", "ls")
    want = jax_suffix_array(text.astype(np.int32), sigma)
    got = suffix_array(text.astype(np.int32), sigma, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_power_root_build_stops_on_the_output_stop_file(tmp_path):
    """``<output>.stop`` stops the scaled build of a power text's root as
    it stops any merge build; the root's files are removed."""
    inp = tmp_path / "t.in"
    inp.write_bytes(ROOT * 2)
    out = str(tmp_path / "p.bwt")
    open(out + ".stop", "w").close()
    with pytest.raises(RuntimeError, match="stop requested"):
        compute_bwt(BwtOptions(
            input_path=str(inp), engine="merge-legacy", bwt_only=False,
            max_block_symbols=1024, output_filename=out,
            tmp_prefix=str(tmp_path / "tmp"), verbose=0, device="cpu"))
    assert not (tmp_path / "p.bwt").exists()
    assert not list(tmp_path.glob("*_root*"))
