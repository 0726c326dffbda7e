"""The traffic generators: one text and one set of reads per seed, the
repeat shares the configuration states, both strands, and a ``.pac``
that the program's ``pacterm`` reader reads back."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from conftest import small_config
from portbench.traffic import genome, reads


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


@pytest.mark.parametrize("name", ["grch38-bwa-bounded", "grch38-chr21-bwa"])
def test_one_text_per_seed(name):
    g = small_config(name, 50000)["genome"]
    a, _ = genome.forward_strand(g, 2 ** 31 + 99)
    b, _ = genome.forward_strand(g, 2 ** 31 + 99)
    c, _ = genome.forward_strand(g, 2 ** 31 + 100)
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)
    assert len(a) == len(c) == 50000
    assert a.dtype == np.uint8 and int(a.max()) <= 3


def test_repeat_shares_within_their_bounds():
    g = small_config("grch38-bwa-bounded", 400000)["genome"]
    fwd, shares = genome.forward_strand(g, 12345)
    n = g["forward_bases"]
    assert sum(shares.values()) == n
    for key in ("alu", "l1", "sd"):
        # whole copies: a share is met to within one copy
        most = g[key].get("consensus_bases", max(g[key].get("copy_bases",
                                                            [0, 0])))
        assert abs(shares[key] - g[key]["share"] * n) <= most, key
    gc = np.isin(fwd, (1, 2)).mean()
    assert abs(gc - g["gc"]) < 0.01


def test_both_strands_and_pac_round_trip(tmp_path):
    from bwtb3m_tpu_torch.io.inputtypes import parse_input_type
    g = small_config("grch38-chr21-bwa", 10001)["genome"]
    pac = str(tmp_path / "g.pac")
    fwd = genome.write_pac(pac, g, 7)
    both = genome.both_strands(fwd)
    assert np.array_equal(both[len(fwd):], 3 - fwd[::-1])
    symbols, sigma = parse_input_type("pacterm").load(pac)
    assert sigma == 5
    assert np.array_equal(np.asarray(symbols), genome.pacterm_symbols(fwd))


@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_pac_tail_bytes(n):
    raw = genome.pack_pac(np.arange(n, dtype=np.uint8) % 4)
    assert raw[-1] == n % 4
    assert len(raw) == (n + 3) // 4 + 1 + (n % 4 == 0)


def test_reads_one_set_per_seed_and_call():
    g = small_config("grch38-chr21-bwa", 20000)["genome"]
    fwd, _ = genome.forward_strand(g, 3)
    t = {"reads_per_call": 200, "read_bases": 100, "substitution": 0.005}
    n1, r1 = reads.sample_reads(fwd, t, 5, 0)
    n2, r2 = reads.sample_reads(fwd, t, 5, 0)
    _n3, r3 = reads.sample_reads(fwd, t, 5, 1)
    assert n1 == n2 and np.array_equal(r1, r2)
    assert not np.array_equal(r1, r3)
    assert r1.shape == (200, 100) and int(r1.max()) <= 3
    fa = reads.fasta_bytes(n1, r1).decode()
    assert fa.startswith(">c0_r0\n") and fa.count("\n") == 400
