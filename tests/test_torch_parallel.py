"""The port's sharded suffix sort against the reference's, rank by rank.

``bwtb3m_tpu_torch.parallel`` runs one process per rank: here 2, 3 and 4
gloo processes on the CPU, started by ``run_ranks`` (each world size
once, every case of it in that one spawn, under a deadline).  The
reference runs on the conftest's virtual CPU mesh as ``make_mesh(D)``
with the same D.  Cases: ``tests/test_parallel.py``'s (n, sigma) grid,
its tiny and periodic texts and its indivisible length, and the ragged
lengths 77, 1,003 and 4,097; SA, ranks and BWT are compared exactly.  At
D = 3 the reference's kernel asserts on two of them, n = 64 over two
symbols (its pad of 23 slots is narrower than the 29-symbol key it packs)
and the periodic text of 32; the port widens the pad there, and those
cases are held to the reference's single-device sort and the rotations'
dense ranks.  ``compute_bwt(engine="sharded")`` in a group of one
in this process and on two ranks writes the reference's
``engine=sharded`` files byte for byte.  Also: the local multi-key order,
the slot plan, the device choice, the mesh helpers and ``run_ranks``'s
refusals and deadline.
"""

import functools
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
# the ranks share this process's intra-op threads: one each, or several
# xdist workers' ranks spin against each other
torch.set_num_threads(1)

from bwtb3m_tpu.engine import BwtOptions as JaxOptions
from bwtb3m_tpu.engine import compute_bwt as jax_compute_bwt
from bwtb3m_tpu.ops.doubling import suffix_array as jax_suffix_array
from bwtb3m_tpu.parallel import make_mesh as jax_make_mesh
from bwtb3m_tpu.parallel import sharded_bwt as jax_sharded_bwt
from bwtb3m_tpu_torch.engine import BwtOptions, compute_bwt
from bwtb3m_tpu_torch.parallel import dist, dryrun, make_mesh, mesh as pm
from bwtb3m_tpu_torch.parallel.blocksort import local_order
from bwtb3m_tpu_torch.parallel.doubling import _slots_per_rank
from oracle import naive_bwt, naive_circular_sa, random_string

DEADLINE = 120.0


def _cases():
    cases = {}
    for n, sigma in [(64, 2), (256, 4), (1024, 4), (2048, 16), (4096, 256)]:
        cases["n%d_s%d" % (n, sigma)] = (random_string(n, sigma,
                                                       seed=n + sigma), sigma)
    cases["tiny"] = (np.array([ord(c) for c in
                               "abracadabra_abracadabra_abracadr"],
                              np.int32), 256)
    cases["periodic"] = (np.tile(np.array([0, 1], np.int32), 16), 2)
    cases["indivisible"] = (random_string(100, 4, 0), 4)
    rng = np.random.default_rng(3)
    for n in (1003, 4097, 77):
        cases["ragged%d" % n] = (rng.integers(0, 4, n, dtype=np.int32), 4)
    return cases


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _port(D):
    """Every case on D ranks, one spawn: {name: (sa, rank, bwt)}."""
    names = list(CASES)
    out = dist.run_ranks(dryrun.sharded_bwt_cases, D,
                         ([CASES[k] for k in names],), device="cpu",
                         timeout=DEADLINE)
    for mods in out[1:]:
        assert mods == [], mods       # the other ranks' imported modules
    return dict(zip(names, out[0]))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("D", [2, 3, 4])
def test_sharded_bwt_matches_reference(D, name):
    text, sigma = CASES[name]
    sa, rank, bwt = _port(D)[name]
    assert sa.dtype == np.int64 and rank.dtype == np.int64
    assert bwt.dtype == np.int32
    try:
        want = jax_sharded_bwt(text, sigma, jax_make_mesh(D))
    except AssertionError:
        # the reference's pad check fails (module docstring): its
        # single-device sort, and the rotations' dense ranks
        assert (D, name) in ((3, "n64_s2"), (3, "periodic"))
        sa1, _isa, bwt1 = jax_suffix_array(text, sigma)
        rots = [tuple(np.roll(text, -i)) for i in range(len(text))]
        dense = {r: k for k, r in enumerate(sorted(set(rots)))}
        want = (np.asarray(sa1), np.array([dense[r] for r in rots]),
                np.asarray(bwt1))
    for got, ref in zip((sa, rank, bwt), want):
        np.testing.assert_array_equal(got, np.asarray(ref))
    sa1, _isa, bwt1 = jax_suffix_array(text, sigma)
    np.testing.assert_array_equal(sa, np.asarray(sa1))
    np.testing.assert_array_equal(bwt, np.asarray(bwt1))
    if name in ("tiny", "periodic"):
        np.testing.assert_array_equal(sa, naive_circular_sa(text))
        np.testing.assert_array_equal(bwt, naive_bwt(text))
    if name != "periodic":
        np.testing.assert_array_equal(rank[sa], np.arange(len(text)))


def _sharded_files(tmp_path, out_dir):
    data = bytes((random_string(2048, 4, seed=3) + 97).astype(np.uint8))
    inp = tmp_path / "sh.bin"
    inp.write_bytes(data)
    (tmp_path / out_dir).mkdir()
    return dict(input_path=str(inp), engine="sharded",
                preisa_sampling_rate=256, sa_sampling_rate=8,
                isa_sampling_rate=16, verbose=0,
                output_filename=str(tmp_path / out_dir / "sh.bwt"))


def _assert_files_equal(meta, tmp_path, kw):
    ref = dict(kw, output_filename=str(tmp_path / "jax" / "sh.bwt"))
    (tmp_path / "jax").mkdir()
    jax_compute_bwt(JaxOptions(**ref))
    ref_meta = json.load(open(str(tmp_path / "jax" / "sh.meta")))
    assert sorted(meta["files"]) == sorted(ref_meta["files"]) == [
        "bwt", "hist", "hwt", "isa", "preisa", "sa"]
    for key, path in meta["files"].items():
        assert open(path, "rb").read() == \
            open(ref_meta["files"][key], "rb").read(), key
    strip = {"files", "input"}
    assert ({k: v for k, v in meta.items() if k not in strip}
            == {k: v for k, v in ref_meta.items() if k not in strip})


def test_engine_sharded_group_of_one_matches_reference(tmp_path):
    """A group of one made and left by ``compute_bwt`` in this process."""
    kw = _sharded_files(tmp_path, "port")
    res = compute_bwt(BwtOptions(device="cpu", **kw))
    assert not torch.distributed.is_initialized()
    _assert_files_equal(res.meta, tmp_path, kw)


def test_engine_sharded_on_two_ranks_matches_reference(tmp_path):
    """Two ranks: rank 0 writes the files, rank 1 returns a result
    without files; neither imports JAX."""
    kw = _sharded_files(tmp_path, "port")
    (meta0, mods0), (meta1, mods1) = dist.run_ranks(
        dryrun.compute_bwt_job, 2, (dict(kw, device="cpu"),),
        device="cpu", timeout=DEADLINE)
    assert mods0 == mods1 == []
    assert meta1["files"] == {} and meta1["n"] == meta0["n"]
    _assert_files_equal(meta0, tmp_path, kw)


def test_local_order_is_lexicographic():
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, 3, 5000), rng.integers(0, 1 << 32, 5000) & ~1,
            rng.permutation(5000)]
    cols[1][:100] = 0xFFFFFFFF
    cols[0][:50] = 0xFFFFFFFF
    t = [torch.from_numpy(c.astype(np.int64)) for c in cols]
    for k in (1, 2, 3):
        order = local_order(t[:k]).numpy()
        want = np.lexsort(tuple(reversed(cols[:k])))
        keys = np.stack(cols[:k], 1)
        np.testing.assert_array_equal(keys[order], keys[want])
    np.testing.assert_array_equal(local_order(t).numpy(),
                                  np.lexsort(tuple(reversed(cols))))


@pytest.mark.parametrize("n,D,sigma", [(77, 4, 4), (1003, 3, 4),
                                       (4097, 8, 4), (100, 8, 256),
                                       (525, 2, 4), (64, 3, 2), (7, 4, 2)])
def test_slot_plan_keeps_the_pad_as_wide_as_the_key(n, D, sigma):
    """K is the reference's where its pad covers the packed key, and
    grows only where it would not."""
    from bwtb3m_tpu.ops.doubling import _pack_width
    K = _slots_per_rank(n, D, sigma)
    pad = D * K - n
    assert pad >= min(_pack_width(sigma), K) and pad >= 0
    w = min(_pack_width(sigma), (n + D - 1) // D)
    K_ref = -(-(n + w) // D)
    if D * K_ref - n >= min(_pack_width(sigma), K_ref):
        assert K == K_ref
    else:
        assert (n, D) in ((64, 3), (7, 4))


def test_mesh_of_a_group_of_one():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    with dist.session("cpu") as mesh:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        assert make_mesh(1).world == 1
        with pytest.raises(ValueError, match="requested 2 devices"):
            make_mesh(2)
        x = np.arange(12)
        np.testing.assert_array_equal(pm.shard_1d(mesh, x).numpy(), x)
        np.testing.assert_array_equal(pm.replicated(mesh, x).numpy(), x)
        assert dist.host_local_slice(12, mesh) == slice(0, 12)
        assert dist.local_text_shard(x, 12, mesh).dtype == torch.int32
        t = torch.arange(5)
        assert torch.equal(pm.all_reduce(mesh, t.clone(), "max"), t)
        assert torch.equal(pm.all_gather(mesh, t), t[None])
        assert torch.equal(pm.broadcast(mesh, t.clone(), 0), t)
        assert pm.any_rank(mesh, True) and not pm.any_rank(mesh, False)
    assert not torch.distributed.is_initialized()


def test_device_choice(monkeypatch):
    assert pm.choose_device("cpu", 3, 4) == (torch.device("cpu"), "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cuda"):
        pm.choose_device("cuda", 0, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    # a card per local rank: NCCL; more local ranks than cards: shared
    # cards over gloo
    assert pm.choose_device("cuda", 1, 2) == (torch.device("cuda", 1),
                                              "nccl")
    assert pm.choose_device("cuda", 2, 3) == (torch.device("cuda", 0),
                                              "gloo")
    assert pm.choose_device("cuda:1", 0, 1) == (torch.device("cuda", 1),
                                                "nccl")


def test_run_ranks_refusals_and_deadline():
    with pytest.raises(ValueError, match="functions of bwtb3m_tpu_torch"):
        dist.run_ranks(np.sum, 2, device="cpu")
    # a rank that fails fails the call, with its traceback
    with pytest.raises(RuntimeError, match="exited with code"):
        dist.run_ranks(dryrun.sharded_bwt_cases, 2, ([("x", 4)],),
                       device="cpu", timeout=DEADLINE)
    # a deadline shorter than the ranks' start: every rank is killed
    with pytest.raises(TimeoutError, match="still running"):
        dist.run_ranks(dryrun.sharded_bwt_cases, 2, ([],), device="cpu",
                       timeout=0.5)
