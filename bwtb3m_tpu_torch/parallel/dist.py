"""Process groups: their bootstrap, host-sharded input and rank spawning.

Port of ``bwtb3m_tpu/parallel/dist.py``.  Every rank runs the same
program; the sharded engine's collectives (merge-split exchanges,
all_gathers of per-shard scalars, the merges' reductions) are its only
meeting points.

- ``initialize()`` joins torchrun's group from ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the counterpart of
  ``JAX_COORDINATOR_ADDRESS``); with none of them set it makes a group of
  one over a ``FileStore`` in a fresh temporary file.  Device and backend:
  ``mesh.py::choose_device``.  Every group gets an explicit timeout.
- ``run_ranks(fn, world, ...)`` (JAX needs no counterpart, having one
  controller) starts ``world`` processes by the ``spawn`` method over a
  ``FileStore``, runs ``fn(mesh, *args)`` in each and returns their
  results in rank order.  ``fn`` must live in this package: a child
  imports the module that holds it, and nothing here imports JAX.  The
  processes are joined by a deadline; if any rank fails or the deadline
  passes, every rank is killed and the call raises.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as _mesh
from .mesh import Mesh, choose_device, make_mesh

TIMEOUT = 300.0          # seconds: every group's collectives, every spawn
_STORE_DIRS: list = []   # temporary directories of groups of one made here
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize(device="cuda", timeout: float = TIMEOUT, log=None, *,
               rank: Optional[int] = None, world: Optional[int] = None,
               store_path: Optional[str] = None) -> Mesh:
    """This process's mesh, joining or making its group first.

    An existing group is kept.  Otherwise: ``rank``/``world``/
    ``store_path`` given (``run_ranks``'s children) join a group over
    that file; torchrun's variables join theirs; with neither, a group of
    one over a new temporary file.  ``log`` (a ``VerboseLog``) gets the
    device and backend chosen, once, at ``-v``."""
    if dist.is_initialized():
        return make_mesh()
    if store_path is None and ("RANK" in os.environ
                               or "WORLD_SIZE" in os.environ):
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError("torchrun variables missing: %s"
                               % " ".join(missing))
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init = dict(init_method="env://")
    else:
        if store_path is None:
            _STORE_DIRS.append(tempfile.mkdtemp(prefix="bwtb3m_pg_"))
            store_path = os.path.join(_STORE_DIRS[-1], "store")
            rank, world = 0, 1
        local_rank, local_world = rank, world
        init = dict(store=dist.FileStore(store_path, world))
    dev, backend = choose_device(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            **init)
    _mesh._CHOSEN[:] = [(dev, backend)]
    if log is not None:
        log.v("rank %d of %d: %s over %s (%d local ranks, %d cards)"
              % (rank, world, dev, backend, local_world,
                 torch.cuda.device_count() if dev.type == "cuda" else 0))
    return make_mesh()


def shutdown() -> None:
    """Leave the group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh._CHOSEN.clear()
    while _STORE_DIRS:
        shutil.rmtree(_STORE_DIRS.pop(), ignore_errors=True)


@contextlib.contextmanager
def session(device="cuda", timeout: float = TIMEOUT, log=None):
    """``initialize()``'s mesh for a block; a group made here is left at
    its end, one that existed before is kept."""
    made = not dist.is_initialized()
    mesh = initialize(device, timeout, log)
    try:
        yield mesh
    finally:
        if made:
            shutdown()


def global_mesh() -> Mesh:
    """The mesh over every rank of the group."""
    return make_mesh()


def host_local_slice(n: int, mesh: Optional[Mesh] = None) -> slice:
    """The text slice this rank should load: equal contiguous shards by
    rank (n must divide evenly across the ranks)."""
    mesh = mesh or make_mesh()
    if n % mesh.world:
        raise ValueError("n=%d not divisible by %d ranks" % (n, mesh.world))
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def local_text_shard(local_text, n: int, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the n-symbol text, from the host symbols it
    loaded (``host_local_slice``), as an int32 tensor on its device: the
    counterpart of the reference's ``make_global_text_array``, whose
    global array is here the ranks' shards taken together."""
    local_text = np.asarray(local_text, dtype=np.int32)
    if len(local_text) * mesh.world != n:
        raise ValueError("a shard of %d symbols does not make n=%d over %d "
                         "ranks" % (len(local_text), n, mesh.world))
    return torch.from_numpy(local_text).to(mesh.device)


# ------------------------------------------------------------ spawning

def _rank_main(fn, rank, world, store_path, device, timeout, threads, args,
               out):
    """A child of ``run_ranks``: join the group, run ``fn``, leave its
    result (or its traceback) in ``out``."""
    try:
        torch.set_num_threads(threads)
        mesh = initialize(device, timeout, rank=rank, world=world,
                          store_path=store_path)
        try:
            result = fn(mesh, *args)
        finally:
            shutdown()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(out + ".tmp", out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, args=(), device="cuda",
              timeout: float = TIMEOUT) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks (module
    docstring); returns each rank's result, in rank order.  Each rank
    takes its share of the caller's intra-op threads (at least one):
    ranks whose thread pools together outnumber the cores spin against
    each other, 20x slower on the CPU.  Raises ``RuntimeError``
    when a rank fails and ``TimeoutError`` when ``timeout`` seconds pass
    first; every rank is gone by then."""
    import multiprocessing as mp

    if not fn.__module__.startswith(__package__.split(".")[0] + "."):
        raise ValueError("run_ranks runs functions of %s only, not %s.%s"
                         % (__package__.split(".")[0], fn.__module__,
                            fn.__qualname__))
    tmp = tempfile.mkdtemp(prefix="bwtb3m_ranks_")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, "rank%d" % r) for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, store, str(device), timeout,
        max(1, torch.get_num_threads() // world), tuple(args), outs[r]))
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                err = ""
                if os.path.exists(outs[r] + ".err"):
                    err = open(outs[r] + ".err").read()
                raise RuntimeError("rank %d of %d exited with code %d\n%s"
                                   % (r, world, codes[r], err))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError("ranks %s of %d still running after %.0f s"
                                   % ([r for r, c in enumerate(codes)
                                       if c is None], world, timeout))
            time.sleep(0.02)
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
