"""The mesh of a process group: one process per rank.

Port of ``bwtb3m_tpu/parallel/mesh.py``.  JAX drives every device of a
mesh from one process (``shard_map``); here every rank is a process of
its own (``torch.distributed``), runs the same program and meets the
others only at collectives.  ``Mesh`` names this rank's place in the
group: its rank, the world size, its ``torch.device``, the backend and
the process group.  Where the JAX code says ``mesh.devices.size``, this
says ``mesh.world``.

The device and the backend (``choose_device``):

- on the CPU the backend is gloo;
- on cards, a rank's device is ``cuda:LOCAL_RANK`` while there is a card
  for every local rank, and the backend is NCCL;
- where local ranks outnumber the cards, ranks share the cards
  (``cuda:LOCAL_RANK % cards``) and the backend is gloo.  NCCL refuses two
  ranks on one card, and gloo's own CUDA support is not relied on: the
  collectives below stage card tensors through the host explicitly.

Nothing falls back: an NCCL error is raised, never retried on gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# what dist.initialize() chose for this process: (device, backend)
_CHOSEN: list = []


@dataclasses.dataclass
class Mesh:
    rank: int
    world: int
    device: torch.device
    backend: str                      # "nccl" or "gloo"
    group: Optional[object] = None    # None: the default group

    @property
    def staged(self) -> bool:
        """Whether collectives go through host copies (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def choose_device(device, local_rank: int, local_world: int
                  ) -> Tuple[torch.device, str]:
    """(device, backend) of a rank (module docstring).  Asking for CUDA
    where ``torch.cuda.is_available()`` is False raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError("unsupported device %r (use cuda or cpu)" % device)
    if not torch.cuda.is_available():
        raise RuntimeError("device=%s requested but torch.cuda.is_available() "
                           "is False; pass device=cpu to run on the CPU"
                           % device)
    cards = torch.cuda.device_count()
    if local_world == 1 and dev.index is not None:
        return dev, "nccl"
    if local_world <= cards:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % cards), "gloo"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the current process group (``parallel/dist.py::
    initialize`` makes one; so do torchrun callers of
    ``init_process_group``).  ``n_devices``, when given, must equal the
    world size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.dist.initialize() "
                           "(torchrun or a group of one) or run_ranks()")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError("requested %d devices, the group has %d ranks"
                         % (n_devices, world))
    if _CHOSEN:
        device, backend = _CHOSEN[0]
    else:                             # a group its caller made itself
        backend = dist.get_backend()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(dist.get_rank(), world, device, backend)


def shard_1d(mesh: Mesh, x) -> torch.Tensor:
    """This rank's contiguous slice of a host array (``len(x)`` divisible
    by the world size), on its device."""
    x = np.asarray(x)
    if len(x) % mesh.world:
        raise ValueError("length %d is not divisible by %d ranks"
                         % (len(x), mesh.world))
    k = len(x) // mesh.world
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.rank * k:(mesh.rank + 1) * k])).to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole host array on this rank's device."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


# ------------------------------------------------------------ collectives
# On a staged mesh (gloo on a card) each call copies to the host, runs the
# collective there and copies back.  A group of one runs them too: on a
# card that is NCCL's own path.

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over the ranks, on ``t``'s device: ``t``
    itself, reduced in place, unless the mesh is staged."""
    h = _host(mesh, t).contiguous()
    dist.all_reduce(h, op=_OPS[op], group=mesh.group)
    return h.to(t.device) if mesh.staged else h


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (of one shape on all ranks), stacked in rank
    order: ``[world, *t.shape]`` on ``t``'s device."""
    h = _host(mesh, t).contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((mesh.world,) + tuple(h.shape), dtype=h.dtype,
                          device=h.device)
        dist.all_gather_into_tensor(out, h, group=mesh.group)
        return out
    parts = [torch.empty_like(h) for _ in range(mesh.world)]
    dist.all_gather(parts, h, group=mesh.group)
    return torch.stack(parts).to(t.device)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (same shape and dtype)."""
    h = _host(mesh, t).contiguous()
    dist.broadcast(h, src, group=mesh.group)
    return h.to(t.device) if mesh.staged else h


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank: a decision every rank takes
    alike (a branch some ranks take alone deadlocks the others)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                     device=mesh.device)
    return bool(all_reduce(mesh, t, "max").item())
