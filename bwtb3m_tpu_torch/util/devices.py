"""Device selection: one explicit ``torch.device`` per run.

The reference package moved small inputs to the CPU backend to avoid
compile time (``bwtb3m_tpu/util/devices.py``).  The port has no compile
step per shape, so it keeps no size threshold and no fallback: the device
a user names is the device that runs, and asking for CUDA on a machine
without it is an error.

``device_budget`` is the one place that says how many bytes of device
memory a step may plan with; the merge engine's gates read it
(``engine/merge_scaled.py``).
"""

from __future__ import annotations

import torch

from .. import native


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False, or the native host library
    (``native/``) cannot be built: its numpy stand-ins are for CPU runs."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=%s requested but torch.cuda.is_available() is "
                "False; pass device=cpu to run on the CPU" % name)
        native.require_lib()
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError("unsupported device %r (use cuda or cpu)" % name)


CPU_BUDGET = 16 << 30     # what a CPU run plans with; callers may pass theirs


def device_budget(device, cpu_budget: int = CPU_BUDGET) -> int:
    """Bytes of memory on ``device`` that new tensors can take now.  On a
    card: what ``torch.cuda.mem_get_info`` reports free, plus what
    PyTorch's allocator holds reserved but unallocated (it reuses that
    before it asks CUDA for more).  On the CPU: ``cpu_budget``."""
    device = torch.device(device)
    if device.type != "cuda":
        return int(cpu_budget)
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached)
