"""Multi-process start-up: one process a card, joined by ``torch.distributed``.

Counterpart of ``ovmr_tpu/parallel/multihost.py``. A TPU pod runs one
process a host and one global program; here every card is a rank of one
process group, and the mesh of :mod:`ovmr_tpu_torch.parallel.mesh` lays
the ranks out as ``data x model``. Activation, before anything touches a
card:

- ``OVMR_COORDINATOR=host:port`` + ``OVMR_NUM_PROCESSES`` +
  ``OVMR_PROCESS_ID``: an explicit rendezvous,
  ``init_process_group(init_method="tcp://host:port")`` (a coordinator
  given as a URL, such as ``file:///shared/rendezvous``, is taken as it is);
- ``OVMR_MULTIHOST=1``: ``init_method="env://"``, the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``).

The backend is NCCL when the trainer runs on a card, gloo on the CPU. On a
card the process is first bound to ``cuda:{LOCAL_RANK}`` (``torchrun``
sets it; without it the process id modulo the visible cards). Every rank
holds the same host values (loaders seeded by ``cfg.SEED``, parameters by
the same seed), so nothing above the mesh changes.
"""

from __future__ import annotations

import os


def maybe_initialize_distributed(device="cuda") -> bool:
    """Initialise the default process group from the ``OVMR_*`` variables
    for a trainer on ``device``; True when it did. A no-op (False) without
    the variables, or when a group already exists."""
    import torch
    import torch.distributed as dist

    coord = os.environ.get("OVMR_COORDINATOR")
    if dist.is_initialized() or not (coord or os.environ.get("OVMR_MULTIHOST") == "1"):
        return False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = int(os.environ.get("OVMR_PROCESS_ID", os.environ.get("RANK", "0")))
            local %= max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(int(local))
    backend = "nccl" if on_card else "gloo"
    if coord:
        dist.init_process_group(
            backend, init_method=coord if "://" in coord else f"tcp://{coord}",
            world_size=int(os.environ["OVMR_NUM_PROCESSES"]),
            rank=int(os.environ["OVMR_PROCESS_ID"]),
        )
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def world() -> int:
    """The default group's size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes logs, checkpoints and CSVs."""
    return rank() == 0


def barrier() -> None:
    """Every rank of the default group waits for the others (a no-op
    without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
