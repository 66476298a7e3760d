"""Process setup: the port's counterpart of ``distributed_lion_tpu/parallel/mesh.py``.

The JAX package builds a device mesh whose ``data`` axis is the vote axis.
Here the vote axis is the ``torch.distributed`` world, one process per GPU:

- under ``torchrun`` (``WORLD_SIZE`` set) :func:`init_distributed` starts
  NCCL on CUDA, or gloo when ``DLION_PLATFORM=cpu`` asks for the CPU;
- a process group the caller already started is used as it is;
- otherwise the run is a world of one, with no process group.

:func:`resolve_device` is the one place the port decides where to run:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when CUDA is missing.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def platform_device() -> torch.device:
    """The CLI's device: the CPU when ``DLION_PLATFORM=cpu`` (the JAX
    package's own knob), else the CUDA device of this rank."""
    plat = os.environ.get("DLION_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat:
        raise ValueError(
            f"DLION_PLATFORM={plat!r}: the port knows only 'cpu' (unset = "
            "the GPU); run several CPU ranks under torchrun instead of cpu8")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return resolve_device(f"cuda:{local}" if "LOCAL_RANK" in os.environ else "cuda")


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA (the
    default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless asked "
            "for the CPU (device='cpu', or DLION_PLATFORM=cpu for the CLI)")
    return dev


def init_distributed(device: torch.device) -> Optional[dist.ProcessGroup]:
    """The vote's process group: an already started one, a new one under
    torchrun, or None for a world of one."""
    if dist.is_initialized():
        return dist.group.WORLD
    if "WORLD_SIZE" not in os.environ:
        return None
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo")
    return dist.group.WORLD


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)
