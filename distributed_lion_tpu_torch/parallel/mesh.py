"""Process setup: the port's counterpart of ``distributed_lion_tpu/parallel/mesh.py``.

The JAX package builds a device mesh whose ``data`` axis is the vote axis.
Here the vote axis is the ``torch.distributed`` world, one process per GPU:

- under ``torchrun`` (``WORLD_SIZE`` set) :func:`init_distributed` starts
  NCCL on CUDA, or gloo when ``DLION_PLATFORM=cpu`` asks for the CPU;
- a process group the caller already started is used as it is;
- otherwise the run is a world of one, with no process group.

With a ``tensor`` axis (``--tensor_parallel`` tp > 1) the world is the JAX
package's ``(data, tensor)`` reshape of its devices (``make_mesh``,
mesh.py:36-68): global rank ``r`` has data index ``r // tp`` and tensor
index ``r % tp``, so a tensor group is tp consecutive ranks (NVLink
neighbours on a node) and data group ``t`` is ranks ``t, t + tp, …``.
:func:`make_grid` builds every data group and every tensor group on every
process, in one order (``dist.new_group`` is collective over the default
group), and returns this rank's :class:`Grid`: the vote runs on its data
group, the model's reductions on its tensor group.

:func:`resolve_device` is the one place the port decides where to run:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when CUDA is missing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"


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


@dataclasses.dataclass(frozen=True)
class TensorAxis:
    """This rank's place on the tensor axis: its group (None at tp 1), the
    axis size and its index on it."""

    group: Any = None
    size: int = 1
    rank: int = 0


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the dp × tp grid: ``data`` is the vote's group
    (None for a data axis of one), ``world`` the group of every rank of the
    run (None for a world of one), ``rank`` the rank in it; ``data_rank``
    and ``tensor`` the indices on the two axes."""

    data: Any
    world: Any
    dp: int
    rank: int
    data_rank: int
    tensor: TensorAxis = TensorAxis()

    @property
    def tp(self) -> int:
        return self.tensor.size


def data_grid(group=None) -> Grid:
    """The grid of a data-parallel run over ``group`` (tp 1): the vote
    group is every rank of the run, as before the tensor axis."""
    w = 1 if group is None else dist.get_world_size(group)
    r = rank_of(group)
    return Grid(data=group, world=group, dp=w, rank=r, data_rank=r)


def make_grid(tp: int = 1, group=None) -> Grid:
    """The ``(data, tensor)`` grid of tp-wide tensor groups over the ranks of
    ``group`` (None: the default group, or a world of one); tp 1 is
    :func:`data_grid`."""
    if tp < 1:
        raise ValueError(f"--tensor_parallel must be >= 1, got {tp}")
    if tp == 1:
        return data_grid(group)
    if not dist.is_initialized():
        raise ValueError(f"--tensor_parallel {tp} needs {tp} ranks or a multiple of it "
                         "(torchrun --nproc_per_node); this is a world of one")
    group = group or dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    world = len(ranks)
    if world % tp:
        raise ValueError(f"--tensor_parallel {tp} does not divide the world of {world} ranks")
    dp, me = world // tp, dist.get_rank(group)
    data = tensor = None
    # every process builds every group, in this order
    for t in range(tp if dp > 1 else 0):
        g = dist.new_group(ranks[t::tp])
        if t == me % tp:
            data = g
    for d in range(dp):
        g = dist.new_group(ranks[d * tp:(d + 1) * tp])
        if d == me // tp:
            tensor = g
    return Grid(data=data, world=group, dp=dp, rank=me, data_rank=me // tp,
                tensor=TensorAxis(tensor, tp, me % tp))
