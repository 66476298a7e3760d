"""Process setup: the port's counterpart of ``distributed_lion_tpu/parallel/mesh.py``.

The JAX package builds a device mesh whose ``data`` axis is the vote axis.
Here the vote axis is the ``torch.distributed`` world, one process per GPU:

- under ``torchrun`` (``WORLD_SIZE`` set) :func:`init_distributed` starts
  NCCL on CUDA, or gloo when ``DLION_PLATFORM=cpu`` asks for the CPU;
- a process group the caller already started is used as it is;
- otherwise the run is a world of one, with no process group.

With a ``tensor`` axis (``--tensor_parallel`` tp > 1), a ``seq`` axis
(``--seq_parallel`` sp > 1), a ``pipe`` axis (``--pipeline_parallel`` pp >
1) and an ``expert`` axis (``--expert_parallel`` ep > 1) the world is the
JAX package's ``(data, tensor, seq, pipe, expert)`` reshape of its devices
(``make_mesh``, mesh.py:31-68): global rank ``r = (((d·tp + t)·sp + s)·pp +
p)·ep + e``, so an expert group is ep consecutive ranks (one per ``(d, t, s,
p)``), a pipe group the pp ranks of stride ep that share ``(d, t, s, e)``, a
seq group the sp ranks of stride pp·ep that share ``(d, t, p, e)``, a tensor
group the tp ranks that share ``(d, s, p, e)``, and a data group the ranks
that share ``(t, s, p, e)``. At sp, pp and ep 1 that is data index ``r //
tp`` and tensor index ``r % tp``. :func:`make_grid` builds every data,
tensor, seq, pipe and expert group on every process, in one order
(``dist.new_group`` is collective over the default group), and returns this
rank's :class:`Grid`: the vote runs on its data group, the model's
reductions on its tensor group, the ring's hops and the gradient's sum on
its seq group, the pipeline's stage hops and the replicated leaves'
gradient sum on its pipe group, the MoE dispatch and return hops and the
replicated leaves' gradient sum on its expert group.

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
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"


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
class SeqAxis(TensorAxis):
    """This rank's place on the seq axis: its group (None at sp 1), the
    axis size and its index on it, which is its token chunk's."""


@dataclasses.dataclass(frozen=True)
class PipeAxis(TensorAxis):
    """This rank's place on the pipe axis: its group (None at pp 1), the
    axis size and its index on it, which is its pipeline stage's."""


@dataclasses.dataclass(frozen=True)
class ExpertAxis(TensorAxis):
    """This rank's place on the expert axis: its group (None at ep 1), the
    axis size and its index on it, which is its share of the MoE experts
    and of the data rank's batch rows."""


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the dp × tp × sp × pp × ep grid: ``data`` is
    the vote's group (None in a world of one), ``world`` the group of every
    rank of the run (None for a world of one), ``rank`` the rank in it;
    ``data_rank``, ``tensor``, ``seq``, ``pipe`` and ``expert`` the places
    on the five axes."""

    data: Any
    world: Any
    dp: int
    rank: int
    data_rank: int
    tensor: TensorAxis = TensorAxis()
    seq: SeqAxis = SeqAxis()
    expert: ExpertAxis = ExpertAxis()
    pipe: PipeAxis = PipeAxis()

    @property
    def tp(self) -> int:
        return self.tensor.size

    @property
    def sp(self) -> int:
        return self.seq.size

    @property
    def pp(self) -> int:
        return self.pipe.size

    @property
    def ep(self) -> int:
        return self.expert.size


def data_grid(group=None) -> Grid:
    """The grid of a data-parallel run over ``group`` (tp 1): the vote
    group is every rank of the run, as before the tensor axis."""
    w = 1 if group is None else dist.get_world_size(group)
    r = rank_of(group)
    return Grid(data=group, world=group, dp=w, rank=r, data_rank=r)


def make_grid(tp: int = 1, group=None, sp: int = 1, ep: int = 1, pp: int = 1) -> Grid:
    """The ``(data, tensor, seq, pipe, expert)`` grid of tp-wide tensor
    groups, sp-wide seq groups, pp-wide pipe groups and ep-wide expert
    groups over the ranks of ``group`` (None: the default group, or a world
    of one); tp, sp, pp and ep 1 is :func:`data_grid`. Where ``group`` is
    one of several groups whose processes build their grids at the same
    time, the processes first gather every such group's members and each
    builds every grid's groups, in one order (as
    ``collectives.HierGroups`` does)."""
    if tp < 1:
        raise ValueError(f"--tensor_parallel must be >= 1, got {tp}")
    if sp < 1:
        raise ValueError(f"--seq_parallel must be >= 1, got {sp}")
    if ep < 1:
        raise ValueError(f"--expert_parallel must be >= 1, got {ep}")
    if pp < 1:
        raise ValueError(f"--pipeline_parallel must be >= 1, got {pp}")
    if tp == 1 and sp == 1 and ep == 1 and pp == 1:
        return data_grid(group)
    axes = " x ".join(f"--{name}_parallel {n}" for name, n in
                      (("tensor", tp), ("seq", sp), ("pipeline", pp), ("expert", ep)) if n > 1)
    model = tp * sp * pp * ep
    if not dist.is_initialized():
        raise ValueError(f"{axes} needs {model} ranks or a multiple of it "
                         "(torchrun --nproc_per_node); this is a world of one")
    group = group or dist.group.WORLD
    ranks = tuple(dist.get_process_group_ranks(group))
    if len(ranks) % model:
        raise ValueError(f"{axes} does not divide the world of {len(ranks)} ranks")
    parts = [ranks]
    if len(ranks) < dist.get_world_size():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, ranks)
        parts = sorted(set(every))
    me = dist.get_rank()
    for part in parts:
        groups = _grid_groups(part, tp, sp, ep, pp)
        if me in part:
            mine = groups
    data, tensor, seq, expert, pipe, (d, t, s, e, p) = mine
    return Grid(data=data, world=group, dp=len(ranks) // model, rank=ranks.index(me),
                data_rank=d, tensor=TensorAxis(tensor, tp, t), seq=SeqAxis(seq, sp, s),
                expert=ExpertAxis(expert, ep, e), pipe=PipeAxis(pipe, pp, p))


def _grid_groups(ranks: tuple, tp: int, sp: int, ep: int = 1, pp: int = 1) -> tuple:
    """Every data, tensor, seq, expert and pipe group of the grid over
    ``ranks``, built in one order (``dist.new_group`` is collective over the
    default group; a data axis of one is a group of the one rank, where
    None would read as the whole world): ``(data, tensor, seq, expert, pipe,
    (d, t, s, e, p))`` of this process, which need not be one of ``ranks``."""
    dp = len(ranks) // (tp * sp * pp * ep)
    d = t = s = e = p = None
    if dist.get_rank() in ranks:
        me = ranks.index(dist.get_rank())
        d, t = me // (tp * sp * pp * ep), me // (sp * pp * ep) % tp
        s, p, e = me // (pp * ep) % sp, me // ep % pp, me % ep

    def at(d_, t_, s_, p_, e_):
        return ranks[(((d_ * tp + t_) * sp + s_) * pp + p_) * ep + e_]

    def build(size, axis):
        """Every group along ``axis`` (0-4: d, t, s, p, e), one for each
        place on the other four; this process's, or None."""
        found = None
        if size == 1 and axis:
            return None
        others = [range(n) for n in (dp, tp, sp, pp, ep)]
        others[axis] = range(1)
        for d_ in others[0]:
            for t_ in others[1]:
                for s_ in others[2]:
                    for p_ in others[3]:
                        for e_ in others[4]:
                            place = [d_, t_, s_, p_, e_]
                            members = []
                            for i in range(size):
                                place[axis] = i
                                members.append(at(*place))
                            g = dist.new_group(members)
                            place[axis] = (d, t, s, p, e)[axis]
                            if tuple(place) == (d, t, s, p, e):
                                found = g
        return found

    data, tensor, seq = build(dp, 0), build(tp, 1), build(sp, 2)
    expert, pipe = build(ep, 4), build(pp, 3)
    return data, tensor, seq, expert, pipe, (d, t, s, e, p)
