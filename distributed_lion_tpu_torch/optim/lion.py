"""Local Lion, the optimizer state, and the flat parameter buffers.

Port of ``distributed_lion_tpu/optim/lion.py``. The JAX package keeps
params as a pytree and addresses them through a flat-offset layout; here
:class:`FlatParams` makes that layout real. The params (and their grads)
live in one contiguous buffer each, in the JAX package's leaf order, and
every ``nn.Parameter``'s ``.data`` and ``.grad`` are views into those
buffers, so autograd accumulates into the flat grad buffer in place and an
optimizer pass over a bucket is one kernel launch over one window. A tree
of mixed dtypes keeps one buffer per dtype (its leaves in leaf order), and
the leaf-order coordinates of the whole tree, which the ballots and the
vote follow, map onto windows of those buffers (:meth:`FlatParams.runs`);
its momentum is one buffer per param buffer (a tuple in
``LionState.exp_avg``).

Hyperparameter defaults and validation follow the reference's ``Lion``
(lr 1e-4, betas (0.9, 0.99), weight decay 0). ``mom_dtype`` stores the
momentum in another dtype than the params (``bfloat16`` halves the
optimizer state), as the JAX package's ``mom_dtype``; the grads are cast to
it once per step, before any math.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from distributed_lion_tpu_torch.ops import lion_math
from distributed_lion_tpu_torch.ops.codec import packed_size, vote_chunk_elems

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class LionState(NamedTuple):
    count: torch.Tensor    # int32 step counter on the params' device
    exp_avg: Union[torch.Tensor, tuple]  # flat momentum buffer, rank-local, in the
    # momentum dtype; for a mixed-dtype tree one per FlatParams.param_bufs buffer
    steps: int = 0         # the same count on the host: seeds stochastic ballots
    # and picks the lazy slot
    elected: Optional[torch.Tensor] = None  # packed uint8 elected-sign cache,
    # replicated; present only under vote_every > 1 (K * chunk / 8 bytes)
    health: Optional[torch.Tensor] = None  # the vote guard's [W] bool health
    # mask, replicated; present only with the guard on
    prev_ballot: Optional[torch.Tensor] = None  # the guard's packed uint8
    # previous ballot of this rank (guard_ballot_len bytes); guard only
    dcn_ring: Optional[torch.Tensor] = None  # this rank's uint8 [depth,
    # codec.hier_ring_slot_bytes] in-flight hier slots; the DCN pipeline only
    moe_ring: Optional[torch.Tensor] = None  # this data rank's float32 [depth,
    # n_moe, E+1] in-flight MoE balance tallies (--ep_dcn_pipeline d > 0):
    # slot (count mod d) holds the tallies of step count - d, summed over the
    # expert group, each MoE block's per-expert token counts and lane count.
    # Made by the trainer (its shape is the model's); the optimizer passes it
    # through untouched


class FlatParams:
    """Contiguous param and grad buffers for a list of named parameters;
    each parameter's ``.data`` and ``.grad`` become views of its window.
    The leaves' order is the JAX package's and defines the flat coordinates
    ``[0, numel)`` (``offsets``). Parameters of one dtype share one buffer
    each (``params``, ``grads``); a mixed tree keeps one buffer per dtype,
    in the order its dtypes first appear (``param_bufs``, ``grad_bufs``),
    each holding its leaves in leaf order, as the JAX package's XLA path
    keeps its leaves (``distributed_lion.py:696-701``); :meth:`runs` maps
    flat coordinates onto them."""

    def __init__(self, named_params: Sequence[tuple[str, torch.nn.Parameter]]):
        if not named_params:
            raise ValueError("FlatParams needs at least one parameter")
        devices = {p.device for _, p in named_params}
        if len(devices) != 1:
            raise ValueError(f"flat buffers over several devices {sorted(map(str, devices))}")
        self.names = [name for name, _ in named_params]
        self.shapes = [tuple(p.shape) for _, p in named_params]
        sizes = [p.numel() for _, p in named_params]
        self.offsets = [0]
        for n in sizes[:-1]:
            self.offsets.append(self.offsets[-1] + n)
        self.numel = sum(sizes)
        (device,) = devices
        dtypes: list = []
        for _, p in named_params:
            if p.dtype not in dtypes:
                dtypes.append(p.dtype)
        self.dtypes = dtypes
        self.group = [dtypes.index(p.dtype) for _, p in named_params]  # each leaf's buffer
        self.group_offsets, fill = [], [0] * len(dtypes)
        for k, n in zip(self.group, sizes):
            self.group_offsets.append(fill[k])
            fill[k] += n
        self.param_bufs = [torch.empty(n, dtype=dt, device=device) for n, dt in zip(fill, dtypes)]
        self.grad_bufs = [torch.zeros(n, dtype=dt, device=device) for n, dt in zip(fill, dtypes)]
        with torch.no_grad():
            for (_, p), k, off, n in zip(named_params, self.group, self.group_offsets, sizes):
                window = self.param_bufs[k][off:off + n]
                window.copy_(p.reshape(-1))
                p.data = window.view_as(p)
                p.grad = self.grad_bufs[k][off:off + n].view_as(p)
        self._params = [p for _, p in named_params]
        # maximal runs of adjacent leaves in one buffer: (flat lo, flat hi,
        # buffer, its offset), contiguous in both
        self._runs: list = []
        for k, off, goff, n in zip(self.group, self.offsets, self.group_offsets, sizes):
            if self._runs and self._runs[-1][2] == k:
                lo, hi, _, g0 = self._runs[-1]
                self._runs[-1] = (lo, hi + n, k, g0)
            else:
                self._runs.append((off, off + n, k, goff))

    @property
    def mixed(self) -> bool:
        return len(self.dtypes) > 1

    @property
    def params(self) -> torch.Tensor:
        """The one param buffer of a single-dtype tree."""
        return self._single(self.param_bufs)

    @property
    def grads(self) -> torch.Tensor:
        """The one grad buffer of a single-dtype tree."""
        return self._single(self.grad_bufs)

    def _single(self, bufs: list) -> torch.Tensor:
        if self.mixed:
            raise NotImplementedError(
                f"a tree of mixed dtypes {[str(d) for d in self.dtypes]} has one buffer per "
                "dtype (param_bufs, grad_bufs): only local Lion and Distributed Lion "
                "take it")
        return bufs[0]

    @property
    def device(self) -> torch.device:
        return self.param_bufs[0].device

    def runs(self, lo: int, hi: int) -> list[tuple[int, int, int, int]]:
        """``(buffer, start, stop, offset from lo)`` windows covering the flat
        coordinates ``[lo, hi)`` in order; one window for a single-dtype
        tree."""
        if not self.mixed:
            return [(0, lo, hi, 0)]
        out = []
        for r_lo, r_hi, k, g0 in self._runs:
            a, b = max(lo, r_lo), min(hi, r_hi)
            if a < b:
                out.append((k, g0 + a - r_lo, g0 + b - r_lo, a - lo))
        return out

    def zero_grad(self) -> None:
        """Zero the flat grad buffers; the ``.grad`` views stay bound, so the
        next backward accumulates into them in place."""
        for name, p, k, off in zip(self.names, self._params, self.group, self.group_offsets):
            if p.grad is None or p.grad.data_ptr() != self.grad_bufs[k][off:].data_ptr():
                raise RuntimeError(
                    f"{name}.grad is no longer a view of the flat grad buffer "
                    "(set to None or replaced); the optimizer would not see it")
        for g in self.grad_bufs:
            g.zero_()

    def views(self, buf) -> dict[str, torch.Tensor]:
        """Each parameter's window of a flat buffer (params, grads or
        momentum; for a mixed tree a list or tuple of one buffer per
        dtype), in the parameter's shape."""
        bufs = buf if isinstance(buf, (list, tuple)) else [buf]
        return {name: bufs[k][off:off + p.numel()].view(shape)
                for name, p, k, off, shape in zip(self.names, self._params, self.group,
                                                  self.group_offsets, self.shapes)}


def _validate(lr_init, b1: float, b2: float) -> None:
    if lr_init is not None and not callable(lr_init) and lr_init <= 0.0:
        raise ValueError(f"Invalid learning rate: {lr_init}")
    for i, b in enumerate((b1, b2)):
        if not 0.0 <= b <= 1.0:
            raise ValueError(f"Invalid beta parameter at index {i}: {b}")


def resolve_lr(learning_rate: Schedule, count: torch.Tensor) -> torch.Tensor:
    """The step's LR as a float32 tensor on ``count``'s device."""
    if callable(learning_rate):
        return learning_rate(count).to(torch.float32)
    return torch.full((), learning_rate, dtype=torch.float32, device=count.device)


MOM_DTYPES = {"": None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_mom_dtype(mom_dtype) -> Optional[torch.dtype]:
    """A momentum dtype given as a torch dtype, None, or the CLI's string
    (``''`` = the param dtype, ``'float32'``, ``'bfloat16'``)."""
    if mom_dtype is None or isinstance(mom_dtype, torch.dtype):
        return mom_dtype
    if mom_dtype not in MOM_DTYPES:
        raise ValueError(f"mom_dtype must be one of {sorted(MOM_DTYPES)}, got {mom_dtype!r}")
    return MOM_DTYPES[mom_dtype]


def momenta(state: LionState) -> list:
    """The momentum buffers of a state, one per param buffer."""
    return list(state.exp_avg) if isinstance(state.exp_avg, tuple) else [state.exp_avg]


def guard_ballot_len(n: int, vote_every: int) -> int:
    """Bytes of the vote guard's previous-ballot state (JAX
    ``_guard_ballot_len``): the elected cache's per-slot layout under lazy
    refresh, so the refreshed slot's bytes line up across steps; plain
    bit-packing otherwise."""
    if vote_every > 1:
        return vote_every * vote_chunk_elems(n, vote_every) // 8
    return packed_size(n)


def fresh_guard_state(n: int, vote_every: int, world: int, device) -> dict:
    """The guard's fields of a fresh :class:`LionState`: every rank healthy
    and a zero previous ballot (no real previous vote)."""
    return {"health": torch.ones(world, dtype=torch.bool, device=device),
            "prev_ballot": torch.zeros(guard_ballot_len(n, vote_every), dtype=torch.uint8,
                                       device=device)}


def init_state(flat: FlatParams, mom_dtype: Optional[torch.dtype] = None,
               vote_every: int = 1, guard_world: int = 0,
               ring: Optional[tuple[int, int]] = None) -> LionState:
    """Step 0 and zero momentum in ``mom_dtype``, else the param dtype (the
    reference's ``exp_avg = zeros_like(p)``); under ``vote_every`` K > 1 a
    zeroed elected cache of ``K * vote_chunk_elems(n, K) / 8`` bytes; with
    ``guard_world`` W > 0 the vote guard's fresh state for W ranks; with
    ``ring`` ``(depth, slot bytes)`` the DCN pipeline's zeroed ring."""
    elected = None
    if vote_every > 1:
        chunk = vote_chunk_elems(flat.numel, vote_every)
        elected = torch.zeros(vote_every * chunk // 8, dtype=torch.uint8, device=flat.device)
    guard = (fresh_guard_state(flat.numel, vote_every, guard_world, flat.device)
             if guard_world else {})
    moms = tuple(torch.zeros_like(p, dtype=mom_dtype or p.dtype) for p in flat.param_bufs)
    return LionState(
        count=torch.zeros((), dtype=torch.int32, device=flat.device),
        exp_avg=moms if flat.mixed else moms[0],
        elected=elected, **guard,
        dcn_ring=(None if ring is None
                  else torch.zeros(ring, dtype=torch.uint8, device=flat.device)))


class Lion:
    """Single-worker Lion (the reference's world_size == 1 fallback): plain
    PyTorch math over the flat buffers, no vote and no kernel. ``step``
    updates ``flat.params`` and the momentum in place."""

    def __init__(self, learning_rate: Schedule = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 0.0, mom_dtype=None):
        _validate(learning_rate, b1, b2)
        self.learning_rate, self.b1, self.b2 = learning_rate, b1, b2
        self.weight_decay = weight_decay
        self.mom_dtype = resolve_mom_dtype(mom_dtype)

    def init(self, flat: FlatParams) -> LionState:
        return init_state(flat, self.mom_dtype)

    @torch.no_grad()
    def step(self, flat: FlatParams, state: LionState) -> LionState:
        lr = resolve_lr(self.learning_rate, state.count)
        for p, g, m in zip(flat.param_bufs, flat.grad_bufs, momenta(state)):
            # elementwise in each buffer's dtype: a mixed tree's buffers step
            # as the JAX package's per-leaf tree map
            p_new, m_new = lion_math.local_lion_leaf(p, g.to(m.dtype), m, lr,
                                                     self.weight_decay, self.b1, self.b2)
            p.copy_(p_new)
            m.copy_(m_new)
        return LionState(state.count + 1, state.exp_avg, state.steps + 1)


def lion(learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.0, mom_dtype=None) -> Lion:
    """Single-worker Lion, as the JAX package's ``lion()``."""
    return Lion(learning_rate, b1, b2, weight_decay, mom_dtype)
