"""Local Lion, the optimizer state, and the flat parameter buffers.

Port of ``distributed_lion_tpu/optim/lion.py``. The JAX package keeps
params as a pytree and addresses them through a flat-offset layout; here
:class:`FlatParams` makes that layout real. The params (and their grads)
live in one contiguous buffer each, in the JAX package's leaf order, and
every ``nn.Parameter``'s ``.data`` and ``.grad`` are views into those
buffers, so autograd accumulates into the flat grad buffer in place and an
optimizer pass over a bucket is one kernel launch over one window.

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
    exp_avg: torch.Tensor  # flat momentum buffer, rank-local, in the momentum dtype
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
    """One contiguous param buffer and one grad buffer for a list of named
    parameters of one dtype; each parameter's ``.data`` and ``.grad``
    become views of its window. Parameters of mixed dtypes would need one
    buffer per dtype (the JAX package's non-uniform XLA path), which is not
    ported (ROADMAP Queue 1 item 4)."""

    def __init__(self, named_params: Sequence[tuple[str, torch.nn.Parameter]]):
        if not named_params:
            raise ValueError("FlatParams needs at least one parameter")
        dtypes = {p.dtype for _, p in named_params}
        devices = {p.device for _, p in named_params}
        if len(dtypes) != 1 or len(devices) != 1:
            raise NotImplementedError(
                f"flat buffers over mixed dtypes {sorted(map(str, dtypes))} "
                f"or devices {sorted(map(str, devices))} are not ported "
                "(ROADMAP Queue 1 item 4)")
        self.names = [name for name, _ in named_params]
        self.shapes = [tuple(p.shape) for _, p in named_params]
        sizes = [p.numel() for _, p in named_params]
        self.offsets = [0]
        for n in sizes[:-1]:
            self.offsets.append(self.offsets[-1] + n)
        self.numel = sum(sizes)
        (dtype,), (device,) = dtypes, devices
        self.params = torch.empty(self.numel, dtype=dtype, device=device)
        self.grads = torch.zeros(self.numel, dtype=dtype, device=device)
        with torch.no_grad():
            for (_, p), off, n in zip(named_params, self.offsets, sizes):
                window = self.params[off:off + n]
                window.copy_(p.reshape(-1))
                p.data = window.view_as(p)
                p.grad = self.grads[off:off + n].view_as(p)
        self._params = [p for _, p in named_params]

    @property
    def device(self) -> torch.device:
        return self.params.device

    def zero_grad(self) -> None:
        """Zero the flat grad buffer; the ``.grad`` views stay bound, so the
        next backward accumulates into it in place."""
        for name, p, off in zip(self.names, self._params, self.offsets):
            if p.grad is None or p.grad.data_ptr() != self.grads[off:].data_ptr():
                raise RuntimeError(
                    f"{name}.grad is no longer a view of the flat grad buffer "
                    "(set to None or replaced); the optimizer would not see it")
        self.grads.zero_()

    def views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        """Each parameter's window of a flat buffer (params, grads or
        momentum), in the parameter's shape."""
        return {name: buf[off:off + p.numel()].view(shape)
                for name, p, off, shape in zip(self.names, self._params,
                                               self.offsets, self.shapes)}


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
    return LionState(
        count=torch.zeros((), dtype=torch.int32, device=flat.device),
        exp_avg=torch.zeros_like(flat.params, dtype=mom_dtype or flat.params.dtype),
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
        m = state.exp_avg
        p_new, m_new = lion_math.local_lion_leaf(
            flat.params, flat.grads.to(m.dtype), m, lr, self.weight_decay,
            self.b1, self.b2)
        flat.params.copy_(p_new)
        m.copy_(m_new)
        return LionState(state.count + 1, m, state.steps + 1)


def lion(learning_rate: Schedule = 1e-4, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.0, mom_dtype=None) -> Lion:
    """Single-worker Lion, as the JAX package's ``lion()``."""
    return Lion(learning_rate, b1, b2, weight_decay, mom_dtype)
