"""Pipeline parallelism: port of ``distributed_lion_tpu/parallel/pipeline.py``.

The layer stack is split into ``S`` stages over a pipe group
(``parallel.mesh.PipeAxis``): stage ``p`` holds layers ``[p·L/S, (p+1)·L/S)``
and the global batch rows of its data rank, cut into ``M`` microbatches.
The JAX package runs the GPipe shift register as one ``lax.scan`` of
``ppermute``s and lets ``jax.grad`` transpose it. Torch autograd would not
keep a hop whose output nothing downstream uses on every rank's graph, and a
hop is a collective, so the pipe group would wait forever; the port runs an
explicit GPipe schedule instead (:class:`GPipe`):

- forward, ``M + S − 1`` ticks: at tick ``t`` stage ``p`` computes
  microbatch ``t − p`` when ``0 <= t − p < M`` and is idle (a bubble)
  otherwise; then one hop moves each active stage's output to the next
  stage. Stage 0 ingests each microbatch through ``ingest(i)`` (the
  embedding, on autograd's graph); every later stage takes what it
  received as a detached leaf;
- backward, the same ticks in reverse: stage ``p`` runs
  ``torch.autograd.backward(y_i, dy_i)`` for its microbatch of the tick (the
  last stage's ``dy_i`` from its head loss, every other stage's received
  from the next one) and hops the gradient of its input leaf back to the
  previous stage.

The hops sit outside autograd. Each is an ``all_to_all_single`` over the
pipe group in which only the active stages send or receive, the port's
``ppermute`` (``parallel/ring_attention.py``) with zero-sized splits, so
every stage makes the same collectives in the same order by construction;
a tick with no transfer anywhere makes none. Each microbatch takes the same
arithmetic as in the JAX schedule, without the bubbles' garbage compute.
The bubble fraction is ``(S − 1)/(M + S − 1)`` (:func:`bubble_fraction`).

:func:`pipeline_apply` is the JAX function's forward: microbatches
identical on every stage in, outputs real on the last stage and zeros
elsewhere out. :func:`stack_stage_params` and :func:`unstack_stage_params`
give the JAX package's stacked ``[S, L/S, ...]`` layout, which the weight
carrier reads (``utils/serialization.py``); the port's stages hold their
layers as modules.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.parallel.mesh import PipeAxis


def bubble_fraction(stages: int, n_micro: int) -> float:
    """The share of a GPipe schedule's ticks a stage sits idle."""
    return (stages - 1) / (n_micro + stages - 1)


def stage_layers(n_layer: int, pipe: PipeAxis) -> range:
    """The layers stage ``pipe.rank`` of ``pipe.size`` holds."""
    if n_layer % pipe.size:
        raise ValueError(f"{n_layer} layers not divisible by {pipe.size} stages")
    per = n_layer // pipe.size
    return range(pipe.rank * per, (pipe.rank + 1) * per)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_stage_params(layer_params: list, n_stages: int):
    """``[L layers]`` of nested dicts → one nested dict of stacked leaves
    ``[n_stages, L/n_stages, ...]`` (torch tensors or numpy arrays)."""
    n_layer = len(layer_params)
    if n_layer % n_stages:
        raise ValueError(f"{n_layer} layers not divisible by {n_stages} stages")

    def stack(*xs):
        mod = torch if isinstance(xs[0], torch.Tensor) else __import__("numpy")
        s = mod.stack(xs)
        return s.reshape((n_stages, n_layer // n_stages) + tuple(s.shape[1:]))

    return _tree_map(stack, *layer_params)


def unstack_stage_params(stacked, n_layer: int) -> list:
    """The inverse of :func:`stack_stage_params`."""
    flat = _tree_map(lambda x: x.reshape((n_layer,) + tuple(x.shape[2:])), stacked)
    return [_tree_map(lambda x: x[i], flat) for i in range(n_layer)]


def to_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[batch, ...]`` → ``[n_micro, batch/n_micro, ...]``."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def from_microbatches(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_microbatches`."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def from_last_stage(val: torch.Tensor, pipe: PipeAxis) -> torch.Tensor:
    """A value real on the last stage (zeros elsewhere) on every stage: the
    sum over the pipe group of the last stage's value and the others'
    zeros, outside autograd."""
    out = (val if pipe.rank == pipe.size - 1 else torch.zeros_like(val)).detach().clone()
    if pipe.size > 1:
        dist.all_reduce(out, group=pipe.group)
    return out


def _hop(send: Optional[torch.Tensor], receive: bool, like: tuple, pipe: PipeAxis,
         shift: int) -> Optional[torch.Tensor]:
    """One stage hop over the pipe group: ``send`` (or nothing) goes to
    stage ``rank + shift``, and with ``receive`` a tensor like ``like =
    (shape, dtype, device)`` arrives from stage ``rank − shift``. Every
    stage calls it at the same tick."""
    S, p = pipe.size, pipe.rank
    shape, dtype, device = like
    n = 1
    for s in shape:
        n *= s
    flat = (send.detach().to(dtype).contiguous().reshape(-1) if send is not None
            else torch.empty(0, dtype=dtype, device=device))
    out = torch.empty(n if receive else 0, dtype=dtype, device=device)
    dist.all_to_all_single(out, flat,
                           output_split_sizes=[out.numel() if j == p - shift else 0
                                               for j in range(S)],
                           input_split_sizes=[flat.numel() if j == p + shift else 0
                                              for j in range(S)],
                           group=pipe.group)
    return out.view(shape) if receive else None


class GPipe:
    """One GPipe schedule of ``stage_fn`` over ``n_micro`` microbatches on
    the pipe group (module doc). :meth:`forward` returns the last stage's
    outputs (detached leaves that require grad when grad is on), None on
    the other stages; :meth:`backward` takes their gradients on the last
    stage (None elsewhere) and runs every stage's backward. Both are called
    by every stage, forward then backward, one schedule at a time."""

    def __init__(self, stage_fn: Callable, pipe: PipeAxis, n_micro: int):
        self.stage_fn, self.pipe, self.n_micro = stage_fn, pipe, n_micro
        self._io: list = []   # (input leaf or None, output) of each microbatch
        self._like: Optional[tuple] = None

    def _active(self, t: int) -> bool:
        """Whether this stage computes a microbatch at tick ``t``."""
        return 0 <= t - self.pipe.rank < self.n_micro

    def forward(self, ingest: Callable[[int], torch.Tensor],
                like: tuple) -> Optional[list]:
        """``ingest(i)``: stage 0's input of microbatch ``i``; ``like =
        (shape, dtype, device)``: a stage output's, which the later stages
        receive."""
        S, p, M = self.pipe.size, self.pipe.rank, self.n_micro
        grad = torch.is_grad_enabled()
        recv = None
        self._io, self._like = [], like
        for t in range(M + S - 1):
            y = None
            if self._active(t):
                if p == 0:
                    x_leaf, x = None, ingest(t - p)
                else:
                    x_leaf = x = recv.requires_grad_(grad)
                y = self.stage_fn(x)
                self._io.append((x_leaf, y))
            if S > 1 and t < M + S - 2:   # the last tick's outputs go nowhere
                recv = _hop(y if p < S - 1 else None, p > 0 and self._active(t + 1), like,
                            self.pipe, 1)
        if p < S - 1:
            return None
        return [y.detach().requires_grad_(grad) for _, y in self._io]

    def backward(self, grads: Optional[list]) -> None:
        """``grads``: the gradients of the last stage's outputs."""
        S, p, M = self.pipe.size, self.pipe.rank, self.n_micro
        recv = None
        for t in reversed(range(M + S - 1)):
            dx = None
            if self._active(t):
                x_leaf, y = self._io[t - p]
                torch.autograd.backward(y, grads[t - p] if p == S - 1 else recv)
                if x_leaf is not None:
                    dx = x_leaf.grad
                self._io[t - p] = None   # its graph is spent
            if S > 1 and t > 0:   # tick 0's input gradient goes nowhere
                recv = _hop(dx if p > 0 else None, p < S - 1 and self._active(t - 1),
                            self._like, self.pipe, -1)
        self._io = []


def pipeline_apply(layer_fn: Callable, stage_params: list, x: torch.Tensor,
                   pipe: PipeAxis) -> torch.Tensor:
    """JAX's ``pipeline_apply``, forward: ``x`` ``[n_micro, micro_batch,
    ...]`` identical on every stage; ``layer_fn(one_layer_params, h)`` runs
    this stage's layers ``stage_params`` in order. Returns ``[n_micro,
    micro_batch, ...]`` outputs, real on the last stage and zeros on the
    others (:func:`from_last_stage` broadcasts them). Outside autograd: the
    training path is :class:`GPipe` with its backward."""
    def stage_fn(h):
        for p in stage_params:
            h = layer_fn(p, h)
        return h

    with torch.no_grad():
        run = GPipe(stage_fn, pipe, x.shape[0])
        outs = run.forward(lambda i: x[i], (tuple(x.shape[1:]), x.dtype, x.device))
    if outs is None:
        return torch.zeros_like(x)
    return torch.stack(outs)

