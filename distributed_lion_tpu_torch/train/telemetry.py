"""Vote-health telemetry: port of ``distributed_lion_tpu/train/telemetry.py``.

What ``--telemetry`` needs: the per-step *frame*
the optimizer emits (margin histogram, packed elected signs, local
disagreement count), the on-device running accumulator :class:`VoteHealth`
that :func:`fold` adds each frame into, and :func:`drain`, the one host
read, at ``logging_steps``. The signals:

- **vote margin** |Σ worker signs|/W per coordinate, as a fixed-bin
  histogram (``NBINS`` bins of margin fraction). Only the tally wires
  (``sign_psum``, ``packed_allgather``) move the exact tally; the
  ``packed_a2a`` wire ships a ±1 verdict proxy, so its histogram is zeroed,
  not faked (``margin_exact`` says which).
- **elected-sign flip rate**: fraction of coordinates whose elected sign
  changed since the previous election (popcount of the XOR of the packed
  elections).
- **worker disagreement**: fraction of coordinates where a worker's own
  ballot lost, meaned over workers.

Counters are folded as per-step fractions in float32 on the device, as the
JAX package does (a 124M-coordinate count over a long window overflows
int32). ``fold``'s two per-worker scalars (disagreement and the stochastic
flip fraction, 0 in the deterministic mode) go into one ``all_reduce`` of a two-element
float32 tensor over the vote group; nothing in ``fold`` reads the device.
The trainer's checkpoints carry the accumulator (``train/loop.py``), so
flip rates and histograms continue across a restart. Under lazy refresh
(``vote_every`` K > 1) a frame's ``elected`` is the optimizer's K-slot
cache (:func:`elected_packed_len`), so the flip rate compares the
refreshed slot with its election one rotation earlier.

**Crash bundles** (JAX :295-362): :func:`write_crash_bundle` writes
``<output_dir>/crash/step_<n:08d>/bundle.json``, strict JSON (nonfinite
floats become their repr strings), for the NaN sentinel. The port's params
and momentum are flat buffers; :func:`nonfinite_leaf_counts` counts them
per leaf through ``FlatParams``' windows and :func:`nonfinite_leaf_report`
names the leaves with the JAX package's ``keystr`` (``['blocks'][0]...``;
``.exp_avg`` first for the optimizer state), so a bundle names the leaves
the JAX package's names. With the run journal on, the bundle's directory
also holds ``journal_tail.jsonl``: the journal's ring buffer, the last
records before the trip.

**The measured wire ledger** (JAX :249-274): torch has no abstract trace,
so :func:`measure_step_wire` runs one real optimizer step under
``parallel.collectives.WIRE_TALLY.capture()`` and returns the bytes each
vote launch handed the backend, per leg (``ici``/``dcn``), under the JAX
ledger's keys; the trainer logs it beside ``profiling.comm_report``'s
analytic bytes (``comm_drift_bytes``, 0 while the two agree).
**The step-skew heartbeat** (JAX :277-292): :func:`host_step_skew`, max −
min of the ranks' step counters, gathered over a gloo side group
(``collectives.side_group``), on the host, never on the card's stream.

This module may import ``ops``; ``optim`` and ``train.loop`` import it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from distributed_lion_tpu_torch.ops.codec import (
    packed_size,
    parse_wire,
    popcount,
    vote_chunk_elems,
)
from distributed_lion_tpu_torch.ops.fused_lion import margin_bins
from distributed_lion_tpu_torch.parallel.collectives import WIRE_TALLY
from distributed_lion_tpu_torch.train.journal import emit

# bin k covers margin fractions [k/NBINS, (k+1)/NBINS); unanimity (margin 1)
# is clipped into the top bin. Fixed, so records compare across runs.
NBINS = 8


def tally_wire(wire: str) -> bool:
    """True when ``wire`` moves the exact tally Σ±1 (margins available)."""
    kind, _ = parse_wire(wire)
    return kind in ("sign_psum", "packed_allgather")


def margin_hist(totals: torch.Tensor, world: int,
                mask: Optional[torch.Tensor] = None, nbins: int = NBINS) -> torch.Tensor:
    """Fixed-bin int32 bincount of |total|/world over the voted coordinates
    (``mask`` drops coordinates), binned by ``ops.fused_lion.margin_bins``
    as ``bucket_vote_stats`` bins."""
    idx = margin_bins(totals, world, nbins)
    if mask is not None:
        idx = torch.where(mask, idx, nbins)  # dropped coordinates land in an extra bin
    return torch.bincount(idx, minlength=nbins + 1)[:nbins].to(torch.int32)


def elected_packed_len(n_params: int, vote_every: int = 1) -> int:
    """Bytes of the packed elected-sign vector a frame carries: the full
    ballot for strict voting, the K-slot byte-aligned cache
    (``codec.vote_chunk_elems``) under lazy refresh."""
    if vote_every > 1:
        return vote_every * vote_chunk_elems(n_params, vote_every) // 8
    return packed_size(n_params)


def empty_frame(packed_len: int, device=None) -> dict:
    """The zero frame (JAX ``empty_frame``)."""
    z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
    return {
        "margin_hist": torch.zeros(NBINS, dtype=torch.int32, device=device),
        "elected": torch.zeros(packed_len, dtype=torch.uint8, device=device),
        "disagree": z(torch.int32),
        "voted": z(torch.int32),
        "valid": z(torch.int32),
        "stoch_flip_frac": z(torch.float32),
        "flip_valid": z(torch.bool),
    }


@dataclasses.dataclass
class VoteHealth:
    """Running accumulator of device tensors (replicated across ranks),
    reset after each drain. Counters are per-step fractions summed in
    float32; the fields mirror the JAX ``VoteHealth``."""

    steps: torch.Tensor          # int32: steps folded since the last drain
    voted: torch.Tensor          # float32: Σ per-step voted-coordinate counts
    voted_steps: torch.Tensor    # int32: steps that voted > 0 coordinates
    margin_hist: torch.Tensor    # float32[NBINS]: Σ per-step fraction histograms
    flip_sum: torch.Tensor       # float32: Σ per-step flip fractions
    flip_steps: torch.Tensor     # int32: steps contributing a flip comparison
    disagree_sum: torch.Tensor   # float32: Σ per-step mean disagreement fractions
    stoch_flip_sum: torch.Tensor  # float32: Σ per-step stochastic flip fractions
    valid_sum: torch.Tensor      # float32: Σ per-step valid-update fractions
    prev_elected: torch.Tensor   # uint8: last election, packed (flip base)
    has_prev: torch.Tensor       # int32 0/1: prev_elected is a real election


def init_vote_health(n_params: int, vote_every: int = 1, device=None) -> VoteHealth:
    def z(dt):
        return torch.zeros((), dtype=dt, device=device)

    return VoteHealth(
        steps=z(torch.int32), voted=z(torch.float32), voted_steps=z(torch.int32),
        margin_hist=torch.zeros(NBINS, dtype=torch.float32, device=device),
        flip_sum=z(torch.float32), flip_steps=z(torch.int32),
        disagree_sum=z(torch.float32), stoch_flip_sum=z(torch.float32),
        valid_sum=z(torch.float32),
        prev_elected=torch.zeros(elected_packed_len(n_params, vote_every), dtype=torch.uint8,
                                 device=device),
        has_prev=z(torch.int32))


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of a uint8 vector as a float32 scalar (``codec.popcount``)."""
    return popcount(x).to(torch.float32)


def fold(vh: VoteHealth, frame: dict, group, world: int, n_params: int) -> VoteHealth:
    """Fold one step's frame into the accumulator (JAX ``fold``). The
    per-worker disagreement count and stochastic flip fraction are summed
    over the vote ``group`` (None: a world of one) in one all_reduce."""
    voted = frame["voted"].to(torch.float32)
    did_vote = frame["voted"] > 0
    denom = torch.clamp_min(voted, 1.0)
    hist_frac = frame["margin_hist"].to(torch.float32) / denom
    pair = torch.stack([frame["disagree"].to(torch.float32),
                        frame["stoch_flip_frac"].to(torch.float32)])
    if group is not None:
        dist.all_reduce(pair, group=group)
    disagree = pair[0] / (world * denom)
    stoch = pair[1] / world
    flips = _popcount(torch.bitwise_xor(frame["elected"], vh.prev_elected))
    counts_flip = (vh.has_prev > 0) & did_vote & frame["flip_valid"]
    flip_frac = torch.where(counts_flip, flips / denom, 0.0)
    valid_frac = frame["valid"].to(torch.float32) / max(n_params, 1)
    return VoteHealth(
        steps=vh.steps + 1,
        voted=vh.voted + voted,
        voted_steps=vh.voted_steps + did_vote.to(torch.int32),
        margin_hist=vh.margin_hist + hist_frac,
        flip_sum=vh.flip_sum + flip_frac,
        flip_steps=vh.flip_steps + counts_flip.to(torch.int32),
        disagree_sum=vh.disagree_sum + disagree,
        stoch_flip_sum=vh.stoch_flip_sum + stoch,
        valid_sum=vh.valid_sum + valid_frac,
        prev_elected=frame["elected"],
        has_prev=torch.ones_like(vh.has_prev))


def drain(vh: VoteHealth, margin_exact: bool) -> dict:
    """One host transfer: the accumulator as plain floats, normalized per
    folded step; the histogram per voted step, so its mass is 1.0 exactly
    when every voted coordinate landed in a bin (tally wires)."""
    scalars = torch.stack([vh.steps.to(torch.float64), vh.voted.to(torch.float64),
                           vh.voted_steps.to(torch.float64), vh.flip_sum.to(torch.float64),
                           vh.flip_steps.to(torch.float64), vh.disagree_sum.to(torch.float64),
                           vh.stoch_flip_sum.to(torch.float64), vh.valid_sum.to(torch.float64)])
    host = torch.cat([scalars, vh.margin_hist.to(torch.float64)]).cpu().tolist()
    steps, voted, voted_steps, flip_sum, flip_steps, dis, stoch, valid = host[:8]
    s = max(int(steps), 1)
    vs = max(int(voted_steps), 1)
    hist = [float(x) / vs for x in host[8:]]
    return {
        "steps": int(steps),
        "voted_per_step": voted / s,
        "margin_exact": 1 if margin_exact else 0,
        "margin_hist": [round(h, 6) for h in hist],
        "hist_mass": round(float(sum(hist)), 6),
        "flip_rate": flip_sum / max(int(flip_steps), 1),
        "disagree_frac": dis / vs,
        "stoch_flip_frac": stoch / s,
        "valid_frac": valid / s,
    }


def reset_counters(vh: VoteHealth) -> VoteHealth:
    """Zero the drained counters; the previous election and its validity
    bit carry over, so the flip rate stays continuous across intervals."""
    z = torch.zeros_like
    return dataclasses.replace(
        vh, steps=z(vh.steps), voted=z(vh.voted), voted_steps=z(vh.voted_steps),
        margin_hist=z(vh.margin_hist), flip_sum=z(vh.flip_sum), flip_steps=z(vh.flip_steps),
        disagree_sum=z(vh.disagree_sum), stoch_flip_sum=z(vh.stoch_flip_sum),
        valid_sum=z(vh.valid_sum))


# -------------------------------------------------------------- crash bundles
def ledger_of(entries) -> dict:
    """The measured wire ledger of one step's captured ``(leg, bytes)``
    launches: the JAX ``measure_step_wire``'s keys."""
    return {"bytes_per_step": sum(b for _, b in entries),
            "dcn_bytes_per_step": sum(b for leg, b in entries if leg == "dcn"),
            "calls_per_step": len(entries),
            "per_call": [{"leg": leg, "bytes": b} for leg, b in entries]}


def measure_step_wire(step_fn, *args):
    """Run ``step_fn(*args)``, one real optimizer step, under
    ``WIRE_TALLY.capture()``; returns ``(its result, the ledger)``
    (:func:`ledger_of`). The capture only appends to a host list: the step
    runs as it would without it."""
    with WIRE_TALLY.capture() as entries:
        out = step_fn(*args)
    return out, ledger_of(entries)


def host_step_skew(step: int, side_group) -> Optional[int]:
    """Max − min of the ranks' step counters (a gloo ``all_gather`` of one
    int64 over ``side_group``, on the host); None without a group (a world
    of one)."""
    if side_group is None:
        return None
    try:
        mine = torch.tensor([int(step)], dtype=torch.int64)
        steps = [torch.zeros_like(mine) for _ in range(side_group.size())]
        dist.all_gather(steps, mine, group=side_group)
        vals = [int(t) for t in steps]
        return max(vals) - min(vals)
    except Exception as e:  # the heartbeat must not stop training
        emit(f"[telemetry] heartbeat unavailable: {e}")
        return None


def leaf_key(name: str) -> str:
    """The JAX package's ``keystr`` of the leaf a dotted parameter name
    spells: ``blocks.0.attn.proj`` → ``['blocks'][0]['attn']['proj']``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in name.split("."))


def nonfinite_leaf_counts(flat, buf: torch.Tensor) -> torch.Tensor:
    """int64 ``[leaves]``: the nonfinite elements of each leaf's window of
    a flat buffer (params or momentum) of ``flat`` (a ``FlatParams``), in
    the flat layout's order."""
    return torch.stack([(~torch.isfinite(v)).sum() for v in flat.views(buf).values()])


def nonfinite_leaf_report(names, counts, prefix: str = "") -> dict:
    """{leaf keystr: nonfinite count} of the leaves with any: the crash
    bundle's "which leaf is poisoned" answer."""
    return {prefix + leaf_key(name): int(c)
            for name, c in zip(names, counts.tolist()) if c}


def _json_safe(obj):
    """Recursive JSON sanitizer for bundle payloads: nonfinite floats
    become their repr strings ('nan', 'inf'), so a bundle shows the poison
    and stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def write_crash_bundle(output_dir: str, step: int, reason: str, cfg_dict: dict,
                       nonfinite_params: dict, nonfinite_opt_state: dict, metrics_window,
                       guard: Optional[dict] = None, journal_tail=None) -> str:
    """Write ``<output_dir>/crash/step_<n:08d>/bundle.json``: the step, the
    trip reason, the train config, the per-leaf nonfinite counts of the
    params and of the optimizer state (:func:`nonfinite_leaf_report`), the
    recent metrics window and (``guard``) the vote guard's (or the control
    plane's) per-rank health report, so the bundle names the sick rank as
    well as the poisoned leaves. ``journal_tail`` (the run journal's ring
    buffer) is written beside it as ``journal_tail.jsonl``, in the live
    journal's strict schema. Returns the bundle's directory."""
    crash_dir = os.path.join(output_dir, "crash", f"step_{step:08d}")
    os.makedirs(crash_dir, exist_ok=True)
    if journal_tail:
        with open(os.path.join(crash_dir, "journal_tail.jsonl"), "w") as f:
            for rec in journal_tail:
                f.write(json.dumps(_json_safe(rec), allow_nan=False) + "\n")
    bundle = {
        "step": step,
        "reason": reason,
        "written": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config": cfg_dict,
        "nonfinite_params": nonfinite_params,
        "nonfinite_opt_state": nonfinite_opt_state,
        "metrics_window": list(metrics_window),
    }
    if guard is not None:
        bundle["guard"] = guard
    with open(os.path.join(crash_dir, "bundle.json"), "w") as f:
        json.dump(_json_safe(bundle), f, indent=1, allow_nan=False)
        f.write("\n")
    return crash_dir
