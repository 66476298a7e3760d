"""Host-side request-lifecycle metrics plane of the serving stack: port of
``distributed_lion_tpu/serve/metrics.py``.

Standard library and numpy only, like ``train/journal.py``: nothing here
reads a device value. Every stamp rides host work the tick loop already
does (``submit`` bookkeeping, the one host read a decode tick, completion
assembly), so the engine's tokens are the same with the plane on or off.

Three layers:

``LogHistogram``
    A bounded incremental percentile sketch: fixed geometric bins
    (``bins_per_decade`` bins per decade between ``lo`` and ``hi``),
    exact count/sum/min/max on the side. ``merge`` is associative and
    commutative (pure bin-count addition), so ``ServingFleet`` can
    aggregate per-replica sketches without ever holding raw samples.
    A percentile query returns the geometric midpoint of the bin the
    rank falls in, clamped to the observed [min, max]: the relative
    error is bounded by the bin ratio ``10**(1/bins_per_decade)``
    (pinned against a numpy reference in tests).

``RequestTimes`` / ``ServeMetrics``
    ``RequestTimes`` is the always-on tick-domain clock: per-request
    submit/first-token/finish tick stamps that become the
    ``ttft_ticks`` / ``queue_ticks`` / ``decode_ticks`` fields on every
    serve/api response record (serve/api.completion_record). It is
    integer bookkeeping on host events that already happen, so it runs
    unconditionally. ``ServeMetrics`` is the opt-in plane on top: wall
    clocks (TTFT ms, per-token decode ms), the sketches, live gauges
    (queue depth, page-pool occupancy, active slots, speculative
    accept rate, prefix-hit/CoW counts, evictions), drained at a tick
    cadence into ``serve_metrics`` journal events (train/journal.py —
    strict JSON, ``allow_nan=False``).

``SLOMonitor``
    Rolling-window burn-rate accounting over per-request SLO outcomes
    (``--slo_ttft_ms`` / ``--slo_tok_ms`` / ``--slo_p99``). The error
    budget is ``1 - slo_p99``; burn rate is the window's violation
    fraction divided by that budget. Crossing 1.0 journals an
    ``slo_breach`` event (edge-triggered, so a sustained breach is one
    event, not one per request) and counts honestly in ``breaches``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from distributed_lion_tpu_torch.train import journal as journal_mod


# ---------------------------------------------------------------------------
# percentile sketch
# ---------------------------------------------------------------------------


class LogHistogram:
    """Fixed-bin log-scale percentile sketch — bounded and mergeable.

    Bins are geometric: bin ``i`` (1-based interior) covers
    ``[lo * base**(i-1), lo * base**i)`` with
    ``base = 10**(1/bins_per_decade)``. Bin 0 is the underflow bucket
    (values <= lo, including zeros), the last bin the overflow bucket
    (values >= hi). The memory footprint is fixed at construction —
    independent of how many samples are added — which is the whole
    point: a million-request soak costs the same bytes as ten requests.
    """

    def __init__(self, lo: float = 1e-3, hi: float = 1e7,
                 bins_per_decade: int = 32):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got lo={lo!r} hi={hi!r}")
        if bins_per_decade < 1:
            raise ValueError(f"bins_per_decade must be >= 1, got "
                             f"{bins_per_decade!r}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        decades = math.log10(self.hi / self.lo)
        self._interior = int(math.ceil(decades * self.bins_per_decade))
        # [underflow] + interior + [overflow]
        self.counts = np.zeros(self._interior + 2, dtype=np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- construction-compatibility key for merge ------------------------
    def _key(self):
        return (self.lo, self.hi, self.bins_per_decade)

    def _bin_of(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return len(self.counts) - 1
        i = 1 + int(math.floor(
            math.log10(v / self.lo) * self.bins_per_decade))
        return min(max(i, 1), self._interior)

    def add(self, value: float, count: int = 1) -> None:
        """Record ``count`` observations of ``value``. Non-finite values
        are refused loudly — a NaN latency is a bug upstream, and a
        sketch that silently eats it would launder the bug into every
        percentile it ever reports."""
        v = float(value)
        if not math.isfinite(v):
            raise ValueError(f"non-finite sample {value!r}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count!r}")
        self.counts[self._bin_of(v)] += count
        self.n += count
        self.total += v * count
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Pure merge: returns a NEW sketch holding both inputs' mass.
        Associative and commutative (bin-count addition), so a fleet can
        fold replicas in any order and get identical counts."""
        if other._key() != self._key():
            raise ValueError(
                f"cannot merge sketches with different layouts: "
                f"{self._key()} vs {other._key()}")
        out = LogHistogram(self.lo, self.hi, self.bins_per_decade)
        out.counts = self.counts + other.counts
        out.n = self.n + other.n
        out.total = self.total + other.total
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` (0..100): geometric midpoint of the
        bin the rank falls in, clamped to the observed [min, max]. With
        no samples, 0.0 (a sketch with nothing in it has no latency to
        report — callers gate on ``n``)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q!r}")
        if self.n == 0:
            return 0.0
        rank = max(1, int(math.ceil(q / 100.0 * self.n)))
        cum = 0
        idx = len(self.counts) - 1
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum >= rank:
                idx = i
                break
        if idx == 0:
            # underflow holds values <= lo: the observed min is the only
            # honest representative (lo itself may never have occurred)
            rep = self.vmin
        elif idx == len(self.counts) - 1:
            rep = self.vmax
        else:
            edge_lo = self.lo * 10.0 ** ((idx - 1) / self.bins_per_decade)
            edge_hi = self.lo * 10.0 ** (idx / self.bins_per_decade)
            rep = math.sqrt(edge_lo * edge_hi)
        return float(min(max(rep, self.vmin), self.vmax))

    def summary(self) -> Dict[str, float]:
        """Flat strict-JSON-safe summary (what drain journals and the
        bench banks)."""
        if self.n == 0:
            return {"count": 0, "min": 0.0, "max": 0.0, "mean": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": int(self.n),
                "min": float(self.vmin), "max": float(self.vmax),
                "mean": float(self.total / self.n),
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0)}


class TickLatencyWindow:
    """Bounded tick-latency diagnostic: a recency window of raw samples
    (exact percentiles over the last ``window`` ticks — what the slow-
    replica bench reads) plus a full-history :class:`LogHistogram` for
    fleet-level merging. Replaces the unbounded per-replica
    ``tick_latency_log`` lists (a soak of millions of ticks used to grow
    a float per tick per replica, forever)."""

    def __init__(self, window: int = 1024):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        self.recent: Deque[float] = deque(maxlen=int(window))
        self.sketch = LogHistogram()

    def add(self, ms: float) -> None:
        self.recent.append(float(ms))
        self.sketch.add(float(ms))

    def __len__(self) -> int:
        return self.sketch.n

    def percentile(self, q: float) -> float:
        """Exact percentile over the recency window (numpy reference on
        the bounded raw samples; the sketch answers full-history
        queries)."""
        if not self.recent:
            return 0.0
        return float(np.percentile(list(self.recent), q))


# ---------------------------------------------------------------------------
# request lifecycle clocks
# ---------------------------------------------------------------------------


class RequestTimes:
    """Always-on tick-domain request clocks. One small dict per inflight
    request; entries retire on ``finished``, so steady-state memory is
    bounded by the number of inflight requests, not the soak length.

    Stamp taxonomy (ticks are the engine's own loop counter):

    - ``submit_tick``  — admission-queue entry (ServingEngine.submit)
    - ``first_tick``   — the tick whose prefill produced token 0 (TTFT)
    - ``finish_tick``  — terminal tick (eos/length/overflow/timeout/
      failed — every status stamps, including queue-side deaths that
      never reached prefill)

    Derived fields (the serve/api response-record columns):
    ``queue_ticks = first_tick - submit_tick`` (admission wait),
    ``ttft_ticks`` (same clock — they diverge only if prefill is ever
    chunked across ticks), ``decode_ticks = finish_tick - first_tick``.
    """

    def __init__(self):
        self._submit: Dict[Any, int] = {}
        self._first: Dict[Any, int] = {}

    def submitted(self, req_id, tick: int) -> None:
        self._submit.setdefault(req_id, int(tick))

    def first_token(self, req_id, tick: int) -> None:
        self._first.setdefault(req_id, int(tick))

    def finished(self, req_id, tick: int) -> Dict[str, int]:
        """Retire the request's clocks; returns the timing dict that
        rides the Completion (and from there the response record)."""
        tick = int(tick)
        sub = self._submit.pop(req_id, tick)
        first = self._first.pop(req_id, None)
        if first is None:
            # never produced a token (queue-side timeout/failure):
            # the whole life was queue wait, decode never started
            return {"queue_ticks": max(tick - sub, 0), "decode_ticks": 0}
        return {"queue_ticks": max(first - sub, 0),
                "ttft_ticks": max(first - sub, 0),
                "decode_ticks": max(tick - first, 0)}


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------


class SLOMonitor:
    """Rolling-window burn-rate accounting over per-request outcomes.

    A finished request is in-SLO when its TTFT is within ``ttft_ms``
    AND its mean per-token decode latency is within ``tok_ms`` (either
    bound may be None = unmonitored). The error budget is
    ``1 - slo_p99`` — the violation fraction the SLO tolerates; burn
    rate is the rolling window's violation fraction divided by that
    budget, so 1.0 means "spending budget exactly as fast as allowed".
    Crossing above 1.0 (with at least ``min_count`` requests in the
    window) journals one edge-triggered ``slo_breach`` event and
    increments ``breaches``.
    """

    def __init__(self, ttft_ms: Optional[float] = None,
                 tok_ms: Optional[float] = None, p99: float = 0.99,
                 window: int = 256, min_count: int = 8):
        if not 0.0 < p99 < 1.0:
            raise ValueError(f"slo_p99 must be in (0, 1), got {p99!r}")
        self.ttft_ms = None if ttft_ms is None else float(ttft_ms)
        self.tok_ms = None if tok_ms is None else float(tok_ms)
        self.p99 = float(p99)
        self.min_count = int(min_count)
        self._window: Deque[bool] = deque(maxlen=int(window))
        self.requests = 0
        self.violations = 0
        self.violations_ttft = 0
        self.violations_tok = 0
        self.breaches = 0
        self._breached = False

    @property
    def error_budget(self) -> float:
        return 1.0 - self.p99

    def burn_rate(self) -> float:
        if not self._window:
            return 0.0
        frac = sum(self._window) / len(self._window)
        return frac / self.error_budget

    def observe(self, ttft_ms: Optional[float],
                mean_tok_ms: Optional[float], *, tick: int = 0) -> bool:
        """Record one finished request; returns True if it violated the
        SLO. A request that never produced a token (``ttft_ms`` None
        under a monitored TTFT bound) counts as a violation — the
        honest reading of "the user never saw a first token"."""
        bad_ttft = self.ttft_ms is not None and (
            ttft_ms is None or ttft_ms > self.ttft_ms)
        bad_tok = self.tok_ms is not None and (
            mean_tok_ms is not None and mean_tok_ms > self.tok_ms)
        bad = bad_ttft or bad_tok
        self.requests += 1
        if bad_ttft:
            self.violations_ttft += 1
        if bad_tok:
            self.violations_tok += 1
        if bad:
            self.violations += 1
        self._window.append(bad)
        rate = self.burn_rate()
        if (rate > 1.0 and len(self._window) >= self.min_count
                and not self._breached):
            self._breached = True
            self.breaches += 1
            journal_mod.event(
                "slo_breach", tick=int(tick), burn_rate=float(rate),
                window=len(self._window),
                window_violations=int(sum(self._window)),
                error_budget=float(self.error_budget))
        elif rate <= 1.0:
            self._breached = False
        return bad

    def snapshot(self) -> Dict[str, float]:
        return {"requests": int(self.requests),
                "violations": int(self.violations),
                "violations_ttft": int(self.violations_ttft),
                "violations_tok": int(self.violations_tok),
                "breaches": int(self.breaches),
                "burn_rate": float(self.burn_rate()),
                "error_budget": float(self.error_budget)}


# ---------------------------------------------------------------------------
# the per-engine metrics plane
# ---------------------------------------------------------------------------


class ServeMetrics:
    """Opt-in request-lifecycle metrics for one engine (or one replica).

    Owns the wall clocks and sketches; reads tick stamps from the
    engine's always-on :class:`RequestTimes`. All hooks are plain host
    arithmetic on events the tick loop already pays for — no hook may
    touch a device value that is not already a host scalar.
    """

    def __init__(self, times: RequestTimes,
                 slo: Optional[SLOMonitor] = None,
                 drain_every: int = 64, time_fn=time.monotonic):
        if drain_every < 1:
            raise ValueError(f"drain_every must be >= 1, got "
                             f"{drain_every!r}")
        self.times = times
        self.slo = slo
        self.drain_every = int(drain_every)
        self._now = time_fn
        self._submit_t: Dict[Any, float] = {}
        self._first_t: Dict[Any, float] = {}
        self.ttft_ms = LogHistogram()
        self.tok_ms = LogHistogram()
        self.ttft_ticks = LogHistogram(lo=0.5, hi=1e7, bins_per_decade=32)
        self.queue_ticks = LogHistogram(lo=0.5, hi=1e7, bins_per_decade=32)
        self.decode_ticks = LogHistogram(lo=0.5, hi=1e7,
                                         bins_per_decade=32)
        self.status_counts: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.drains = 0

    # -- lifecycle hooks (called from the engine's existing host work) --
    def on_submit(self, req_id) -> None:
        self._submit_t.setdefault(req_id, self._now())

    def on_first_token(self, req_id) -> None:
        if req_id in self._first_t:
            return
        t = self._now()
        self._first_t[req_id] = t
        t0 = self._submit_t.get(req_id)
        if t0 is not None:
            self.ttft_ms.add(max((t - t0) * 1e3, 0.0))

    def on_decode_tick(self, wall_ms: float, batch: int) -> None:
        """One decode dispatch produced one token for each of ``batch``
        active requests: the tick's wall time IS the per-token decode
        interval for every one of them."""
        if batch > 0:
            self.tok_ms.add(max(float(wall_ms), 0.0), count=int(batch))

    def on_finish(self, req_id, timing: Dict[str, int],
                  status: str, *, tick: int = 0) -> Dict[str, Any]:
        """Fold a terminal request into the sketches/SLO; returns the
        timing dict extended with wall ``ttft_ms`` when available."""
        self.status_counts[status] = self.status_counts.get(status, 0) + 1
        if "queue_ticks" in timing:
            self.queue_ticks.add(max(timing["queue_ticks"], 0.5))
        if "ttft_ticks" in timing:
            self.ttft_ticks.add(max(timing["ttft_ticks"], 0.5))
        if "decode_ticks" in timing:
            self.decode_ticks.add(max(timing["decode_ticks"], 0.5))
        t0 = self._submit_t.pop(req_id, None)
        t1 = self._first_t.pop(req_id, None)
        ttft = None
        if t0 is not None and t1 is not None:
            ttft = max((t1 - t0) * 1e3, 0.0)
            timing = dict(timing)
            timing["ttft_ms"] = float(ttft)
        if self.slo is not None:
            n_dec = max(int(timing.get("decode_ticks", 0)), 0)
            mean_tok = None
            if n_dec > 0 and t1 is not None:
                mean_tok = max((self._now() - t1) * 1e3, 0.0) / n_dec
            self.slo.observe(ttft, mean_tok, tick=tick)
        return timing

    def set_gauges(self, **gauges) -> None:
        """Replace the live gauge snapshot (queue depth, active slots,
        page-pool occupancy, accept/hit rates ... whatever the caller's
        stats surface exposes as host scalars)."""
        self.gauges = {k: float(v) for k, v in gauges.items()}

    # -- drain ----------------------------------------------------------
    def maybe_drain(self, tick: int) -> Optional[Dict[str, Any]]:
        if tick % self.drain_every != 0:
            return None
        return self.drain(tick)

    def drain(self, tick: int) -> Dict[str, Any]:
        """Emit the current snapshot as one ``serve_metrics`` journal
        event (flat strict-JSON fields) and return it."""
        self.drains += 1
        snap: Dict[str, Any] = {"tick": int(tick)}
        for name, sk in (("ttft_ms", self.ttft_ms),
                         ("tok_ms", self.tok_ms),
                         ("queue_ticks", self.queue_ticks),
                         ("decode_ticks", self.decode_ticks)):
            for k, v in sk.summary().items():
                snap[f"{name}_{k}"] = v
        for k, v in self.gauges.items():
            snap[f"gauge_{k}"] = v
        for k, v in sorted(self.status_counts.items()):
            snap[f"status_{k}"] = int(v)
        if self.slo is not None:
            for k, v in self.slo.snapshot().items():
                snap[f"slo_{k}"] = v
        journal_mod.event("serve_metrics", **snap)
        return snap

    # -- fleet aggregation ----------------------------------------------
    def merge_from(self, other: "ServeMetrics") -> None:
        """Fold another plane's sketches/counters into this one (the
        fleet-level aggregate). Raw samples never cross the boundary —
        only bin counts and counters."""
        self.ttft_ms = self.ttft_ms.merge(other.ttft_ms)
        self.tok_ms = self.tok_ms.merge(other.tok_ms)
        self.ttft_ticks = self.ttft_ticks.merge(other.ttft_ticks)
        self.queue_ticks = self.queue_ticks.merge(other.queue_ticks)
        self.decode_ticks = self.decode_ticks.merge(other.decode_ticks)
        for k, v in other.status_counts.items():
            self.status_counts[k] = self.status_counts.get(k, 0) + v

    def snapshot(self) -> Dict[str, Any]:
        """Nested summary (bench/report consumption; ``drain`` journals
        the flat form)."""
        out: Dict[str, Any] = {
            "ttft_ms": self.ttft_ms.summary(),
            "tok_ms": self.tok_ms.summary(),
            "queue_ticks": self.queue_ticks.summary(),
            "decode_ticks": self.decode_ticks.summary(),
            "status_counts": dict(sorted(self.status_counts.items())),
            "gauges": dict(self.gauges),
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out
