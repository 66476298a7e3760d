"""Vote guard: the host-side quarantine state machine. Port of
``distributed_lion_tpu/train/vote_guard.py`` (numpy and stdlib only, copied
so the port needs nothing of the JAX package), with the same constants,
observation keys and transitions.

signSGD with majority vote tolerates a minority of adversarial voters
(Bernstein et al., 2019) only if the run excludes them from the vote. The
optimizer (``optim.distributed_lion``, ``guard != 'off'``) emits cheap
per-rank health signals every step: nonfinite ballot-input counts,
ballot-flip counts against the previous vote (popcount of the XOR ≈ 0 is a
frozen voter) and local-vs-elected disagreement fractions. The trainer
hands them to :class:`VoteGuard` one step behind, so the device never
waits on the host read.

The machine is three per-rank registers and two thresholds:

- **strikes** accumulate one per bad observed step (a nonfinite input, a
  frozen ballot, an outlier disagreement) and decay one per clean step, so
  a transient fault never escalates while an intermittent outlier still
  ratchets toward the threshold;
- at ``strike_threshold`` strikes a healthy rank is **quarantined**: under
  ``enforce`` the trainer clears its bit in ``LionState.health``, and the
  masked election (``parallel.collectives``) excludes its ballots, the
  majority threshold shrinking to the healthy quorum; ``observe`` keeps the
  same books and never touches the mask;
- after ``cooldown_steps`` in quarantine the rank is **readmitted** as a
  probe: the trainer re-averages its momentum from the healthy mean
  (``optim.distributed_lion.heal_rank_momentum``) and sets its bit again.
  A rank still sick strikes out again within ``strike_threshold`` steps.

Below ``min_quorum`` healthy ranks the trainer refuses to continue (a loud
``RuntimeError``): an election with a sick majority is noise.

Host-side only; it imports neither ``optim`` nor ``train.loop``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Outlier rule, two arms that must BOTH fire: an absolute floor (honest
# voters in a healthy election sit well under this disagreement fraction;
# a noise-dominated one puts EVERYONE near 0.5, which the relative arm
# absorbs) and a relative margin over the mean of the worker's healthy
# peers — the test that separates "the election is noisy for everyone"
# from "this one voter is inverted/divergent". Calibrated against measured
# traces: honest workers cluster within ~±0.03 of each other while a
# flipped (sign-inverted) voter sits ~0.15 above the cluster; the peer
# mean INCLUDES the outlier when judging an honest worker, which widens
# the honest worker's bar and narrows the outlier's — the asymmetry that
# makes one adversary separable at these margins.
DISAGREE_ABS = 0.35
DISAGREE_MARGIN = 0.1

# metrics keys the jitted step emits per dispatch (the trainer pops them
# from the metrics dict before logging — they are [W] vectors / counters,
# not loggable scalars). Chunked dispatches SUM these over the scanned
# steps, so each is "count of steps" (or a summed fraction) per worker.
OBS_KEYS = ("guard_nonfinite", "guard_frozen", "guard_disagree",
            "guard_voted_steps")


@dataclasses.dataclass
class GuardEvents:
    """What one observation window changed: worker indices quarantined /
    readmitted (or, under observe, WOULD have been), whether the device
    mask must be re-pushed, and human-readable log lines."""

    quarantined: list
    readmitted: list
    mask_changed: bool
    logs: list


class VoteGuard:
    """Per-worker strike/quarantine/cooldown bookkeeping (see module doc)."""

    def __init__(self, world: int, mode: str, strike_threshold: int = 3,
                 cooldown_steps: int = 50, min_quorum: int = 0,
                 disagree_abs: float = DISAGREE_ABS,
                 disagree_margin: float = DISAGREE_MARGIN,
                 journal=None):
        if mode not in ("observe", "enforce"):
            raise ValueError(f"guard mode must be 'observe' or 'enforce', "
                             f"got {mode!r}")
        if strike_threshold < 1:
            raise ValueError(f"strike_threshold must be >= 1, got "
                             f"{strike_threshold}")
        if cooldown_steps < 1:
            raise ValueError(f"cooldown_steps must be >= 1, got "
                             f"{cooldown_steps}")
        self.world = int(world)
        self.mode = mode
        self.strike_threshold = int(strike_threshold)
        self.cooldown_steps = int(cooldown_steps)
        # 0 = auto: a strict majority must stay healthy — below that the
        # "election" no longer estimates anything
        self.min_quorum = int(min_quorum) or (self.world // 2 + 1)
        if not 1 <= self.min_quorum <= self.world:
            raise ValueError(
                f"min_quorum {self.min_quorum} outside [1, {self.world}]")
        self.disagree_abs = float(disagree_abs)
        self.disagree_margin = float(disagree_margin)
        # run-journal hook (train/journal.py; duck-typed — this module
        # stays importable without jax and without the journal): every
        # quarantine/readmission transition is recorded as an event, so
        # the control plane consumes the state machine as a stream instead
        # of scraping log lines
        self._journal = journal
        self.healthy = np.ones(self.world, dtype=bool)
        self.strikes = np.zeros(self.world, dtype=np.int64)
        self.quarantined_at = np.full(self.world, -1, dtype=np.int64)
        # cumulative per-worker signal counters (bad steps observed), kept
        # for the crash bundle / sentinel so a bundle can NAME the sick
        # worker, not just the poisoned leaves
        self.counters = {k: np.zeros(self.world, dtype=np.int64)
                         for k in ("nonfinite", "frozen", "outlier")}
        self.quarantine_events = 0
        self.readmit_events = 0

    # ---------------------------------------------------------------- state
    def healthy_count(self) -> int:
        return int(self.healthy.sum())

    def quorum_ok(self) -> bool:
        return self.healthy_count() >= self.min_quorum

    def adopt_mask(self, healthy, step: int) -> None:
        """Resume path: adopt a checkpointed health mask. Quarantined
        workers restart their cooldown at ``step`` (the original
        quarantine step is not persisted — a fresh probe window is the
        conservative reading)."""
        healthy = np.asarray(healthy, dtype=bool).reshape(-1)
        if healthy.shape[0] != self.world:
            raise ValueError(
                f"health mask has {healthy.shape[0]} workers, guard expects "
                f"{self.world}")
        self.healthy = healthy.copy()
        self.strikes[:] = 0
        self.quarantined_at[:] = -1
        self.quarantined_at[~self.healthy] = int(step)

    def sick_report(self) -> dict:
        """Per-worker health snapshot for crash bundles / operators: the
        mask, strikes, and every worker with a nonzero signal counter."""
        sick = {}
        for w in range(self.world):
            entry = {k: int(v[w]) for k, v in self.counters.items() if v[w]}
            if entry or not self.healthy[w]:
                entry["healthy"] = bool(self.healthy[w])
                sick[str(w)] = entry
        return {
            "mode": self.mode,
            "healthy_mask": [bool(h) for h in self.healthy],
            "strikes": [int(s) for s in self.strikes],
            "sick_workers": sick,
        }

    def sick_workers(self) -> list:
        """Workers currently quarantined or carrying nonzero counters —
        the names the NaN sentinel attaches to its trip reason."""
        flagged = ~self.healthy
        for v in self.counters.values():
            flagged = flagged | (v > 0)
        return [int(w) for w in np.nonzero(flagged)[0]]

    def summary(self) -> dict:
        """Scalar metrics for the logging cadence (strict-JSON friendly)."""
        return {
            "guard_healthy": self.healthy_count(),
            "guard_quarantined": self.world - self.healthy_count(),
            "guard_strikes_max": int(self.strikes.max(initial=0)),
            "guard_quarantine_events": self.quarantine_events,
            "guard_readmit_events": self.readmit_events,
        }

    # --------------------------------------------------------------- update
    def _outliers(self, disagree: np.ndarray, voted_steps: int) -> np.ndarray:
        """Per-worker outlier flags from the window's mean disagreement
        fractions. Absolute + relative-to-healthy-peers test; workers with
        no healthy peer to compare against are never flagged by the
        relative arm alone."""
        out = np.zeros(self.world, dtype=bool)
        if voted_steps <= 0:
            return out
        dis = disagree / voted_steps
        for w in range(self.world):
            if dis[w] <= self.disagree_abs:
                continue
            peers = dis[[i for i in range(self.world)
                         if i != w and self.healthy[i]]]
            base = float(peers.mean()) if peers.size else 0.0
            if dis[w] > base + self.disagree_margin:
                out[w] = True
        return out

    def update(self, step: int, obs: dict, advanced: int) -> GuardEvents:
        """Fold one dispatch's summed observations (``OBS_KEYS``, already
        host numpy) covering ``advanced`` optimizer steps ending at
        ``step``. Returns the transitions for the trainer to act on."""
        nonfinite = np.asarray(obs["guard_nonfinite"]).reshape(-1)
        frozen = np.asarray(obs["guard_frozen"]).reshape(-1)
        disagree = np.asarray(obs["guard_disagree"], dtype=np.float64
                              ).reshape(-1)
        voted_steps = int(np.asarray(obs["guard_voted_steps"]).reshape(())
                          ) if "guard_voted_steps" in obs else advanced
        outlier = self._outliers(disagree, voted_steps)

        # bad steps per worker this window: nonfinite and frozen arrive as
        # counts of bad steps from the device; an outlier verdict covers
        # the whole window
        bad_steps = np.clip(nonfinite, 0, advanced).astype(np.int64)
        bad_steps = np.maximum(bad_steps,
                               np.clip(frozen, 0, advanced).astype(np.int64))
        bad_steps = np.maximum(bad_steps,
                               np.where(outlier, advanced, 0))
        self.counters["nonfinite"] += np.clip(nonfinite, 0, advanced
                                              ).astype(np.int64)
        self.counters["frozen"] += np.clip(frozen, 0, advanced
                                           ).astype(np.int64)
        self.counters["outlier"] += np.where(outlier, advanced, 0
                                             ).astype(np.int64)

        events = GuardEvents([], [], False, [])
        would = "" if self.mode == "enforce" else "[observe] would have "
        for w in range(self.world):
            if self.healthy[w]:
                if bad_steps[w] > 0:
                    self.strikes[w] += int(bad_steps[w])
                else:
                    # a clean window forgives gradually (decay, not reset):
                    # transient faults still never escalate, but an
                    # INTERMITTENT outlier that flags most windows keeps
                    # ratcheting toward the threshold
                    self.strikes[w] = max(0, int(self.strikes[w]) - 1)
                if self.strikes[w] >= self.strike_threshold:
                    self.healthy[w] = False
                    self.quarantined_at[w] = step
                    self.strikes[w] = 0
                    self.quarantine_events += 1
                    events.quarantined.append(w)
                    events.mask_changed = True
                    sig = [k for k, v in (("nonfinite", nonfinite[w]),
                                          ("frozen", frozen[w]),
                                          ("outlier", outlier[w])) if v]
                    events.logs.append(
                        f"{would}QUARANTINED worker {w} at step {step} "
                        f"({'+'.join(sig) or 'strikes'}); healthy quorum "
                        f"{self.healthy_count()}/{self.world}")
                    if self._journal is not None:
                        self._journal.event(
                            "guard_quarantine", worker=int(w),
                            step=int(step), mode=self.mode,
                            signals="+".join(sig) or "strikes",
                            healthy=self.healthy_count())
            else:
                if step - self.quarantined_at[w] >= self.cooldown_steps:
                    self.healthy[w] = True
                    self.quarantined_at[w] = -1
                    self.strikes[w] = 0
                    self.readmit_events += 1
                    events.readmitted.append(w)
                    events.mask_changed = True
                    events.logs.append(
                        f"{would}READMITTED worker {w} at step {step} "
                        "(cooldown elapsed; momentum re-averaged from the "
                        "healthy mean — a still-sick worker re-strikes)")
                    if self._journal is not None:
                        self._journal.event(
                            "guard_readmit", worker=int(w), step=int(step),
                            mode=self.mode, healthy=self.healthy_count())
        return events


def parse_guard_mode(mode: str) -> str:
    if mode not in ("off", "observe", "enforce"):
        raise ValueError(
            f"--vote_guard {mode!r}: expected 'off' (no guard), 'observe' "
            "(detect + report, elections untouched) or 'enforce' (masked "
            "elections + quarantine + readmission healing)")
    return mode


def make_guard(world: int, mode: str, strike_threshold: int,
               cooldown_steps: int, min_quorum: int,
               journal=None) -> Optional[VoteGuard]:
    """The trainer's constructor: None when the guard is off."""
    if parse_guard_mode(mode) == "off":
        return None
    return VoteGuard(world, mode, strike_threshold=strike_threshold,
                     cooldown_steps=cooldown_steps, min_quorum=min_quorum,
                     journal=journal)
