"""The membership control plane: port of
``distributed_lion_tpu/train/control_plane.py`` (numpy and stdlib, copied
so the port needs nothing of the JAX package), with the same states,
constants, events and log lines.

:class:`ControlPlane` drives one lifecycle per worker from every signal the
trainer has: the vote guard's per-step observations, the injected
membership schedule (``worker_drop:<w>[:<step>]`` and
``worker_rejoin:<w>:<step>`` through ``train/resilience``'s ``membership``
fault) and the preemption flag::

    healthy ──strikes──▶ suspect ──threshold──▶ quarantined
       ▲                                            │
       │ probe ok                        cooldown   │   repeated
       │                                 readmit ◀──┘   quarantines
    rejoining ◀──worker_rejoin── departed ◀─────────────(or injected
                                                         drop / preempt)

Its one output is the ``alive`` mask the masked elections of
``parallel/collectives`` take (``LionState.health``). A departure is a mask
flip at the next step boundary: training goes on at W − 1 with elections
over the healthy quorum, with no restart. A rejoin heals in the run: the
trainer re-averages the rejoiner's momentum from the healthy mean
(``optim.distributed_lion.heal_rank_momentum``), zeroes its previous
ballot, and the plane keeps it on probation for ``rejoin_probe_steps``
steps; a rejoiner that strikes out inside them departs again.
``departed`` differs from ``quarantined`` only in that it never readmits
by itself; a worker quarantined ``DEPART_AFTER_QUARANTINES`` times is
departed.

In the port a worker is a rank process. A departed rank keeps its process
and its place in every collective: only its ballot is masked, and its
momentum goes on updating from its own gradient until a rejoin heals it.
Every rank runs its own plane on the same inputs (the guard's observations
are gathered over the ranks, the schedule and the checkpoint meta are the
same on each), so every rank reaches each transition at the same boundary.

Host-side only; it imports neither ``optim`` nor ``train.loop``: the
trainer does the state surgery, the plane only decides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.vote_guard import VoteGuard

# a worker the guard keeps re-quarantining is not transiently sick, it is
# gone: after this many quarantine events the plane escalates it to
# departed (no more cooldown/readmit cycles; only an explicit
# worker_rejoin brings it back)
DEPART_AFTER_QUARANTINES = 3

STATES = ("healthy", "suspect", "quarantined", "departed", "rejoining")


@dataclasses.dataclass
class PlaneEvents:
    """What one boundary changed, for the trainer to act on: workers that
    left / rejoined / were quarantined / readmitted, the momentum rows to
    heal from the healthy mean, the prev-ballot rows to reset, whether the
    device mask must be re-pushed, and human-readable log lines."""

    left: list          # (worker, cause) pairs
    rejoined: list      # worker indices re-absorbed this boundary
    quarantined: list   # guard quarantines (plane passthrough)
    readmitted: list    # guard cooldown readmissions (plane passthrough)
    heal: list          # momentum rows to re-average from the healthy mean
    reset_ballot: list  # prev-ballot rows to zero (rejoiners only)
    mask_changed: bool
    logs: list


def _new_events() -> PlaneEvents:
    return PlaneEvents([], [], [], [], [], [], False, [])


class ControlPlane:
    """The unified membership state machine (see module doc).

    Wraps (and owns the authority over) a :class:`VoteGuard`: the guard
    keeps its strike/outlier detection and cooldown bookkeeping, while the
    plane layers the departed/rejoining states on top and suppresses the
    guard's auto-readmission for workers it knows are gone. The ``alive``
    mask is always ``guard.healthy`` — the plane enforces its own states
    by editing that mask, so the trainer keeps exactly one mask source.
    """

    def __init__(self, guard: VoteGuard, world: int,
                 rejoin_probe_steps: int = 0,
                 dcn_pipeline_depth: int = 0, journal=None):
        if guard is None:
            raise ValueError(
                "the control plane drives the live membership mask through "
                "the vote guard's masked elections — construct it with a "
                "VoteGuard (the trainer auto-arms 'enforce' when "
                "--control_plane is on)")
        if guard.world != int(world):
            raise ValueError(f"guard world {guard.world} != plane world "
                             f"{world}")
        self.guard = guard
        self.world = int(world)
        # 0 = auto: the guard's cooldown is the natural probation length —
        # the same window a quarantined worker must survive
        self.rejoin_probe_steps = (int(rejoin_probe_steps)
                                   or guard.cooldown_steps)
        if self.rejoin_probe_steps < 1:
            raise ValueError(f"rejoin_probe_steps must be >= 1, got "
                             f"{self.rejoin_probe_steps}")
        self.dcn_pipeline_depth = int(dcn_pipeline_depth)
        self._journal = journal
        self.departed: dict = {}          # worker -> cause
        # workers whose NEXT observation window must be discarded: the
        # guard runs one dispatch behind, so the first window after a
        # rejoin describes a dispatch the worker was still masked out of —
        # striking it for ballots it cast while gone would be judging the
        # wrong regime
        self._stale_obs = set()
        self.rejoining_until = np.full(self.world, -1, dtype=np.int64)
        self.quarantine_counts = np.zeros(self.world, dtype=np.int64)
        self.transitions = 0              # lifetime membership transitions
        self.left_events = 0
        self.rejoin_events = 0
        self._preempt_noted = False
        # highest boundary step whose membership schedule has been
        # consumed — rides checkpoints (manifest meta cp_sched_through) so
        # a resume does not REPLAY already-consumed drop/rejoin entries
        # (replaying a consumed rejoin would re-depart and re-heal the
        # worker at the resume boundary, diverging from the uninterrupted
        # run)
        self.sched_through = -1

    # ---------------------------------------------------------------- state
    def alive_mask(self) -> np.ndarray:
        return self.guard.healthy.copy()

    def lifecycle(self) -> list:
        """Per-worker state names — THE authoritative view the three old
        machines each held a slice of."""
        out = []
        for w in range(self.world):
            if w in self.departed:
                out.append("departed")
            elif not self.guard.healthy[w]:
                out.append("quarantined")
            elif self.rejoining_until[w] >= 0:
                out.append("rejoining")
            elif self.guard.strikes[w] > 0:
                out.append("suspect")
            else:
                out.append("healthy")
        return out

    def report(self) -> dict:
        """The guard's sick report extended with the plane's lifecycle —
        what crash bundles and the quorum refusal attach."""
        rep = self.guard.sick_report()
        rep["lifecycle"] = self.lifecycle()
        rep["departed"] = {str(w): c for w, c in sorted(self.departed.items())}
        return rep

    def summary(self) -> dict:
        """Scalar metrics for the logging cadence (strict-JSON friendly),
        merged beside the guard's own summary."""
        return {
            "cp_departed": len(self.departed),
            "cp_rejoining": int((self.rejoining_until >= 0).sum()),
            "cp_transitions": self.transitions,
        }

    def adopt(self, healthy, step: int, departed=None,
              sched_through=None, rejoining_until=None,
              quarantine_counts=None) -> None:
        """Resume path: adopt a checkpointed mask plus the manifest meta's
        departed set. Masked-out workers NOT named departed resume as
        plain quarantine (fresh cooldown — the guard's conservative
        reading); named ones stay departed with no auto-readmission. A
        plane-off checkpoint (departed=None) degrades to all-quarantined,
        the guard's semantics. ``sched_through`` restores the consumed
        membership-schedule watermark (meta ``cp_sched_through``) and
        drops the registry's already-consumed entries so the resumed run
        never replays them. ``rejoining_until``/``quarantine_counts``
        restore mid-run probation windows and quarantine history (meta
        ``cp_rejoining_until``/``cp_quarantine_counts``) so a crash
        mid-probation resumes the probe-fail rule — a still-sick rejoiner
        departs on its first re-strike, like the uninterrupted run;
        wrong-length lists (e.g. an elastic-resume world change, where
        the membership machine restarts fresh anyway) are ignored."""
        self.guard.adopt_mask(healthy, step)
        self.departed = {}
        self._stale_obs.clear()
        self.rejoining_until[:] = -1
        self.quarantine_counts[:] = 0
        if rejoining_until is not None and len(rejoining_until) == self.world:
            self.rejoining_until[:] = [int(x) for x in rejoining_until]
        if (quarantine_counts is not None
                and len(quarantine_counts) == self.world):
            self.quarantine_counts[:] = [int(x) for x in quarantine_counts]
        if sched_through is not None:
            self.sched_through = int(sched_through)
            pending = resilience.fault("membership")
            if pending:
                resilience.inject_fault(
                    "membership",
                    [m for m in pending if int(m[2]) > self.sched_through])
        for w in (departed or []):
            w = int(w)
            if not 0 <= w < self.world:
                raise ValueError(f"departed worker {w} outside world "
                                 f"{self.world}")
            self.departed[w] = "resumed"
            self.guard.healthy[w] = False

    # ----------------------------------------------------------- transitions
    def _emit_transition(self, events: PlaneEvents, name: str, worker: int,
                         step: int, cause: str, before: np.ndarray) -> None:
        self.transitions += 1
        after = self.alive_mask()
        if self._journal is not None:
            self._journal.event(
                name, worker=int(worker), step=int(step), cause=cause,
                alive=int(after.sum()), world=self.world,
                mask_before=[bool(b) for b in before],
                mask_after=[bool(b) for b in after])
            if name in ("worker_left", "worker_rejoined"):
                # the generic stream carries every transition too, so a
                # timeline consumer needs exactly one event name
                self._journal.event(
                    "membership_transition", worker=int(worker),
                    step=int(step), cause=cause, transition=name,
                    alive=int(after.sum()), world=self.world)
        events.mask_changed = True

    def _depart(self, events: PlaneEvents, worker: int, step: int,
                cause: str) -> None:
        if worker in self.departed:
            return  # already gone; a second signal is not a transition
        before = self.alive_mask()
        self.departed[worker] = cause
        self.guard.healthy[worker] = False
        self.guard.strikes[worker] = 0
        # pin the quarantine stamp so the guard's cooldown never elapses
        # for a departed worker (refreshed every observe() too)
        self.guard.quarantined_at[worker] = step
        self.rejoining_until[worker] = -1
        self.left_events += 1
        events.left.append((worker, cause))
        events.logs.append(
            f"worker {worker} LEFT at step {step} ({cause}); training "
            f"continues at {int(self.guard.healthy.sum())}/{self.world} "
            "— elections over the healthy quorum, no restart")
        self._emit_transition(events, "worker_left", worker, step, cause,
                              before)

    def _rejoin(self, events: PlaneEvents, worker: int, step: int) -> None:
        if worker not in self.departed:
            events.logs.append(
                f"worker_rejoin:{worker} at step {step} ignored — the "
                "worker never left (lifecycle "
                f"{self.lifecycle()[worker]!r})")
            return
        if self.dcn_pipeline_depth > 0:
            # the elastic-resume rule, extended to the in-run path: the DCN
            # ring's slots are in-flight level-2 tallies whose chunk
            # ownership is a function of the membership — a rejoiner's
            # slots hold tallies it never launched. Refuse loudly rather
            # than invent their meaning.
            raise RuntimeError(
                f"control plane: worker_rejoin:{worker} at step {step} "
                f"with --dcn_pipeline_depth {self.dcn_pipeline_depth}: "
                "the in-flight DCN tally ring cannot re-absorb a worker "
                "mid-flight (its ring slots hold level-2 tallies it never "
                "launched — the same reason --elastic_resume refuses "
                "depth > 0). Drain the pipeline first: restart with "
                "--dcn_pipeline_depth 0, or rejoin at the next fresh start")
        before = self.alive_mask()
        cause = self.departed.pop(worker)
        self.guard.healthy[worker] = True
        self.guard.strikes[worker] = 0
        self.guard.quarantined_at[worker] = -1
        # clean slate: the pre-departure quarantine history must not put
        # the re-absorbed worker on a hair-trigger to re-departure (one
        # later transient quarantine would otherwise re-cross
        # DEPART_AFTER_QUARANTINES immediately)
        self.quarantine_counts[worker] = 0
        self.rejoining_until[worker] = step + self.rejoin_probe_steps
        self._stale_obs.add(worker)
        self.rejoin_events += 1
        events.rejoined.append(worker)
        events.heal.append(worker)
        events.reset_ballot.append(worker)
        events.logs.append(
            f"worker {worker} REJOINED at step {step} (left: {cause}): "
            "momentum re-averaged from the healthy mean, ballot history "
            f"reset; on probation for {self.rejoin_probe_steps} steps "
            "(a still-sick rejoiner departs again)")
        self._emit_transition(events, "worker_rejoined", worker, step,
                              "rejoin", before)

    def membership_due(self, step: int) -> PlaneEvents:
        """Consume the ``membership`` fault registry's due entries —
        called at every dispatch boundary BEFORE the dispatch, so a
        ``worker_drop:<w>:0`` masks the very first election. Drops apply
        before rejoins at the same boundary (so a same-step drop+rejoin
        pair heals the worker rather than silently ignoring the rejoin),
        schedule order within each kind."""
        self.sched_through = max(self.sched_through, int(step))
        events = _new_events()
        # one shared pop-the-due-entries helper with the serve-side
        # replica plane (resilience.consume_due): 'due at boundary b'
        # means the same thing to both lifecycles
        due = sorted(resilience.consume_due("membership", int(step)),
                     key=lambda m: (int(m[2]),
                                    0 if m[0] == "worker_drop" else 1))
        for kind, worker, at in due:
            worker = int(worker)
            if not 0 <= worker < self.world:
                raise ValueError(
                    f"membership fault {kind}:{worker} outside world "
                    f"{self.world}")
            if kind == "worker_drop":
                self._depart(events, worker, step, "injected_drop")
            else:
                self._rejoin(events, worker, step)
        return events

    def note_preempt(self, step: int) -> None:
        """The PreemptionGuard's flag, folded into the one event stream:
        the whole process is departing — every local worker's lifecycle
        ends here, and the journal records it as a membership transition
        (cause 'preempt') so the timeline explains the gap a restart
        leaves. The drain/emergency-checkpoint mechanics stay with the
        trainer; the plane only records."""
        if self._preempt_noted:
            return
        self._preempt_noted = True
        self.transitions += 1
        if self._journal is not None:
            self._journal.event(
                "membership_transition", step=int(step), cause="preempt",
                transition="process_departing", world=self.world,
                alive=int(self.guard.healthy.sum()))

    # --------------------------------------------------------------- observe
    def observe(self, step: int, obs: dict, advanced: int) -> PlaneEvents:
        """Fold one dispatch's guard observations through the guard, then
        apply the plane's authority: departed workers never auto-readmit,
        a failed probe departs instead of re-entering the cooldown loop,
        and repeated quarantines escalate to departure. Replaces the
        trainer's direct ``guard.update`` when the plane is on."""
        events = _new_events()
        if obs:
            if self._stale_obs:
                # one-window amnesty for fresh rejoiners (see _stale_obs)
                obs = dict(obs)
                for k in ("guard_nonfinite", "guard_frozen"):
                    if k in obs:
                        v = np.array(obs[k])
                        for w in self._stale_obs:
                            v[w] = 0
                        obs[k] = v
                if "guard_disagree" in obs:
                    # neutral substitution, NOT zero: the rejoiner's
                    # disagreement describes a dispatch it was masked out
                    # of, but a zero would drag the healthy-peer mean
                    # down and could flag an innocent borderline peer as
                    # an outlier — give it the peers' mean instead (every
                    # peer's relative baseline is unchanged, and it can
                    # never flag the rejoiner: mean > mean + margin is
                    # false)
                    v = np.array(obs["guard_disagree"], dtype=np.float64)
                    peers = [i for i in range(self.world)
                             if self.guard.healthy[i]
                             and i not in self._stale_obs]
                    fill = float(v[peers].mean()) if peers else 0.0
                    for w in self._stale_obs:
                        v[w] = fill
                    obs["guard_disagree"] = v
                self._stale_obs.clear()
            for w in self.departed:
                # refresh the pin: cooldown must never elapse while gone
                self.guard.quarantined_at[w] = step
            gev = self.guard.update(step, obs, advanced)
            events.quarantined.extend(gev.quarantined)
            events.readmitted.extend(gev.readmitted)
            events.heal.extend(gev.readmitted)
            events.mask_changed |= gev.mask_changed
            events.logs.extend(gev.logs)
            for w in gev.quarantined:
                self.quarantine_counts[w] += 1
                if 0 <= self.rejoining_until[w]:
                    # probe failure: a rejoiner that re-strikes inside its
                    # probation window is still gone — back to departed,
                    # not into the quarantine/readmit cycle
                    self.rejoining_until[w] = -1
                    self._depart(events, w, step, "probe_failed")
                elif self.quarantine_counts[w] >= DEPART_AFTER_QUARANTINES:
                    self._depart(events, w, step, "guard_strikes")
                else:
                    self.transitions += 1
                    if self._journal is not None:
                        self._journal.event(
                            "membership_transition", worker=int(w),
                            step=int(step), cause="guard_quarantine",
                            transition="quarantined",
                            alive=int(self.guard.healthy.sum()),
                            world=self.world)
            for w in gev.readmitted:
                self.transitions += 1
                if self._journal is not None:
                    self._journal.event(
                        "membership_transition", worker=int(w),
                        step=int(step), cause="guard_readmit",
                        transition="readmitted",
                        alive=int(self.guard.healthy.sum()),
                        world=self.world)
        # probation windows that elapsed cleanly: rejoining → healthy
        for w in range(self.world):
            if 0 <= self.rejoining_until[w] <= step and \
                    self.guard.healthy[w] and w not in self.departed:
                self.rejoining_until[w] = -1
                events.logs.append(
                    f"worker {w} probation complete at step {step}: "
                    "rejoining → healthy")
                if self._journal is not None:
                    self._journal.event(
                        "membership_transition", worker=int(w),
                        step=int(step), cause="probe_complete",
                        transition="healthy",
                        alive=int(self.guard.healthy.sum()),
                        world=self.world)
                self.transitions += 1
        return events

    def quorum_ok(self) -> bool:
        return self.guard.quorum_ok()

    def quorum_error(self, step: int) -> str:
        rep = self.report()
        return (
            f"control plane: healthy quorum "
            f"{int(self.guard.healthy.sum())}/{self.world} fell below "
            f"--min_quorum {self.guard.min_quorum} at step {step} — a "
            "majority election with a sick majority is noise, refusing to "
            f"continue. Lifecycle: {rep['lifecycle']}; departed: "
            f"{rep['departed']}; sick counters: {rep['sick_workers']}")


def make_control_plane(guard: Optional[VoteGuard], world: int,
                       rejoin_probe_steps: int, dcn_pipeline_depth: int,
                       journal=None) -> ControlPlane:
    """The trainer's constructor (mirrors vote_guard.make_guard)."""
    return ControlPlane(guard, world,
                        rejoin_probe_steps=rejoin_probe_steps,
                        dcn_pipeline_depth=dcn_pipeline_depth,
                        journal=journal)
