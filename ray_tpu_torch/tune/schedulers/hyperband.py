"""HyperBand — cohort-synchronous successive halving.

ray parity: python/ray/tune/schedulers/hyperband.py (HyperBandScheduler)
and hb_bohb.py (HyperBandForBOHB). Unlike ASHA (async_hyperband.py),
promotion here is SYNCHRONOUS: a rung decides only when every live member
has reported its milestone — the paper's semantics, and the contract BOHB's
per-budget model assumes (a rung's scores are complete when the KDE for
that budget trains on them).

Mechanics: trials are grouped into brackets; bracket s admits
``n_s = ceil((s_max+1)/(s+1) * eta^s)`` trials with initial budget
``r_s = max_t * eta^-s`` and halves s times. A trial reaching its rung
milestone is PAUSED (checkpoint + actor released — on a GPU the freed card
share immediately serves another trial). When the cohort completes, the top
1/eta are promoted (the controller resumes them through the
``may_resume`` gate) and the rest are stopped via ``controller.stop_trial``.
When a band's brackets are all full, the next trial opens a fresh band.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _SyncBracket:
    def __init__(self, s: int, capacity: int, r0: float, eta: float,
                 max_t: float):
        self.s = s
        self.capacity = capacity
        self.eta = eta
        # milestone of rung i = r0 * eta^i (budget is cumulative time_attr)
        self.milestones = [
            min(r0 * eta ** i, max_t) for i in range(s + 1)
        ]
        self.rung_of: Dict[str, int] = {}      # trial_id -> current rung
        self.scores: List[Dict[str, float]] = [dict() for _ in self.milestones]
        self.live: set = set()
        self.promoted: set = set()

    @property
    def full(self) -> bool:
        return len(self.rung_of) >= self.capacity

    def add(self, trial_id: str):
        self.rung_of[trial_id] = 0
        self.live.add(trial_id)

    def record(self, trial_id: str, score: float):
        self.scores[self.rung_of[trial_id]][trial_id] = score

    def cohort_complete(self, rung: int) -> bool:
        waiting = [t for t in self.live if self.rung_of[t] == rung]
        return all(t in self.scores[rung] for t in waiting)

    def promote(self, rung: int):
        """Split the rung's reporters into (winners, losers); winners move
        to the next rung. Only trials still AT this rung participate — a
        rung can settle again when stragglers join a non-full bracket
        later, and re-ranking must never touch already-promoted trials
        (demotion/double-promotion corrupted state before this filter).
        Dead trials that recorded here still count toward the quantile
        (they ran, they lost) but can't be promoted."""
        at_rung = {
            t: s for t, s in self.scores[rung].items()
            if self.rung_of.get(t) == rung
        }
        reporters = [t for t in at_rung if t in self.live]
        k = max(1, int(math.ceil(len(at_rung) / self.eta)))
        ranked = sorted(at_rung, key=at_rung.__getitem__, reverse=True)
        winner_set = set(ranked[:k])
        winners = [t for t in reporters if t in winner_set]
        losers = [t for t in reporters if t not in winner_set]
        for t in winners:
            self.rung_of[t] = rung + 1
            self.promoted.add(t)
        return winners, losers


class HyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        max_t: float = 81.0,
        reduction_factor: float = 3.0,
        stop_last_trials: bool = True,
    ):
        super().__init__(metric, mode)
        self._time_attr = time_attr
        self._max_t = max_t
        self._eta = reduction_factor
        self._stop_last_trials = stop_last_trials
        self._s_max = int(math.log(max(max_t, 1), reduction_factor))
        self._brackets: List[_SyncBracket] = []
        self._bracket_of: Dict[str, _SyncBracket] = {}

    # -- band/bracket construction -------------------------------------
    def _new_bracket(self) -> _SyncBracket:
        """Brackets are created most-exploratory-first (s = s_max .. 0);
        a full set of s_max+1 brackets forms one band."""
        idx = len(self._brackets) % (self._s_max + 1)
        s = self._s_max - idx
        n = int(math.ceil(
            (self._s_max + 1) / (s + 1) * self._eta ** s
        ))
        r0 = self._max_t * self._eta ** (-s)
        b = _SyncBracket(s, n, r0, self._eta, self._max_t)
        self._brackets.append(b)
        return b

    def on_trial_add(self, controller, trial):
        for b in self._brackets:
            if not b.full:
                b.add(trial.trial_id)
                self._bracket_of[trial.trial_id] = b
                return
        b = self._new_bracket()
        b.add(trial.trial_id)
        self._bracket_of[trial.trial_id] = b

    # -- resume gating ---------------------------------------------------
    def may_resume(self, trial) -> bool:
        """A paused trial resumes only once its cohort promoted it."""
        b = self._bracket_of.get(trial.trial_id)
        return b is None or trial.trial_id in b.promoted

    # -- result flow -----------------------------------------------------
    def on_trial_result(self, controller, trial, result: Dict) -> str:
        b = self._bracket_of.get(trial.trial_id)
        score = self._score(result)
        t = result.get(self._time_attr)
        if b is None or score is None or t is None:
            return TrialScheduler.CONTINUE
        tid = trial.trial_id
        if tid not in b.rung_of or tid not in b.live:
            return TrialScheduler.CONTINUE
        rung = b.rung_of[tid]
        if t < b.milestones[rung]:
            return TrialScheduler.CONTINUE
        b.promoted.discard(tid)  # consumed its promotion by running here
        b.record(tid, score)
        if rung == len(b.milestones) - 1 or (
            self._stop_last_trials and t >= self._max_t
        ):
            # bracket exhausted for this trial
            b.live.discard(tid)
            self._settle_cohort(controller, b, rung, exclude=tid)
            return TrialScheduler.STOP
        if not b.cohort_complete(rung):
            return TrialScheduler.PAUSE
        winners, losers = b.promote(rung)
        decision = TrialScheduler.PAUSE
        for loser in losers:
            b.live.discard(loser)
            if loser == tid:
                decision = TrialScheduler.STOP
            else:
                lt = controller.get_trial(loser)
                if lt is not None:
                    controller.stop_trial(lt)
        if tid in winners:
            # the cohort's last reporter won: keep its actor hot and run
            # straight into the next rung (everyone else resumes via gate)
            b.promoted.discard(tid)
            decision = TrialScheduler.CONTINUE
        return decision

    def _settle_cohort(self, controller, b: _SyncBracket, rung: int,
                       exclude: str):
        """A member left the rung (finished/errored); if the remaining
        cohort is now complete, run the promotion it was waiting on."""
        if rung >= len(b.milestones) - 1:
            return
        if not b.cohort_complete(rung):
            return
        waiting = [t for t in b.scores[rung] if t in b.live]
        if not waiting:
            return
        _winners, losers = b.promote(rung)
        for loser in losers:
            b.live.discard(loser)
            lt = controller.get_trial(loser)
            if lt is not None and loser != exclude:
                controller.stop_trial(lt)

    def on_trial_complete(self, controller, trial, result: Dict):
        self._drop(controller, trial)

    def on_trial_error(self, controller, trial):
        self._drop(controller, trial)

    def on_trial_remove(self, controller, trial):
        self._drop(controller, trial)

    def _drop(self, controller, trial):
        b = self._bracket_of.pop(trial.trial_id, None)
        if b is None or trial.trial_id not in b.live:
            return
        b.live.discard(trial.trial_id)
        rung = b.rung_of.get(trial.trial_id)
        if rung is not None:
            self._settle_cohort(controller, b, rung, exclude=trial.trial_id)

    def debug_string(self) -> str:
        lines = [f"HyperBand: {len(self._brackets)} brackets "
                 f"(eta={self._eta}, max_t={self._max_t})"]
        for i, b in enumerate(self._brackets):
            lines.append(
                f"  bracket {i} (s={b.s}): {len(b.rung_of)}/{b.capacity} "
                f"trials, {len(b.live)} live, milestones={b.milestones}"
            )
        return "\n".join(lines)


class HyperBandForBOHB(HyperBandScheduler):
    """BOHB's bracket scheduler (ray parity: hb_bohb.py): identical
    synchronous brackets; pair with BOHBSearcher, whose per-budget KDE
    trains on exactly the cohorts this scheduler completes."""
