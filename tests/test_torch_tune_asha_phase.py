"""``chip_smoke.py`` phase 21's grid against the order in which its trials
reach ASHA's rungs. Four trials run at once and may reach each rung worst
first, and then ASHA rightly stops none of them; the fifth trial, the
grid's lowest lr, starts only when one of the four ends and is stopped at
the first rung whatever order the four arrived in."""

import itertools

import pytest

import chip_smoke
from ray_tpu_torch.tune.schedulers import ASHAScheduler
from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler

CFG = chip_smoke.TUNE_ASHA
WAVE, FIFTH = CFG["lrs"][:CFG["concurrent"]], CFG["lrs"][CFG["concurrent"]:]
# loss falls by this much a step at each lr: the order of phase 21's
# losses on the card at its rungs (1e-4 lowest, then 1e-3, 3e-6, 1e-7;
# 1e-8, the fifth, highest)
DROP = {1e-4: 1.0, 1e-3: 0.5, 3e-6: 0.1, 1e-7: 3e-3, 1e-8: 3e-4}


class _Trial:
    def __init__(self, lr):
        self.trial_id = str(lr)


def _run(order, with_fifth=True):
    """The wave's trials report one step each in ``order``, step after
    step; once a trial ends, the fifth starts and reports every step at
    once, before the wave's next. Returns {lr: the step ASHA stopped it
    at below max_t}."""
    sched = ASHAScheduler(metric="loss", mode="min",
                          time_attr="training_iteration",
                          max_t=CFG["max_t"],
                          grace_period=CFG["grace_period"],
                          reduction_factor=CFG["reduction_factor"])
    for lr in CFG["lrs"] if with_fifth else WAVE:
        sched.on_trial_add(None, _Trial(lr))
    running, stopped = list(order), {}
    waiting = list(FIFTH) if with_fifth else []

    def report(lr, t):
        result = {"training_iteration": t, "loss": 7.5 - DROP[lr] * t}
        if sched.on_trial_result(None, _Trial(lr), result) == \
                TrialScheduler.STOP:
            if t < CFG["max_t"]:
                stopped[lr] = t
            return True
        return False

    for t in range(1, CFG["max_t"] + 1):
        for lr in list(running):
            if report(lr, t):
                running.remove(lr)
        while waiting and len(running) < CFG["concurrent"]:
            lr = waiting.pop(0)
            for u in range(1, CFG["max_t"] + 1):
                if report(lr, u):
                    break
    return stopped


def test_the_fifth_lr_is_the_grids_lowest_and_waits_for_a_slot():
    assert len(CFG["lrs"]) == CFG["concurrent"] + 1
    assert FIFTH == (min(CFG["lrs"]),)
    assert DROP[FIFTH[0]] == min(DROP.values())


@pytest.mark.parametrize("order", list(itertools.permutations(WAVE)),
                         ids=lambda o: "-".join(f"{lr:g}" for lr in o))
def test_asha_stops_the_fifth_at_the_first_rung_in_any_arrival_order(order):
    assert _run(order).get(FIFTH[0]) == CFG["grace_period"]


def test_the_wave_alone_arriving_worst_first_has_no_trial_stopped():
    worst_first = tuple(sorted(WAVE, key=lambda lr: DROP[lr]))
    assert _run(worst_first, with_fifth=False) == {}
    assert _run(worst_first[::-1], with_fifth=False) != {}
