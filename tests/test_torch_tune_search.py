"""The port's searchers and schedulers on the CPU, beside the reference's.

The cases of ``tests/test_hyperband.py``, ``test_tpe.py``, ``test_bohb.py``
and ``test_pb2.py`` run through ``ray_tpu_torch.tune``. Where the outcome is
deterministic the same program also runs through ``ray_tpu.tune`` and the
two are held to each other: TPE, BOHB and PB2 suggestions under one seed,
and the decisions of ASHA, HyperBand, the median-stopping rule and PBT on
one stream of results (made with numpy from a seed). The end-to-end cases
run on one module-scoped port cluster.
"""

import importlib
import math
import random
import statistics

import numpy as np
import pytest

import ray_tpu_torch

PKGS = ("ray_tpu_torch", "ray_tpu")


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn):
    """``fn(pkg)`` through both packages; the port's value, after holding
    it equal to the reference's."""
    port, ref = (fn(pkg) for pkg in PKGS)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# the cases of tests/test_hyperband.py
# ---------------------------------------------------------------------------

class _FakeTrial:
    def __init__(self, tid, config=None):
        self.trial_id = tid
        self.last_result = {}
        self.status = "RUNNING"
        self.config = dict(config or {})


class _FakeController:
    def __init__(self, trials):
        self._trials = {t.trial_id: t for t in trials}
        self.stopped = []
        self.exploits = []

    def get_trial(self, tid):
        return self._trials.get(tid)

    def stop_trial(self, trial, result=None):
        self.stopped.append(trial.trial_id)

    def exploit_trial(self, trial, donor, new_config):
        self.exploits.append((trial.trial_id, donor.trial_id,
                              dict(new_config)))
        trial.config = dict(new_config)


def _result(it, score):
    return {"training_iteration": it, "score": score}


def _hb(pkg):
    return _mod(pkg, "tune.schedulers").HyperBandScheduler(
        metric="score", mode="max", max_t=9.0, reduction_factor=3.0)


def test_bracket_geometry():
    def geometry(pkg):
        hb = _hb(pkg)
        trials = [_FakeTrial(f"t{i}") for i in range(12)]
        ctl = _FakeController(trials)
        for t in trials:
            hb.on_trial_add(ctl, t)
        b0, b1 = hb._brackets[0], hb._brackets[1]
        return (len(hb._brackets), b0.capacity, b0.milestones, b1.capacity,
                b1.milestones)

    # s_max=2: bracket 0 (s=2) n=9 r0=1; bracket 1 (s=1) n=5 r0=3
    assert _both(geometry) == (2, 9, [1.0, 3.0, 9.0], 5, [3.0, 9.0])


def test_synchronous_promotion_waits_for_cohort():
    """No trial advances past a rung until EVERY live member reported —
    the defining difference from ASHA."""
    def drive(pkg):
        ts = _mod(pkg, "tune.schedulers.trial_scheduler").TrialScheduler
        hb = _hb(pkg)
        trials = [_FakeTrial(f"t{i}") for i in range(9)]
        ctl = _FakeController(trials)
        for t in trials:
            hb.on_trial_add(ctl, t)
        for i in range(8):
            d = hb.on_trial_result(ctl, trials[i], _result(1, score=i))
            assert d == ts.PAUSE, (i, d)
            assert not hb.may_resume(trials[i])
        assert ctl.stopped == []
        d = hb.on_trial_result(ctl, trials[8], _result(1, score=100))
        assert d == ts.CONTINUE  # last reporter won: stays hot
        assert sorted(ctl.stopped) == [f"t{i}" for i in range(6)]
        assert hb.may_resume(trials[6]) and hb.may_resume(trials[7])
        return d, sorted(ctl.stopped), [hb.may_resume(t) for t in trials]

    _both(drive)


def test_dead_member_does_not_block_cohort():
    def drive(pkg):
        hb = _hb(pkg)
        trials = [_FakeTrial(f"t{i}") for i in range(9)]
        ctl = _FakeController(trials)
        for t in trials:
            hb.on_trial_add(ctl, t)
        for i in range(8):
            hb.on_trial_result(ctl, trials[i], _result(1, score=i))
        hb.on_trial_error(ctl, trials[8])
        assert sorted(ctl.stopped) == [f"t{i}" for i in range(5)]
        assert hb.may_resume(trials[6]) and hb.may_resume(trials[7])
        return sorted(ctl.stopped), [hb.may_resume(t) for t in trials]

    _both(drive)


def test_straggler_join_does_not_corrupt_settled_rung():
    """A trial joining a non-full bracket after its rung-0 cohort settled
    is ranked on its own cohort and never demotes a promoted trial."""
    def drive(pkg):
        ts = _mod(pkg, "tune.schedulers.trial_scheduler").TrialScheduler
        hb = _hb(pkg)
        a, b_ = _FakeTrial("a"), _FakeTrial("b")
        ctl = _FakeController([a, b_])
        hb.on_trial_add(ctl, a)
        hb.on_trial_add(ctl, b_)
        bracket = hb._brackets[0]
        hb.on_trial_result(ctl, b_, _result(1, score=1.0))
        d = hb.on_trial_result(ctl, a, _result(1, score=5.0))
        assert d == ts.CONTINUE
        assert bracket.rung_of["a"] == 1 and "b" not in bracket.live
        c = _FakeTrial("c")
        ctl._trials["c"] = c
        hb.on_trial_add(ctl, c)
        assert hb._bracket_of["c"] is bracket
        hb.on_trial_result(ctl, c, _result(1, score=99.0))
        assert bracket.rung_of["a"] == 1
        assert "a" not in ctl.stopped
        return dict(bracket.rung_of), sorted(ctl.stopped)

    _both(drive)


def test_hyperband_e2e_tuner(port_cluster):
    """End-to-end through Tuner: separable objective, HyperBand finds a
    near-optimal x while stopping most trials early."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.schedulers import HyperBandScheduler

    def objective(config):
        for it in range(1, 10):
            tune.report({"loss": (config["x"] - 0.7) ** 2 + 1.0 / it,
                         "training_iteration": it})

    tuner = Tuner(
        objective,
        param_space={"x": tune.uniform(-2, 2)},
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=14,
            search_alg=None,
            scheduler=HyperBandScheduler(
                time_attr="training_iteration", max_t=9, reduction_factor=3
            ),
        ),
    )
    results = tuner.fit()
    best = results.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 1.6, best.metrics
    iters = [r.metrics.get("training_iteration", 0) for r in results]
    assert min(iters) < 9, iters


# ---------------------------------------------------------------------------
# the cases of tests/test_tpe.py
# ---------------------------------------------------------------------------

def _run_searcher(searcher, objective, space, n_trials):
    searcher.set_search_properties("loss", "min", space)
    best, configs = float("inf"), []
    for i in range(n_trials):
        tid = f"t{i}"
        config = searcher.suggest(tid)
        configs.append(config)
        loss = objective(config)
        best = min(best, loss)
        searcher.on_trial_complete(tid, result={"loss": loss})
    return best, configs


def test_flatten_roundtrip():
    space = {"a": 1, "b": {"c": 2, "d": {"e": 3}}}

    def roundtrip(pkg):
        tpe = _mod(pkg, "tune.search.tpe")
        flat = tpe._flatten(space)
        assert tpe._unflatten(flat) == space
        return flat

    _both(roundtrip)


def _quadratic(cfg):
    return (cfg["x"] - 1.7) ** 2 + (cfg["y"] + 0.4) ** 2


def test_tpe_beats_random_on_quadratic():
    """Same budget, same objective: TPE's best-found beats random search on
    average; under one seed the port suggests the reference's configs."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import TPESearcher

    space = {"x": tune.uniform(-5, 5), "y": tune.uniform(-5, 5)}
    tpe_bests, rand_bests = [], []
    for seed in range(5):
        best, _ = _run_searcher(TPESearcher(n_initial_points=8, seed=seed),
                                _quadratic, space, 60)
        tpe_bests.append(best)
        rng = random.Random(seed + 1000)
        best = float("inf")
        for _ in range(60):
            cfg = {k: d.sample(rng) for k, d in space.items()}
            best = min(best, _quadratic(cfg))
        rand_bests.append(best)
    assert statistics.fmean(tpe_bests) < statistics.fmean(rand_bests), (
        tpe_bests, rand_bests,
    )

    def suggestions(pkg):
        t = _mod(pkg, "tune")
        searcher = _mod(pkg, "tune.search").TPESearcher(n_initial_points=8,
                                                        seed=3)
        return _run_searcher(searcher, _quadratic,
                             {"x": t.uniform(-5, 5), "y": t.uniform(-5, 5)},
                             30)

    _both(suggestions)


def _all_kinds_space(t):
    return {
        "lr": t.loguniform(1e-5, 1e-1),
        "layers": t.randint(1, 8),
        "opt": t.choice(["adam", "sgd", "lamb"]),
        "drop": t.quniform(0.0, 0.5, 0.1),
        "noise": t.randn(0.0, 1.0),
        "fixed": 42,
        "derived": t.sample_from(lambda spec: spec["fixed"] * 2),
        "nested": {"width": t.lograndint(16, 1024)},
    }


def test_tpe_handles_all_domain_kinds():
    def objective(cfg):
        assert 1e-5 <= cfg["lr"] <= 1e-1
        assert 1 <= cfg["layers"] < 8 and isinstance(cfg["layers"], int)
        assert cfg["opt"] in ("adam", "sgd", "lamb")
        assert abs(cfg["drop"] * 10 - round(cfg["drop"] * 10)) < 1e-9
        assert cfg["fixed"] == 42
        assert cfg["derived"] == 84
        assert 16 <= cfg["nested"]["width"] <= 1024
        return cfg["lr"] * cfg["layers"]

    def drive(pkg):
        searcher = _mod(pkg, "tune.search").TPESearcher(n_initial_points=5,
                                                        seed=3)
        return _run_searcher(searcher, objective,
                             _all_kinds_space(_mod(pkg, "tune")), 25)

    best, _ = _both(drive)
    assert best < 1.0


def test_tpe_respects_mode_max():
    def drive(pkg):
        t = _mod(pkg, "tune")
        tpe = _mod(pkg, "tune.search").TPESearcher(n_initial_points=6,
                                                   seed=7)
        tpe.set_search_properties("score", "max", {"x": t.uniform(-5, 5)})
        xs = []
        for i in range(40):
            config = tpe.suggest(f"t{i}")
            score = -((config["x"] - 2.0) ** 2)  # maximum at x=2
            tpe.on_trial_complete(f"t{i}", result={"score": score})
            xs.append(config["x"])
        return xs

    late = _both(drive)[-10:]
    assert abs(statistics.fmean(late) - 2.0) < 1.5, late


def test_tpe_in_tuner(port_cluster):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import TPESearcher

    def objective(config):
        tune.report({"loss": (config["x"] - 0.5) ** 2})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.uniform(-2, 2)},
        tune_config=tune.TuneConfig(
            num_samples=12, metric="loss", mode="min",
            search_alg=TPESearcher(n_initial_points=4, seed=0),
        ),
    )
    grid = tuner.fit()
    assert len(grid) == 12 and grid.num_errors == 0
    assert grid.get_best_result().metrics["loss"] < 1.0


# ---------------------------------------------------------------------------
# the cases of tests/test_bohb.py
# ---------------------------------------------------------------------------

def _multi_fidelity_objective(cfg, budget):
    quality = (cfg["x"] - 1.2) ** 2 + (cfg["y"] + 2.0) ** 2
    return quality + 4.0 / budget


def _run_bohb(searcher, t, n_trials, max_budget=9, rf=3.0, cohort=8,
              seed=0):
    """Successive halving by hand (``tests/test_bohb.py``'s driver): trials
    run in cohorts, the better 1/rf of each rung advances, every stop is
    reported. Returns (best, iterations spent, every suggestion)."""
    searcher.set_search_properties(
        "loss", "min", {"x": t.uniform(-5, 5), "y": t.uniform(-5, 5)})
    rng = random.Random(seed)
    best, consumed, suggested = float("inf"), 0, []
    remaining, counter = n_trials, 0
    while remaining > 0:
        size = min(cohort, remaining)
        remaining -= size
        live = []
        for _ in range(size):
            tid = f"t{counter}"
            counter += 1
            live.append((tid, searcher.suggest(tid)))
            suggested.append(live[-1][1])
        budget, prev_budget = 1, 0
        while live:
            consumed += (budget - prev_budget) * len(live)
            scored = []
            for tid, cfg in live:
                loss = _multi_fidelity_objective(cfg, budget)
                searcher.on_trial_result(
                    tid, {"loss": loss, "training_iteration": budget})
                scored.append((loss, rng.random(), tid, cfg))
            scored.sort(key=lambda s: s[:3])
            if budget >= max_budget:
                for loss, _r, tid, cfg in scored:
                    best = min(best, loss)
                    searcher.on_trial_complete(
                        tid, result={"loss": loss,
                                     "training_iteration": budget})
                break
            keep = max(1, int(len(scored) / rf))
            for loss, _r, tid, cfg in scored[keep:]:
                best = min(best, loss)
                searcher.on_trial_complete(
                    tid, result={"loss": loss, "training_iteration": budget})
            live = [(tid, cfg) for _l, _r, tid, cfg in scored[:keep]]
            prev_budget = budget
            budget = int(budget * rf)
    return best, consumed, suggested


def test_bohb_beats_random_at_equal_budget():
    """Equal total compute: random search gets consumed/max_budget full-
    fidelity evaluations; under one seed the port's BOHB suggests the
    reference's configs."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.search import BOHBSearcher

    bohb_bests, rand_bests = [], []
    for seed in range(8):
        best, consumed, _ = _run_bohb(
            BOHBSearcher(n_initial_points=8, seed=seed), tune, 50, seed=seed)
        bohb_bests.append(best)
        rng = random.Random(seed + 500)
        best = float("inf")
        for _ in range(max(1, consumed // 9)):
            cfg = {"x": rng.uniform(-5, 5), "y": rng.uniform(-5, 5)}
            best = min(best, _multi_fidelity_objective(cfg, 9))
        rand_bests.append(best)
    assert statistics.fmean(bohb_bests) < statistics.fmean(rand_bests), (
        bohb_bests, rand_bests,
    )

    def suggestions(pkg):
        searcher = _mod(pkg, "tune.search").BOHBSearcher(n_initial_points=8,
                                                         seed=5)
        return _run_bohb(searcher, _mod(pkg, "tune"), 40, seed=5)

    _both(suggestions)


def test_bohb_models_highest_qualified_budget():
    """The KDE model comes from the largest budget with enough data,
    never pooled across fidelities."""
    def drive(pkg):
        t = _mod(pkg, "tune")
        bohb = _mod(pkg, "tune.search").BOHBSearcher(n_initial_points=4,
                                                     seed=0)
        bohb.set_search_properties("loss", "min", {"x": t.uniform(0, 1)})
        for i in range(6):
            tid = f"t{i}"
            bohb.suggest(tid)
            bohb.on_trial_result(tid, {"loss": 1.0, "training_iteration": 1})
            if i < 3:  # only 3 trials reached budget 3
                bohb.on_trial_result(tid, {"loss": 0.5,
                                           "training_iteration": 3})
            bohb.on_trial_complete(tid, {"loss": 1.0,
                                         "training_iteration": 1})
        obs = bohb._model_obs()
        assert obs is not None
        # 6 observations at budget 1 qualify (need = max(1+2, 4) = 4);
        # budget 3 has only 3 and must not be chosen
        assert len(obs) == 6
        assert all(v == 1.0 for _c, v in obs)
        return [v for _c, v in obs]

    _both(drive)


def test_external_adapter_worked_example():
    """The adapter's docstring example (simulated annealing), end to end,
    the same tells and asks through both packages."""

    class Annealer:
        def __init__(self, lo, hi, seed=0):
            self.rng = random.Random(seed)
            self.lo, self.hi = lo, hi
            self.best_x, self.best_v, self.temp = None, math.inf, 1.0

        def ask(self):
            if self.best_x is None:
                return {"x": self.rng.uniform(self.lo, self.hi)}
            span = (self.hi - self.lo) * self.temp
            x = min(max(self.best_x + self.rng.gauss(0, span), self.lo),
                    self.hi)
            return {"x": x}

        def tell(self, config, value, error=False):
            self.temp *= 0.9
            if not error and value < self.best_v:
                self.best_x, self.best_v = config["x"], value

    def drive(pkg):
        search = _mod(pkg, "tune.search")
        ann = Annealer(lo=-5.0, hi=5.0, seed=3)
        adapter = search.ExternalSearcherAdapter(ann, metric="loss",
                                                 mode="min")
        best, xs = float("inf"), []
        for i in range(40):
            tid = f"t{i}"
            cfg = adapter.suggest(tid)
            loss = (cfg["x"] - 2.5) ** 2
            best = min(best, loss)
            xs.append(cfg["x"])
            adapter.on_trial_complete(tid, result={"loss": loss})
        assert best < 0.5  # annealing actually informed by tells
        assert ann.best_x is not None
        # exhaustion: ask() returning None finishes the search
        adapter2 = search.ExternalSearcherAdapter(
            ask=lambda: None, metric="loss", mode="min")
        searcher = _mod(pkg, "tune.search.searcher").Searcher
        assert adapter2.suggest("t0") == searcher.FINISHED
        return xs

    _both(drive)


def test_bohb_with_tuner_and_hb_scheduler(port_cluster):
    """End-to-end: Tuner + HyperBandForBOHB + BOHBSearcher converge on a
    seeded objective."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.schedulers import HyperBandForBOHB
    from ray_tpu_torch.tune.search import BOHBSearcher

    def objective(config):
        for it in range(1, 10):
            loss = (config["x"] - 0.6) ** 2 + 2.0 / it
            tune.report({"loss": loss, "training_iteration": it})

    tuner = Tuner(
        objective,
        param_space={"x": tune.uniform(-3, 3)},
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=16,
            search_alg=BOHBSearcher(n_initial_points=6, seed=11),
            scheduler=HyperBandForBOHB(
                time_attr="training_iteration", max_t=9,
                reduction_factor=3,
            ),
        ),
    )
    results = tuner.fit()
    best = results.get_best_result(metric="loss", mode="min")
    assert best.metrics["loss"] < 1.5, best.metrics


# ---------------------------------------------------------------------------
# the cases of tests/test_pb2.py
# ---------------------------------------------------------------------------

def test_pb2_requires_bounds():
    from ray_tpu_torch.tune.schedulers import PB2

    with pytest.raises(ValueError):
        PB2(metric="score", mode="max")


def test_pb2_explored_configs_respect_bounds(port_cluster):
    from ray_tpu_torch import air, tune
    from ray_tpu_torch.tune.schedulers import PB2

    def objective(config):
        from ray_tpu_torch import air, tune

        ck = tune.get_checkpoint()
        base = ck.to_dict()["score"] if ck else 0.0
        for _ in range(12):
            base += config["rate"]
            tune.report(
                {"score": base},
                checkpoint=air.Checkpoint.from_dict({"score": base}),
            )

    pb2 = PB2(
        metric="score",
        mode="max",
        perturbation_interval=3,
        hyperparam_bounds={"rate": [0.1, 2.0]},
        seed=0,
    )
    grid = tune.Tuner(
        objective,
        param_space={"rate": tune.grid_search([0.1, 0.2, 1.0, 1.8])},
        tune_config=tune.TuneConfig(
            scheduler=pb2, max_concurrent_trials=4, metric="score",
            mode="max",
        ),
        run_config=air.RunConfig(stop={"training_iteration": 12}),
    ).fit()
    for res in grid:
        rate = res.config.get("rate")
        assert rate is None or 0.1 <= rate <= 2.0, rate
    assert grid.get_best_result().metrics["score"] > 1.0


def test_pb2_exploit_path_deterministic():
    """Two trials with a clear score gap at an interval boundary trigger a
    GP-explored exploit within bounds; the reference makes the same one."""
    def drive(pkg):
        pb2 = _mod(pkg, "tune.schedulers").PB2(
            metric="score", mode="max", perturbation_interval=6,
            hyperparam_bounds={"rate": [0.1, 2.0]}, seed=0)
        lo = _FakeTrial("lo", {"rate": 0.1})
        hi = _FakeTrial("hi", {"rate": 1.9})
        ctl = _FakeController([lo, hi])
        pb2.on_trial_add(ctl, lo)
        pb2.on_trial_add(ctl, hi)
        for t in range(1, 8):
            pb2.on_trial_result(ctl, hi, {"score": 2.0 * t,
                                          "training_iteration": t})
            pb2.on_trial_result(ctl, lo, {"score": 0.1 * t,
                                          "training_iteration": t})
        assert len(pb2._y) >= 4  # GP path active at the asserted exploit
        assert pb2.num_perturbations > 0
        assert ctl.exploits, "bottom-quantile trial never exploited"
        tid, donor, new_config = ctl.exploits[0]
        assert (tid, donor) == ("lo", "hi")
        assert 0.1 <= new_config["rate"] <= 2.0
        return ctl.exploits

    _both(drive)


def test_pb2_gp_picks_high_ucb_region():
    """With clear observations (high rate -> high improvement), the GP
    explore step selects from the high region; the reference picks the
    same rates under the same seed."""
    def drive(pkg):
        pb2 = _mod(pkg, "tune.schedulers").PB2(
            metric="score", mode="max",
            hyperparam_bounds={"rate": [0.0, 1.0]}, seed=1)
        for t in range(20):
            r = (t % 10) / 10.0
            pb2._X.append([float(t), r])
            pb2._y.append(r)
            pb2._now_t = float(t)
        return [pb2._make_explored_config({"rate": 0.5})["rate"]
                for _ in range(5)]

    picks = _both(drive)
    assert sum(p > 0.6 for p in picks) >= 4, picks


# ---------------------------------------------------------------------------
# scheduler decisions on one stream of results, both packages
# ---------------------------------------------------------------------------

def _stream(seed, n_trials=8, t_max=12):
    """Results of ``n_trials`` trials interleaved in a random order (numpy
    ``seed``): each trial's score rises at its own rate with noise."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.1, 2.0, n_trials)
    noise = rng.normal(0.0, 0.3, (n_trials, t_max))
    order = [i for i in range(n_trials) for _ in range(t_max)]
    order = [order[j] for j in rng.permutation(len(order))]
    seen = [0] * n_trials
    out = []
    for i in order:
        seen[i] += 1
        t = seen[i]
        out.append((i, t, float(rates[i] * t + noise[i, t - 1])))
    return [float(r) for r in rates], out


def _schedulers(pkg, name):
    s = _mod(pkg, "tune.schedulers")
    if name == "asha":
        return s.ASHAScheduler(metric="score", mode="max", max_t=12,
                               grace_period=1, reduction_factor=2,
                               brackets=2)
    if name == "median":
        return s.MedianStoppingRule(metric="score", mode="max",
                                    grace_period=2, min_samples_required=3)
    if name == "hyperband":
        return s.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                    reduction_factor=3)
    return s.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": [0.1, 0.5, 1.0, 2.0],
                              "decay": _mod(pkg, "tune").uniform(0.0, 1.0)},
        resample_probability=0.5, seed=4)


@pytest.mark.parametrize("name", ["asha", "median", "hyperband", "pbt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_match_the_reference(name, seed):
    """The same results, in the same order, to each package's scheduler:
    the same decision for every result, the same trials stopped by the
    controller and the same PBT exploits (donor and explored config)."""
    def drive(pkg):
        random.seed(seed)  # PBT resamples a domain through `random`
        rates, stream = _stream(seed)
        sched = _schedulers(pkg, name)
        trials = [_FakeTrial(f"t{i}", {"rate": 0.5, "decay": 0.5})
                  for i in range(len(rates))]
        ctl = _FakeController(trials)
        for t in trials:
            sched.on_trial_add(ctl, t)
        done, decisions = set(), []
        for i, t, score in stream:
            tid = f"t{i}"
            if tid in done or tid in ctl.stopped:
                continue
            d = sched.on_trial_result(ctl, trials[i], _result(t, score))
            decisions.append((tid, t, d))
            if d == "STOP" or t == 12:
                done.add(tid)
                sched.on_trial_complete(ctl, trials[i], _result(t, score))
        return decisions, sorted(ctl.stopped), ctl.exploits

    decisions, stopped, exploits = _both(drive)
    kinds = {d for _, _, d in decisions}
    if name in ("asha", "median"):
        assert "STOP" in kinds
    if name == "hyperband":
        assert "PAUSE" in kinds and stopped
    if name == "pbt":
        assert exploits
