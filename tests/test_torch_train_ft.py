"""Elastic fault-tolerant training in the port, the cases of
``tests/test_train_ft.py`` run through ``ray_tpu_torch``.

- ProgressWatchdog verdicts, epoch-keyed rendezvous and the abort marker
  (on a monkeypatched KV), the session drain, the executor's budget
  accounting, the faultsim ``kill`` rule and restart spans: the reference's
  units, unchanged, on the port's modules.
- Live gangs on a port cluster (CPU workers, ``use_gpu=False``): a SIGKILLed
  rank of 2 recovers from the latest checkpoint within budget; a drain
  requeues with ``max_failures=0``; an out-of-budget failure is
  ``FailureBudgetExhaustedError``. Loops are defined inside the tests so
  they travel to the port's workers by value.
- The repaired step telemetry: ``from steptrace import *`` works, and a
  kernel build (a fake nvcc) lands in the ring as a compile event once the
  session's compile listener is installed.
"""

import os
import time
import types

import pytest

import ray_tpu_torch

pytestmark = pytest.mark.train_ft


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# ProgressWatchdog units
# ---------------------------------------------------------------------------


def test_watchdog_arms_only_after_first_progress():
    from ray_tpu_torch.train.backend_executor import ProgressWatchdog

    wd = ProgressWatchdog(2, timeout_s=5.0)
    # no progress ever observed: never wedged (long jit/compile is legal)
    assert wd.wedged(now=1e9) == []
    wd.touch(0, now=100.0)
    assert wd.wedged(now=104.0) == []      # inside the window
    assert wd.wedged(now=106.0) == [0]     # stale past timeout
    wd.touch(0, now=107.0)                  # progress clears the verdict
    assert wd.wedged(now=110.0) == []
    # rank 1 never armed, stays invisible throughout
    wd.touch(1, now=107.0)
    assert wd.wedged(now=113.0) == [0, 1]


def test_watchdog_observe_requires_step_advance():
    from ray_tpu_torch.train.backend_executor import ProgressWatchdog

    wd = ProgressWatchdog(1, timeout_s=5.0)
    wd.observe(0, 0, now=10.0)              # step 0 == initial: not progress
    assert wd.wedged(now=1e9) == []
    wd.observe(0, 1, now=10.0)              # first completed step: arms
    assert wd.wedged(now=16.0) == [0]
    wd.observe(0, 1, now=20.0)              # same step again: NOT a refresh
    assert wd.wedged(now=16.5) == [0]
    wd.observe(0, 2, now=20.0)              # advance: refreshed
    assert wd.wedged(now=24.0) == []
    wd.disarm(0)                            # rank finished cleanly
    assert wd.wedged(now=1e9) == []


def test_watchdog_disabled_with_zero_timeout():
    from ray_tpu_torch.train.backend_executor import ProgressWatchdog

    wd = ProgressWatchdog(1, timeout_s=0.0)
    wd.touch(0, now=0.0)
    assert wd.wedged(now=1e9) == []


# ---------------------------------------------------------------------------
# Epoch-keyed rendezvous + abort marker (monkeypatched KV)
# ---------------------------------------------------------------------------


@pytest.fixture
def kv_store(monkeypatch):
    from ray_tpu_torch.util.collective import collective as colmod

    store = {}
    monkeypatch.setattr(colmod, "_kv_put",
                        lambda k, v: store.__setitem__(k, v))
    monkeypatch.setattr(colmod, "_kv_get", lambda k: store.get(k))

    def _del_prefix(prefix):
        for k in [k for k in store if k.startswith(prefix)]:
            del store[k]

    monkeypatch.setattr(colmod, "_kv_del_prefix", _del_prefix)
    return store


def test_epoch_keys_isolate_generations(kv_store):
    from ray_tpu_torch.util.collective import collective as colmod

    # a dead generation's rank-1 contribution sits in the KV
    stale = f"{colmod._keybase('gg', 0)}:1:ar:1".encode()
    colmod._kv_put(stale, b"stale-grad")
    # the re-formed generation's rendezvous for the SAME (seq, op, rank)
    # must not see it — its keys live under gg@1
    fresh = f"{colmod._keybase('gg', 1)}:1:ar:1".encode()
    with pytest.raises(TimeoutError):
        colmod._kv_wait(fresh, timeout=0.2)
    # while the dead generation's key is still addressable at its epoch
    assert colmod._kv_wait(stale, timeout=0.2) == b"stale-grad"


def test_abort_marker_unwedges_kv_wait(kv_store):
    from ray_tpu_torch.util.collective import collective as colmod
    from ray_tpu_torch.util.collective import CollectiveWorldChangedError

    abort_key = colmod._keybase("gg", 0).encode() + colmod._ABORT_SUFFIX
    colmod.abort_group("gg", epoch=0)
    assert kv_store.get(abort_key) is not None
    t0 = time.monotonic()
    with pytest.raises(CollectiveWorldChangedError):
        colmod._kv_wait(f"{colmod._keybase('gg', 0)}:9:ar:1".encode(),
                        timeout=30.0, abort_key=abort_key)
    # fails over within ~a poll interval, nowhere near the 30s timeout
    assert time.monotonic() - t0 < 5.0
    # without an abort_key the same wait ignores the marker entirely
    with pytest.raises(TimeoutError):
        colmod._kv_wait(f"{colmod._keybase('gg', 0)}:9:ar:1".encode(),
                        timeout=0.2)


def test_group_keybase_and_trace_name(kv_store):
    from ray_tpu_torch.util.collective import collective as colmod

    colmod.init_collective_group(2, 0, backend="store", group_name="gg",
                                 epoch=0)
    g0 = colmod._groups["gg"]
    assert g0.keybase == "gg@0"
    assert g0.trace_name == "gg"            # epoch 0 keeps the bare name
    assert f"{g0.keybase}:member:0".encode() in kv_store
    colmod.init_collective_group(2, 0, backend="store", group_name="gg",
                                 epoch=3)
    g3 = colmod._groups["gg"]
    assert g3.keybase == "gg@3"
    assert g3.trace_name == "gg@3"          # re-formed gang is visible
    # destroy wipes every epoch's keys under the name
    colmod.destroy_collective_group("gg")
    assert not [k for k in kv_store if k.startswith(b"gg@")]


# ---------------------------------------------------------------------------
# Session drain semantics (unit)
# ---------------------------------------------------------------------------


def test_session_drain_checkpoints_then_exits():
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.train import session as sess

    s = sess.init_session(sess.TrainContext(rank=0, world_size=1), None)
    try:
        assert sess.health()["active"] is True
        assert sess.request_drain() is True
        assert sess.health()["draining"] is True
        with pytest.raises(SystemExit):
            sess.report({"loss": 1.0},
                        checkpoint=Checkpoint.from_dict({"step": 0}))
        payload = s.queue.get_nowait()
        # the drain report carries the checkpoint the executor restores from
        assert payload["type"] == "report" and payload["drain"] is True
        assert payload["checkpoint_data"] == {"step": 0}
    finally:
        sess.shutdown_session()
    assert sess.request_drain() is False     # no session: SIGTERM falls back
    assert sess.health() == {"active": False}


# ---------------------------------------------------------------------------
# Recovery-loop budget accounting (unit: fake attempts, real run())
# ---------------------------------------------------------------------------


def _fake_executor(tmp_path, max_failures, outcomes):
    from ray_tpu_torch.air.config import FailureConfig, RunConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    ex = object.__new__(BackendExecutor)
    ex.run_config = RunConfig(
        failure_config=FailureConfig(max_failures=max_failures))
    ex.trial_dir = str(tmp_path)
    ex._last_metrics = None
    ex._ckpts = types.SimpleNamespace(latest=lambda: None)
    ex.worker_group = types.SimpleNamespace(generation=0)
    it = iter(outcomes)
    ex._run_attempt = lambda *a, **k: next(it)
    ex.recovered = []
    ex._recover = ex.recovered.append
    return ex


def _failed(cause):
    return {"status": "failed", "cause": cause, "error": RuntimeError(cause),
            "detected": time.time()}


def test_drain_recovery_is_budget_free(tmp_path):
    ex = _fake_executor(tmp_path, max_failures=0, outcomes=[
        {"status": "failed", "cause": "drain", "error": None,
         "detected": time.time()},
        {"status": "done"},
    ])
    result = ex.run(lambda: None)
    assert result.error is None
    assert ex.recovered == [0]               # requeued despite zero budget


def test_failure_with_no_budget_is_terminal(tmp_path):
    from ray_tpu_torch.train.backend_executor import FailureBudgetExhaustedError

    ex = _fake_executor(tmp_path, max_failures=0,
                        outcomes=[_failed("actor_died")])
    result = ex.run(lambda: None)
    assert isinstance(result.error, FailureBudgetExhaustedError)
    assert ex.recovered == []                # no re-place attempt


def test_budget_decrements_then_exhausts(tmp_path):
    from ray_tpu_torch.train.backend_executor import FailureBudgetExhaustedError

    ex = _fake_executor(tmp_path, max_failures=1,
                        outcomes=[_failed("wedged"), _failed("actor_died")])
    result = ex.run(lambda: None)
    assert isinstance(result.error, FailureBudgetExhaustedError)
    assert ex.recovered == [0]               # one funded recovery, then stop


def test_negative_budget_means_unlimited(tmp_path):
    ex = _fake_executor(tmp_path, max_failures=-1, outcomes=[
        _failed("actor_died"), _failed("wedged"), _failed("unresponsive"),
        {"status": "done"},
    ])
    result = ex.run(lambda: None)
    assert result.error is None
    assert len(ex.recovered) == 3


# ---------------------------------------------------------------------------
# faultsim "kill" kind (parse + plan only — never through rpcio here)
# ---------------------------------------------------------------------------


def test_faultsim_kill_rule_parses_and_fires():
    from ray_tpu_torch._private import faultsim

    rules = faultsim.parse_spec("execute_task:kill:1.0:7")
    assert len(rules) == 1 and rules[0].kind == "kill"
    plan = faultsim.FaultPlan(rules)
    kind, rule = plan.on_send("execute_task", None)
    assert kind == "kill" and rule.seed == 7
    # keepalives stay exempt: the failure detector must outlive the chaos
    assert plan.on_send("__ping", None) is None
    assert plan.on_send("kv_put", None) is None


# ---------------------------------------------------------------------------
# Restart spans in the train timeline
# ---------------------------------------------------------------------------


def test_restart_records_render_in_timeline():
    from ray_tpu_torch._private import steptrace

    rec = {"kind": "restart", "idx": 0, "cause": "actor_died",
           "generation": 1, "start": 10.0, "end": 12.5}
    merged = steptrace.merge_records([rec])
    assert merged["restarts"] == [rec]
    trace = steptrace.chrome_trace(merged)
    spans = [e for e in trace if e.get("cat") == "restart"]
    assert len(spans) == 1
    assert "restart[actor_died]" in spans[0]["name"]
    assert spans[0]["pid"] == -1             # the driver (recovery) row
    assert spans[0]["args"]["recovery_s"] == pytest.approx(2.5)
    assert any(e.get("ph") == "M" and e.get("pid") == -1 for e in trace)


# ---------------------------------------------------------------------------
# Live-gang integration
# ---------------------------------------------------------------------------


def _ft_counters():
    from ray_tpu_torch.train.backend_executor import _ft_metrics

    failures, restarts, hist = _ft_metrics()
    return failures, restarts, hist


def _gang_failures(failures):
    return sum(failures.labels(cause=c).value()
               for c in ("actor_died", "unresponsive", "wedged"))


def test_gang_recovers_from_rank_sigkill(port_cluster, tmp_path):
    from ray_tpu_torch import train

    def kill_recovery_loop(config):
        import os
        import signal

        from ray_tpu_torch import train
        from ray_tpu_torch.air import Checkpoint

        ctx = train.get_context()
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for step in range(start, 6):
            if (ctx.get_world_rank() == 1 and step == 2
                    and not os.path.exists(config["marker"])):
                open(config["marker"], "w").close()   # one kill per run
                os.kill(os.getpid(), signal.SIGKILL)
            train.report({"step": step, "loss": 1.0 / (step + 1),
                          "pid": os.getpid()},
                         checkpoint=Checkpoint.from_dict({"step": step}))

    failures, restarts, hist = _ft_counters()
    f0, r0 = _gang_failures(failures), restarts.default.value()
    trainer = train.DataParallelTrainer(
        kill_recovery_loop,
        train_loop_config={"marker": str(tmp_path / "killed")},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=train.RunConfig(
            name="t_ft_kill", storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=1)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 5       # resumed and finished
    assert result.metrics["pid"] != os.getpid()
    assert result.checkpoint is not None
    assert restarts.default.value() == r0 + 1
    assert _gang_failures(failures) == f0 + 1


def test_drain_requeues_without_spending_budget(port_cluster, tmp_path):
    from ray_tpu_torch import train

    def drain_loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.air import Checkpoint
        from ray_tpu_torch.train import session as sess_mod

        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            start = ck.to_dict()["step"] + 1
        for step in range(start, 4):
            if step == 1 and ck is None:
                # what the worker's SIGTERM handler does on preemption
                sess_mod.request_drain()
            train.report({"step": step},
                         checkpoint=Checkpoint.from_dict({"step": step}))

    failures, restarts, hist = _ft_counters()
    d0, r0 = failures.labels(cause="drain").value(), restarts.default.value()
    trainer = train.DataParallelTrainer(
        drain_loop,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=train.RunConfig(
            name="t_ft_drain", storage_path=str(tmp_path),
            # zero budget: completion proves the drain didn't consume any
            failure_config=train.FailureConfig(max_failures=0)),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 3       # resumed past the drained step
    assert failures.labels(cause="drain").value() == d0 + 1
    assert restarts.default.value() == r0 + 1


def test_exhausted_budget_is_terminal(port_cluster, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.train.backend_executor import FailureBudgetExhaustedError

    def always_dies_loop(config):
        import os
        import signal

        from ray_tpu_torch import train

        train.report({"step": 0})
        os.kill(os.getpid(), signal.SIGKILL)

    trainer = train.DataParallelTrainer(
        always_dies_loop,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=train.RunConfig(
            name="t_ft_exhaust", storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=0)),
    )
    result = trainer.fit()
    assert isinstance(result.error, FailureBudgetExhaustedError)


# ---------------------------------------------------------------------------
# step telemetry: the compile listener (kernel builds) and the module surface
# ---------------------------------------------------------------------------


def test_steptrace_star_import_has_every_name():
    namespace = {}
    exec("from ray_tpu_torch._private.steptrace import *", namespace)
    from ray_tpu_torch._private import steptrace

    assert set(steptrace.__all__) <= set(namespace)
    assert callable(namespace["install_compile_listener"])


def test_kernel_build_is_a_compile_event_in_the_session_ring(
        tmp_path, monkeypatch):
    import subprocess

    from ray_tpu_torch._private import steptrace
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.train import session as sess

    def fake_nvcc(cmd, **kw):  # writes the library nvcc would have built
        time.sleep(0.01)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"not a real library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(steptrace, "_compile_listener_installed", False)
    steptrace.reset()
    source = tmp_path / "fake_kernel.cu"
    source.write_text("// a kernel")
    _build.build(source)                    # no session: not recorded
    assert not [r for r in steptrace.snapshot() if r["kind"] == "compile"]
    source.write_text("// a kernel, edited")
    sess.init_session(sess.TrainContext(rank=1, world_size=2), None)
    try:
        t0 = time.time()
        path, seconds = _build.build(source)
        assert path.exists() and seconds > 0
        _build.build(source)                # cached: nvcc does not run
    finally:
        sess.shutdown_session()
    compiles = [r for r in steptrace.snapshot() if r["kind"] == "compile"]
    assert len(compiles) == 1
    rec = compiles[0]
    assert rec["name"] == "fake_kernel" and rec["first"] is True
    assert rec["rank"] == 1
    assert t0 <= rec["start"] < rec["end"] <= time.time()
