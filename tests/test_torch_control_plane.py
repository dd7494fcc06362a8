"""The port's counterpart of ``tests/test_control_plane.py`` (15 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

``test_lint_hotpath_gate`` runs the port's own copy of the lint,
``ray_tpu_torch/tools/lint_hotpath.py``, over the port's marked files.

The reference's description:

Control-plane fast path: pinned invariants.

The submit->lease->dispatch fast path is a perf change; these tests pin
the SEMANTICS the optimization must not bend:

  - block-minted binary task/object ids stay unique and layout-compatible
    with the id classes;
  - the receiver-side idempotency cache stays bounded without ever
    evicting an in-flight (pending) entry;
  - the submit_batch idem key covers the WHOLE frame (first, last, len) —
    the first-spec-only key deduped a regrouped retry frame wrong;
  - a retry storm (same frame delivered repeatedly, same idem token) and
    wire-level dup/delay chaos on the batched-ack lane stay exactly-once;
  - per-callsite templates are cached, invalidated by .options(), and
    never ride a pickle;
  - the lease grace window reuses grants instead of re-leasing per call;
  - failures still surface through the fire-and-forget ack="batch" lane;
  - >=64KB array args stay zero-copy (inline wire form shares memory);
  - ray_tpu_torch/tools/lint_hotpath.py (the port's copy of
    scripts/lint_hotpath.py) guards the marked hot sections.
"""

import asyncio
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import faultsim
from ray_tpu_torch._private import metrics_core as mc
from ray_tpu_torch._private import rpcio
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import (
    ACTOR_ID_UNIQUE_BYTES,
    TASK_ID_SIZE,
    ActorID,
    JobID,
    ObjectID,
    TaskID,
    TaskIDMinter,
    object_id_binary,
)

from tests.torch_fixtures import port_regular  # noqa: F401

# chaos + monkeypatched submit plumbing mutate driver-global state: build
# a private cluster and tear it down after this module

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faultsim():
    yield
    faultsim.clear()
    faultsim.set_self_id(f"pid:{os.getpid()}")


# ------------------------------------------------------------ id minting --


def test_task_id_minter_unique_and_layout():
    job = JobID.from_int(7)
    minter = TaskIDMinter.for_job(job)
    minted = {minter.next_binary() for _ in range(10_000)}
    assert len(minted) == 10_000  # block refills never repeat an id
    for b in list(minted)[:64]:
        assert len(b) == TASK_ID_SIZE
        t = TaskID(b)
        # same layout the one-off constructor produces: driver tasks carry
        # the nil-actor sentinel + job id in the suffix
        assert t.job_id() == job
        assert t.actor_id().binary()[:ACTOR_ID_UNIQUE_BYTES] == (
            b"\xff" * ACTOR_ID_UNIQUE_BYTES
        )

    actor = ActorID.of(job)
    t = TaskID(TaskIDMinter.for_actor(actor).next_binary())
    assert t.actor_id() == actor
    assert t.job_id() == job


def test_task_id_minter_thread_safe():
    minter = TaskIDMinter.for_job(JobID.from_int(1))
    per_thread = [set() for _ in range(4)]

    def mint(bucket):
        for _ in range(5_000):
            bucket.add(minter.next_binary())

    threads = [threading.Thread(target=mint, args=(b,)) for b in per_thread]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    total = sum(len(b) for b in per_thread)
    union = set().union(*per_thread)
    # an id handed to two threads (torn block refill) would collapse the
    # union below the per-thread total
    assert total == 20_000
    assert len(union) == total


def test_object_id_binary_matches_object_id():
    t = TaskID.for_task(JobID.from_int(3))
    for index in (0, 1, 2, 255, 256, 70_000):
        assert object_id_binary(t.binary(), index) == (
            ObjectID.from_index(t, index).binary()
        )


# ------------------------------------------- receiver-side idem cache --


def test_idem_cache_bounded_and_pending_survives_eviction():
    async def run():
        pending_tok = ("t-pending", os.getpid())
        pending_fut, owner = rpcio._idem_claim(pending_tok)
        assert owner
        # churn far past the cap with completed entries
        toks = [("t-churn", os.getpid(), i)
                for i in range(rpcio._IDEM_MAX + 512)]
        for tok in toks:
            fut, owner = rpcio._idem_claim(tok)
            assert owner
            fut.set_result(tok)
        # bounded: the ring evicted completed entries instead of growing
        assert len(rpcio._idem_results) <= rpcio._IDEM_MAX + 16
        # the pending entry survived the churn (evicting it would let a
        # retry double-execute), and a duplicate claim is NOT an owner
        dup_fut, dup_owner = rpcio._idem_claim(pending_tok)
        assert dup_fut is pending_fut
        assert not dup_owner
        pending_fut.set_result(None)
        rpcio._idem_forget(pending_tok)
        for tok in toks:
            rpcio._idem_forget(tok)

    asyncio.run(run())


# ------------------------------------------------ batched submit lane --


def _append_line(path):
    # O_APPEND single short write: atomic across worker processes
    with open(path, "a") as f:
        f.write(f"{os.getpid()}\n")


def test_submit_batch_idem_key_covers_whole_frame(port_regular,
                                                  monkeypatch):
    """Regression: the idem key must identify the full frame (first, last,
    len), not just batch[0] — a grown retry frame sharing its head with an
    earlier frame must not alias its cached ack."""
    import ray_tpu_torch._private.worker as worker_mod

    real = worker_mod.call_with_retries
    seen = []

    async def spy(get_conn, method, payload=None, **kw):
        if method == "submit_batch":
            seen.append((list(payload["specs"]), kw.get("idem")))
        return await real(get_conn, method, payload, **kw)

    monkeypatch.setattr(worker_mod, "call_with_retries", spy)

    @ray_tpu_torch.remote
    def echo(x):
        return x

    refs = [echo.options(scheduling_strategy="SPREAD").remote(i)
            for i in range(6)]
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(6))

    assert seen, "SPREAD tasks must route through the submit_batch lane"
    keys = set()
    for specs, idem in seen:
        assert idem == ("submit_batch", specs[0].task_id,
                        specs[-1].task_id, len(specs), specs[0].attempt)
        keys.add(idem)
    assert len(keys) == len(seen)  # distinct frames -> distinct keys


def test_retry_storm_on_batched_ack_lane_executes_once(port_regular,
                                                       monkeypatch,
                                                       tmp_path):
    """Deliver every submit_batch frame three times with the SAME idem
    token — the wire pattern of a driver whose acks were lost mid-retry.
    The raylet's idem cache must execute the frame once."""
    import ray_tpu_torch._private.worker as worker_mod

    real = worker_mod.call_with_retries
    storms = []

    async def storm(get_conn, method, payload=None, **kw):
        if method != "submit_batch":
            return await real(get_conn, method, payload, **kw)
        r1 = await real(get_conn, method, payload, **kw)
        r2 = await real(get_conn, method, payload, **kw)
        r3 = await real(get_conn, method, payload, **kw)
        storms.append(kw.get("idem"))
        assert r1 == r2 == r3  # duplicates re-send the first ack
        return r3

    monkeypatch.setattr(worker_mod, "call_with_retries", storm)

    marker = tmp_path / "ran.txt"

    @ray_tpu_torch.remote
    def mark(path):
        _append_line(path)
        return 1

    n = 8
    refs = [mark.options(scheduling_strategy="SPREAD").remote(str(marker))
            for _ in range(n)]
    assert ray_tpu_torch.get(refs, timeout=60) == [1] * n
    assert storms, "storm wrapper never saw a submit_batch frame"
    time.sleep(0.5)  # let any (wrongly) re-scheduled duplicates land
    assert len(marker.read_text().splitlines()) == n


@pytest.mark.parametrize("spec", [
    "submit_batch:dup:1.0:5",        # every frame duplicated on the wire
    "submit_batch:delay:1.0:2:40",   # every frame delayed 40ms
])
def test_chaos_on_batched_ack_lane_exactly_once(port_regular, tmp_path,
                                                spec):
    """Wire-level chaos (the RAY_TPU_TORCH_RPC_FAULTS machinery) on the
    fire-and-forget submit lane: duplicated frames are suppressed by msg-id
    dedup, delayed frames just arrive late — either way each task runs
    exactly once."""
    faultsim.install(spec)
    marker = tmp_path / "ran.txt"

    @ray_tpu_torch.remote
    def mark(path):
        _append_line(path)
        return 1

    n = 6
    refs = [mark.options(scheduling_strategy="SPREAD").remote(str(marker))
            for _ in range(n)]
    assert ray_tpu_torch.get(refs, timeout=60) == [1] * n
    faultsim.clear()
    time.sleep(0.5)
    assert len(marker.read_text().splitlines()) == n


def test_batched_ack_failures_still_surface(port_regular):
    """ack="batch" acks frame acceptance, not completion — app errors must
    still reach the caller via the task-result stream."""

    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom-cp16")

    with pytest.raises(Exception, match="kaboom-cp16"):
        ray_tpu_torch.get(boom.options(scheduling_strategy="SPREAD").remote(),
                    timeout=60)


# --------------------------------------------------- spec templates --


def test_remote_function_template_cached_and_options_fresh(
        port_regular):
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    assert ray_tpu_torch.get(double.remote(2), timeout=60) == 4
    tmpl = double._template
    assert tmpl is not None
    assert ray_tpu_torch.get(double.remote(3), timeout=60) == 6
    assert double._template is tmpl  # reused, not rebuilt per call

    spread = double.options(scheduling_strategy="SPREAD")
    assert spread._template is None  # new options -> fresh template
    assert ray_tpu_torch.get(spread.remote(4), timeout=60) == 8
    assert spread._template is not tmpl

    # the template pins the live CoreWorker: it must not ride a pickle
    assert double.__getstate__()["_template"] is None


def test_actor_method_template_cached(port_regular):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, k):
            self.n += k
            return self.n

    a = Counter.remote()
    assert ray_tpu_torch.get(a.bump.remote(1), timeout=60) == 1
    method = a.bump
    assert a.bump is method  # memoized on the handle
    tmpl = method._template
    assert tmpl is not None
    assert ray_tpu_torch.get(a.bump.remote(2), timeout=60) == 3
    assert a.bump._template is tmpl
    assert method.__getstate__()["_template"] is None
    ray_tpu_torch.kill(a)


# --------------------------------------------------- lease grace window --


def _lease_calls() -> float:
    dump = mc.registry().snapshot().get("rpc_request_latency_seconds")
    if not dump:
        return 0.0
    return sum(s.get("count", 0) for s in dump.get("series", ())
               if s.get("tags", {}).get("method") == "lease_workers")


def test_lease_grace_reuses_grant_across_sync_calls(port_regular):
    """Back-to-back sync calls must ride one lease grant (grace window),
    not re-lease per call (the old return-on-drain behavior)."""

    @ray_tpu_torch.remote
    def nop():
        return 1

    ray_tpu_torch.get(nop.remote(), timeout=60)  # warm the pump + first lease
    before = _lease_calls()
    for _ in range(20):
        assert ray_tpu_torch.get(nop.remote(), timeout=60) == 1
    grew = _lease_calls() - before
    # without grace this is ~20 (one lease round trip per drain); with it,
    # ~0. Allow slack for a scheduler hiccup outliving the grace window.
    assert grew <= 5, f"lease_workers grew by {grew} over 20 sync calls"


# ----------------------------------------------------- stage timing --


def test_stage_timing_flag_records_driver_stages(port_regular):
    prev = cfg.control_plane_stage_timing
    cfg.update({"control_plane_stage_timing": True})
    try:
        @ray_tpu_torch.remote
        def nop():
            return 1

        assert ray_tpu_torch.get(nop.remote(), timeout=60) == 1
        dump = mc.registry().snapshot().get("control_plane_stage_seconds")
        assert dump, "stage histogram family missing"
        stages = {s["tags"].get("stage") for s in dump.get("series", ())
                  if s.get("count", 0) > 0}
        assert {"id_mint", "envelope_build", "result_return"} <= stages
    finally:
        cfg.update({"control_plane_stage_timing": prev})


# --------------------------------------------------------- zero copy --


def test_large_array_arg_stays_zero_copy_inline(port_regular):
    """A 64KB ndarray arg rides the inline ('v', meta, BufferList) wire
    form with the payload buffer SHARING memory with the caller's array —
    the fast path must not reintroduce a defensive copy."""
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    arr = np.arange(64 * 1024, dtype=np.uint8)
    pins = []
    enc_args, enc_kwargs, pending = cw._encode_slots((arr,), None, pins)
    assert not pending and not enc_kwargs
    kind, _meta, wire = enc_args[0]
    assert kind == "v"  # inline: below max_direct_call_object_size
    assert any(
        memoryview(buf).nbytes == arr.nbytes
        and np.shares_memory(np.frombuffer(buf, dtype=np.uint8), arr)
        for buf in wire.buffers
    ), "no wire buffer shares memory with the source array"

    # and end-to-end through an actor call the bytes arrive intact
    @ray_tpu_torch.remote
    class Summer:
        def total(self, a):
            return int(a.sum())

    s = Summer.remote()
    assert ray_tpu_torch.get(s.total.remote(arr), timeout=60) == int(arr.sum())
    ray_tpu_torch.kill(s)


# ------------------------------------------------------ hotpath lint --


def test_lint_hotpath_gate(tmp_path):
    script = os.path.join(REPO_ROOT, "ray_tpu_torch", "tools",
                          "lint_hotpath.py")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, cwd=REPO_ROOT)
    assert r.returncode == 0, (
        f"hot sections regressed:\n{r.stdout}\n{r.stderr}"
    )

    bad = tmp_path / "hot.py"
    bad.write_text(
        "x = 1\n"
        "f'{x} outside any region is fine'\n"
        "# hotpath: begin demo\n"
        "opts = dict(base)\n"                       # line 4: violation
        "tid = f'task-{x}'\n"                       # line 5: violation
        "raise ValueError(f'err {x}')  # lint: allow-hotpath (error path)\n"
        "# f'in a comment' is skipped\n"
        "# hotpath: end demo\n"
    )
    r = subprocess.run([sys.executable, script, str(bad)],
                       capture_output=True, text=True, cwd=REPO_ROOT)
    assert r.returncode == 1
    assert "hot.py:4" in r.stdout and "dict(" in r.stdout
    assert "hot.py:5" in r.stdout and "f-string" in r.stdout
    assert "hot.py:2" not in r.stdout  # outside a region
    assert "hot.py:6" not in r.stdout  # allow-marked error path

    # a hot file with NO marked regions fails: markers are the contract
    unmarked = tmp_path / "unmarked.py"
    unmarked.write_text("x = dict(y)\n")
    r = subprocess.run([sys.executable, script, str(unmarked)],
                       capture_output=True, text=True, cwd=REPO_ROOT)
    assert r.returncode == 1
    assert "no '# hotpath: begin' regions" in r.stdout


def test_fast_path_flags_exist():
    # pins the A/B lever names the bench + docs reference
    assert cfg.direct_lease_grace_s >= 0
    assert cfg.actor_sender_linger_s >= 0
    assert cfg.submit_ack_mode in ("batch", "spec")
    assert cfg.task_events_flush_interval_s >= 0
    assert cfg.free_flush_interval_s >= 0
