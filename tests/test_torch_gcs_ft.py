"""The port's counterpart of ``tests/test_gcs_ft.py`` (5 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

Beside them, the CPU rehearsal of ``chip_smoke.py`` phase 19 (b)
(``tools/gcs_failover.py`` under a small GPT-2 replica holding the one
card a cluster advertises) and a cross-package case: the same HTTP
request during a GCS outage meets the same outcome in the reference's
proxy and the port's.

The reference's description:

GCS fault-tolerance chaos tests.

Analog of ray: python/ray/tests/test_gcs_fault_tolerance.py — kill the GCS
mid-job, restart it, and assert the cluster resumes: the replayed store
restores actors/KV/jobs, raylets reconnect and reclaim their running
actors, and new work schedules normally.
"""

import os
import time

import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_cluster  # noqa: F401


@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n

    def getpid(self):
        import os

        return os.getpid()


@ray_tpu_torch.remote
def add(a, b):
    return a + b


def _gcs_alive(port, timeout=30.0):
    from ray_tpu_torch._private.rpcio import EventLoopThread, connect

    io = EventLoopThread("gcs-probe")
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                conn = io.run(connect("127.0.0.1", port, retries=1))
                io.run(conn.request("get_nodes", {}))
                io.run(conn.close())
                return True
            except Exception:
                time.sleep(0.2)
        return False
    finally:
        io.stop()


def test_gcs_restart_resumes_cluster(port_cluster):
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    # Pre-outage state: a named actor with counter state, and KV content.
    counter = Counter.options(name="survivor", lifetime="detached").remote()
    assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 1
    from ray_tpu_torch.util.collective import collective as col

    col._kv_put(b"ft-key", b"ft-value")

    # Kill the GCS mid-job; actor calls go worker->worker directly and must
    # keep working during the outage.
    cluster.head.kill_gcs()
    assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 2

    cluster.head.restart_gcs()
    assert _gcs_alive(cluster.head.gcs_port)

    # KV replayed from the persist log.
    deadline = time.monotonic() + 30
    val = None
    while time.monotonic() < deadline:
        try:
            val = col._kv_get(b"ft-key")
            if val is not None:
                break
        except Exception:
            pass
        time.sleep(0.2)
    assert val == b"ft-value"

    # The raylet reconnected and reclaimed the running actor: the replayed
    # record must come back ALIVE (not restarted — state intact).
    assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 3
    handle = ray_tpu_torch.get_actor("survivor")
    assert ray_tpu_torch.get(handle.incr.remote(), timeout=60) == 4

    # New tasks and new actors schedule normally after failover.
    assert ray_tpu_torch.get(add.remote(2, 3), timeout=60) == 5
    c2 = Counter.remote()
    assert ray_tpu_torch.get(c2.incr.remote(), timeout=60) == 1


def test_gcs_restart_restarts_lost_actor(port_cluster, monkeypatch):
    """An actor whose worker died DURING the GCS outage is failed over by
    the restarted GCS once the reconnect window closes."""
    # The flag must reach the restarted GCS subprocess via its env.
    monkeypatch.setenv("RAY_TPU_TORCH_gcs_failover_reconnect_timeout_s", "2.0")
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    actor = Counter.options(max_restarts=1, name="phoenix").remote()
    assert ray_tpu_torch.get(actor.incr.remote(), timeout=60) == 1
    pid = ray_tpu_torch.get(actor.getpid.remote(), timeout=60)

    cluster.head.kill_gcs()
    # Kill the actor's worker process while the GCS is down: nobody can
    # observe the death until the GCS is back and the raylet re-reports.
    import os
    import signal

    os.kill(pid, signal.SIGKILL)

    cluster.head.restart_gcs()
    assert _gcs_alive(cluster.head.gcs_port)

    # After failover the actor restarts (max_restarts=1) and serves calls;
    # its in-memory counter reset.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            val = ray_tpu_torch.get(actor.incr.remote(), timeout=10)
            assert val >= 1
            return
        except Exception:
            time.sleep(0.5)
    pytest.fail("actor was not restarted after GCS failover")


def test_object_transfer_survives_gcs_outage(port_cluster):
    """Ownership-based object directory (ray:
    ownership_based_object_directory.h): the owner — not the GCS — is the
    authority on object locations, so a cross-node pull must succeed while
    the GCS is down, and a GCS restart mid-transfer needs no location
    replay before pulls resume."""
    import numpy as np

    cluster = port_cluster
    cluster.add_node(num_cpus=2, resources={"nodeB": 2.0})
    ray_tpu_torch.init(address=cluster.address)

    # A plasma object owned by this driver, stored on the head node.
    arr = np.arange(500_000, dtype=np.int64)
    ref = ray_tpu_torch.put(arr)

    @ray_tpu_torch.remote(resources={"nodeB": 0.1})
    def consume(x):
        return int(x.sum())

    # Warm nodeB's worker pool and the peer conns while the GCS is still
    # up (a cold worker spawn blocks on GCS registration until it's back).
    assert ray_tpu_torch.get(consume.remote(ray_tpu_torch.put(np.int64(3))), timeout=60) == 3
    assert ray_tpu_torch.get(add.remote(1, 1), timeout=60) == 2

    cluster.head.kill_gcs()
    # nodeB's raylet has never seen `ref`; resolving it requires a
    # location lookup, which must be served by the owner (this driver).
    assert ray_tpu_torch.get(consume.remote(ref), timeout=90) == int(arr.sum())

    cluster.head.restart_gcs()
    assert _gcs_alive(cluster.head.gcs_port)

    # Driver's GCS conn AND the raylet's re-registration are both
    # asynchronous after the restart: wait for a live node to show up, not
    # merely for the first successful (possibly still-empty) response.
    deadline = time.monotonic() + 30
    stats = None
    while time.monotonic() < deadline:
        try:
            stats = ray_tpu_torch.nodes()
            if stats and any(n["alive"] for n in stats):
                break
        except Exception:
            pass
        time.sleep(0.3)
    assert stats and any(n["alive"] for n in stats)
    ref2 = ray_tpu_torch.put(np.arange(200_000, dtype=np.int64))
    assert ray_tpu_torch.get(consume.remote(ref2), timeout=90) == int(
        np.arange(200_000, dtype=np.int64).sum()
    )


def test_sqlite_store_roundtrip(tmp_path, monkeypatch):
    """SqliteStore: upserts, tombstones, reopen-and-load, and cluster
    ownership (a NEW cluster must not resurrect the old one's state)."""
    monkeypatch.delenv("RAY_TPU_TORCH_GCS_STORAGE", raising=False)
    from ray_tpu_torch._private.gcs_store import SqliteStore, make_store

    path = str(tmp_path / "sub" / "gcs.sqlite")
    st = make_store(f"sqlite://{path}")
    assert isinstance(st, SqliteStore)
    st.put("actors", b"a1", {"state": "ALIVE"})
    st.put("kv", ("ns", b"k"), b"v")
    st.put("actors", b"a2", {"state": "DEAD"})
    st.put("actors", b"a2", None)  # tombstone
    st.close()

    st2 = SqliteStore(path)
    tables = st2.load()
    assert tables["actors"] == {b"a1": {"state": "ALIVE"}}
    assert tables["kv"][("ns", b"k")] == b"v"
    st2.close()

    # same cluster id: state replays; different cluster id: wiped.
    st3 = SqliteStore(path, cluster_id="cluster-A")
    assert st3.load()["actors"] == {b"a1": {"state": "ALIVE"}}
    st3.close()
    st4 = SqliteStore(path, cluster_id="cluster-A")
    assert st4.load()["actors"] == {b"a1": {"state": "ALIVE"}}
    st4.close()
    st5 = SqliteStore(path, cluster_id="cluster-B")
    assert st5.load() == {}
    st5.close()


def test_gcs_kill9_restart_against_sqlite(port_cluster, monkeypatch,
                                          tmp_path):
    """kill -9 the GCS and restart it against the EXTERNAL sqlite store:
    jobs/actors/KV/PGs come back intact even though the session-dir log
    was never written (reference analog: RedisStoreClient failover)."""
    monkeypatch.setenv(
        "RAY_TPU_TORCH_GCS_STORAGE", f"sqlite://{tmp_path}/external_gcs.sqlite"
    )
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    counter = Counter.options(name="sq-survivor",
                              lifetime="detached").remote()
    assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 1
    from ray_tpu_torch.util.collective import collective as col

    col._kv_put(b"sq-key", b"sq-value")
    # the external store is the one being written, not the session log
    import os

    assert os.path.exists(f"{tmp_path}/external_gcs.sqlite")

    cluster.head.kill_gcs()  # SIGKILL, no flush opportunity
    cluster.head.restart_gcs()
    assert _gcs_alive(cluster.head.gcs_port)

    deadline = time.monotonic() + 30
    val = None
    while time.monotonic() < deadline:
        try:
            val = col._kv_get(b"sq-key")
            if val is not None:
                break
        except Exception:
            pass
        time.sleep(0.2)
    assert val == b"sq-value"
    assert ray_tpu_torch.get(counter.incr.remote(), timeout=60) == 2
    handle = ray_tpu_torch.get_actor("sq-survivor")
    assert ray_tpu_torch.get(handle.incr.remote(), timeout=60) == 3


# ------------------------------------------------------------------------
# The CPU rehearsal of ``chip_smoke.py`` phase 19 (b): GPT-2's serve.run
# replica outlives a SIGKILLed GCS (``tools/gcs_failover.outage``).
# ------------------------------------------------------------------------

_GPT2_KW = dict(real_model=True, device="cpu", kv_dim=64, page_tokens=4,
                max_pages=128, max_running=4, prefix_cache_pages=16)


def _gpt2_kw():
    import torch

    return dict(_GPT2_KW, model_kwargs=dict(attention="flash",
                                            dtype=torch.float32, seed=3))


def _in_process_tokens(prompt, max_tokens):
    """The greedy tokens of the in-process port server, same weights."""
    import asyncio
    import json

    from ray_tpu_torch.serve._common import Request
    from ray_tpu_torch.serve.llm.engine import LLMServer

    local = LLMServer(**_gpt2_kw())

    async def one():
        body = json.dumps({"tokens": prompt,
                           "max_tokens": max_tokens}).encode()
        return [json.loads(line)["token"]
                async for line in local(Request(body=body))]
    try:
        return asyncio.run(one())
    finally:
        local.close()


def test_gpt2_replica_outlives_a_sigkilled_gcs():
    """A small GPT-2 served by ``serve.run`` on the CPU, its replica holding
    the one card a cluster with ``num_gpus=1`` advertises. With the GCS
    SIGKILLed, the replica decodes through the handle taken before the kill
    the tokens of an in-process decode, and the proxy answers 500 at once.
    After ``restart_gcs`` the KV key reads back, the same pid is listed
    ALIVE and not restarted, GPU 1.0 is still advertised, a second actor
    asking the card stays pending, and HTTP streams equal the in-process
    decode again."""
    import numpy as np

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm.engine import LLMServer
    from ray_tpu_torch.tools import gcs_failover

    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 512, size=32).tolist()
    warm = rng.integers(0, 512, size=8).tolist()
    want = _in_process_tokens(prompt, 8)

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        app = serve.deployment(LLMServer, name="llm").options(
            ray_actor_options={"num_gpus": 1}).bind(**_gpt2_kw())
        serve.run(app, route_prefix="/llm")
        port = serve.http_port()
        assert gcs_failover.http_request(port, prompt, 8)["tokens"] == want
        assert ray_tpu_torch.available_resources().get("GPU", 0) == 0
        out = gcs_failover.outage("default", "llm", port, prompt, 8, warm)
        after = [gcs_failover.http_request(port, prompt, 8)
                 for _ in range(2)]
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()

    assert out["gcs_pid_gone"]
    assert out["http_before"]["status"] == 200
    during = out["http_during"]
    assert during["status"] == 500, during
    assert during["s"] < gcs_failover.HTTP_DEADLINE_S
    assert out["tokens_during"] == want
    assert out["kv_after"] == gcs_failover.KV_VALUE
    assert out["pid_after"] == out["pid_before"]
    assert out["replica_row"]["state"] == "ALIVE"
    assert out["replica_row"]["num_restarts"] == 0
    assert out["cluster_resources"].get("GPU") == 1.0
    assert not out["second_placed"], \
        "the replayed GCS handed the card out twice"
    assert out["controller_replicas"] == [out["replica"]]
    assert [a["status"] for a in after] == [200, 200]
    assert [a["tokens"] for a in after] == [want, want]


def _http_outage_program(pkg):
    """One HTTP request before, during and after a SIGKILLed GCS, through
    ``pkg``'s own proxy over its synthetic ``LLMServer``: each one's status,
    and whether the streams before and after are equal."""
    import importlib

    from ray_tpu_torch.tools.gcs_failover import HTTP_DEADLINE_S, http_request

    serve = importlib.import_module(f"{pkg.__name__}.serve")
    llm = importlib.import_module(f"{pkg.__name__}.serve.llm")
    worker = importlib.import_module(f"{pkg.__name__}._private.worker")
    pkg.init(num_cpus=2)
    try:
        serve.run(serve.deployment(llm.LLMServer, name="llm").bind(
            page_tokens=4, max_pages=32), route_prefix="/llm")
        port = serve.http_port()
        before = http_request(port, [1, 2, 3, 4, 5], 4)
        worker.global_worker.node.kill_gcs()
        during = http_request(port, [1, 2, 3, 4, 5], 4)
        worker.global_worker.node.restart_gcs()
        deadline = time.monotonic() + 60
        after = None
        while time.monotonic() < deadline:
            after = http_request(port, [1, 2, 3, 4, 5], 4)
            if after["status"] == 200:
                break
            time.sleep(0.2)
        serve.shutdown()
    finally:
        pkg.shutdown()
    assert during["s"] < HTTP_DEADLINE_S, during
    return (before["status"], during["status"], after["status"],
            before["tokens"] == after["tokens"])


def test_http_during_the_outage_same_outcome_as_the_reference():
    """The same HTTP request during a GCS outage: the reference's proxy and
    the port's answer it alike (500: both look the replica up by name in
    the GCS), and serve the same stream again after the restart."""
    import ray_tpu

    if ray_tpu.is_initialized():
        # the reference's own test cluster, shared between its modules
        ray_tpu.shutdown()
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    port = _http_outage_program(ray_tpu_torch)
    assert port == (200, 500, 200, True)
    assert _http_outage_program(ray_tpu) == port


def test_actor_creation_slower_than_the_gcs_rpc_deadline_comes_up(
        tmp_path, monkeypatch):
    """An actor whose worker starts slowly and whose ``__init__`` takes
    most of ``gcs_rpc_timeout_s`` comes up ALIVE: the raylet bounds each
    step of a creation itself (the worker's registration by
    ``worker_register_timeout_s``, ``__init__`` by ``gcs_rpc_timeout_s``),
    so the GCS waits for both before it gives the creation up. A GCS that
    gave up after ``gcs_rpc_timeout_s`` found its 1 s search for a node
    over and declared the actor dead while the raylet went on creating it:
    phase 34's autoscaled GPT-2 replica on the card (a worker start and a
    model built on the card under load, about 30 s) died so."""
    from ray_tpu_torch._private.node import package_env

    # the worker's interpreter sleeps 2.5 s before it imports anything
    (tmp_path / "sitecustomize.py").write_text(
        "import time\ntime.sleep(2.5)\n")
    monkeypatch.setenv("RAY_TPU_TORCH_gcs_rpc_timeout_s", "4")
    monkeypatch.setenv("RAY_TPU_TORCH_worker_lease_timeout_ms", "1000")
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Slow:
            def __init__(self):
                time.sleep(2.0)

            def ready(self):
                import os

                return os.getpid()

        path = str(tmp_path) + os.pathsep + package_env()["PYTHONPATH"]
        t0 = time.monotonic()
        actor = Slow.options(runtime_env={
            "env_vars": {"PYTHONPATH": path}}).remote()
        pid = ray_tpu_torch.get(actor.ready.remote(), timeout=60)
        took = time.monotonic() - t0
        assert pid > 0
        # the creation outlasted the old deadline, so the case tests it
        assert took > 4.0, took
    finally:
        ray_tpu_torch.shutdown()
