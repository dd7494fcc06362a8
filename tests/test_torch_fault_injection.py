"""The port's counterpart of ``tests/test_fault_injection.py`` (17 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name; the 2 slow cases stay in the slow lane, as
the reference's do.

Beside them, the spec parser and the seeded decisions of a fault plan
are held to the reference's on the same specs and numpy-seeded method
streams.

The reference's description:

Seeded network fault injection (faultsim) + control-plane hardening.

Fast deterministic tests (unmarked, tier-1): spec parsing, seeded-PRNG
replayability, and each fault kind — drop, delay, dup, corrupt, partition —
against a live in-process RpcServer, plus the hardening they force: CRC
corruption detection as a typed error, per-request deadlines, keepalive
dead-peer detection, duplicate-frame suppression, retry-level idempotency,
and exponential connect backoff.

Cluster-level chaos (marked chaos+slow, scripts/run_chaos.sh lane): jobs
complete correctly under each fault kind at p≈0.05, and a raylet-to-raylet
partition heals with the outage visible in raylet counters.
"""

import asyncio
import socket
import time

import pytest

from ray_tpu_torch._private import faultsim
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.rpcio import (
    ConnectionLost,
    FrameCorruptError,
    RpcServer,
    RpcTimeoutError,
    call_with_retries,
    connect,
)


@pytest.fixture(autouse=True)
def _clean_faultsim():
    yield
    faultsim.clear()
    faultsim.set_self_id(f"pid:{__import__('os').getpid()}")


# ------------------------------------------------------------ spec/PRNG --


def test_parse_spec_kinds_and_params():
    rules = faultsim.parse_spec(
        "heartbeat:drop:0.1:7; echo.*:delay:0.5:8:120\n"
        "submit:dup:1.0:9 ; push_chunks:corrupt:0.05:10")
    assert [r.kind for r in rules] == ["drop", "delay", "dup", "corrupt"]
    assert rules[1].param == 120.0
    assert rules[0].seed == 7 and rules[0].prob == 0.1


def test_parse_spec_pattern_may_contain_colons():
    (rule,) = faultsim.parse_spec("nodeA.*>127.0.0.1:6801:partition:1:0")
    assert rule.kind == "partition"
    assert rule.pattern == "nodeA.*>127.0.0.1:6801"


def test_parse_spec_skips_malformed_rules():
    rules = faultsim.parse_spec(
        "not-a-rule; echo:badkind:1:2; echo:drop:xx:2; echo:drop:0.5:3")
    assert len(rules) == 1 and rules[0].seed == 3


def test_seeded_decisions_replay_exactly():
    """The acceptance property: every chaos decision sequence is a pure
    function of (spec, matched-call stream) — rerunning with the logged
    seed reproduces the failure."""

    def decisions(seed):
        plan = faultsim.FaultPlan(faultsim.parse_spec(f"m.*:drop:0.3:{seed}"))
        return [plan.on_send(f"m{i % 3}", None) is not None
                for i in range(300)]

    a, b = decisions(42), decisions(42)
    assert a == b
    assert a != decisions(43)
    assert 40 < sum(a) < 150  # p=0.3 actually fires


def test_partition_rules_match_self_id():
    faultsim.set_self_id("nodeA")
    plan = faultsim.FaultPlan(
        faultsim.parse_spec("nodeA>127.0.0.1:6801:partition:1:0"))
    assert plan.on_connect("127.0.0.1:6801")
    assert plan.on_send("heartbeat", "127.0.0.1:6801") is not None
    assert plan.on_send("heartbeat", "127.0.0.1:6802") is None
    faultsim.set_self_id("nodeB")
    assert not plan.on_connect("127.0.0.1:6801")


# ------------------------------------------------------ live fault kinds --


class ChaosHandler:
    def __init__(self):
        self.count = 0

    def rpc_echo(self, conn, p):
        return p

    def rpc_bump(self, conn, p):
        self.count += 1
        return self.count

    async def rpc_kick(self, conn, p):
        # the tick notify is enqueued BEFORE the response: a corrupt rule
        # on "tick" reaches the client first and resets the connection
        await conn.notify("tick", {"x": 1})
        return {"ok": True}

    async def rpc_hang(self, conn, p):
        await asyncio.sleep(60)


def _serve(handler):
    srv = RpcServer(handler)
    return srv


def test_corrupt_frame_surfaces_typed_error_and_resets():
    """A CRC-corrupted frame is detected by the receiver, raises the typed
    FrameCorruptError, and resets the connection — pending requests fail
    with the SAME typed error instead of hanging."""

    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        conn = await connect("127.0.0.1", port, retries=3)
        try:
            faultsim.install("tick:corrupt:1.0:3")
            with pytest.raises(FrameCorruptError):
                await conn.request("kick", {}, timeout=10)
            assert conn.closed
        finally:
            faultsim.clear()
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_corrupt_faults_recovered_by_retries():
    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        faultsim.install("echo:corrupt:0.4:11")
        state = {"conn": None}

        async def get_conn():
            if state["conn"] is None or state["conn"].closed:
                state["conn"] = await connect("127.0.0.1", port, retries=3)
            return state["conn"]

        try:
            reply = await call_with_retries(
                get_conn, "echo", {"x": 1}, timeout=5, attempts=10,
                base_delay=0.02)
            assert reply == {"x": 1}
        finally:
            faultsim.clear()
            if state["conn"] is not None:
                await state["conn"].close()
            await srv.stop()

    asyncio.run(main())


def test_duplicated_request_frame_executes_once():
    async def main():
        handler = ChaosHandler()
        srv = _serve(handler)
        port = await srv.start()
        conn = await connect("127.0.0.1", port, retries=3)
        try:
            faultsim.install("bump:dup:1.0:5")
            assert await conn.request("bump", {}, timeout=10) == 1
            assert await conn.request("bump", {}, timeout=10) == 2
            await asyncio.sleep(0.1)  # let any duplicate dispatch land
            assert handler.count == 2, \
                "duplicated frames must not re-run the handler"
        finally:
            faultsim.clear()
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_idempotency_token_dedups_cross_connection_retry():
    """The retry story for side-effectful RPCs: the same idem token on a
    FRESH connection (as a real retry after connection loss would be)
    replays the first execution's result instead of re-executing."""

    async def main():
        handler = ChaosHandler()
        srv = _serve(handler)
        port = await srv.start()
        c1 = await connect("127.0.0.1", port, retries=3)
        r1 = await c1.request("bump", {}, timeout=10, idem=("tok", 1))
        await c1.close()
        c2 = await connect("127.0.0.1", port, retries=3)
        try:
            r2 = await c2.request("bump", {}, timeout=10, idem=("tok", 1))
            assert (r1, r2) == (1, 1)
            assert handler.count == 1
            # a DIFFERENT token executes normally
            assert await c2.request("bump", {}, timeout=10,
                                    idem=("tok", 2)) == 2
        finally:
            await c2.close()
            await srv.stop()

    asyncio.run(main())


def test_delay_fault_stalls_but_completes():
    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        conn = await connect("127.0.0.1", port, retries=3)
        try:
            faultsim.install("echo:delay:1.0:2:150")
            t0 = time.monotonic()
            reply = await conn.request("echo", {"x": 9}, timeout=10)
            assert reply == {"x": 9}
            assert time.monotonic() - t0 >= 0.12
        finally:
            faultsim.clear()
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_drop_fault_severs_connection_mid_frame():
    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        conn = await connect("127.0.0.1", port, retries=3)
        try:
            faultsim.install("echo:drop:1.0:4")
            with pytest.raises(ConnectionLost):
                await conn.request("echo", {"x": 1}, timeout=10)
            assert conn.closed
        finally:
            faultsim.clear()
            await conn.close()
            await srv.stop()

    asyncio.run(main())


def test_partition_refuses_new_connections():
    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        faultsim.set_self_id("me")
        faultsim.install(f"me>127.0.0.1:{port}:partition:1:0")
        t0 = time.monotonic()
        with pytest.raises(ConnectionLost):
            await connect("127.0.0.1", port, retries=3, retry_delay=0.02)
        assert time.monotonic() - t0 < 5
        faultsim.clear()
        conn = await connect("127.0.0.1", port, retries=3)  # healed
        assert await conn.request("echo", {"x": 1}, timeout=10) == {"x": 1}
        await conn.close()
        await srv.stop()

    asyncio.run(main())


# ------------------------------------------------------------ hardening --


def test_request_default_deadline_types_timeout():
    """Unbounded request() is gone: with no explicit timeout the
    rpc_request_timeout_s default applies and raises the typed error
    (which still matches legacy ``except asyncio.TimeoutError``)."""

    async def main():
        srv = _serve(ChaosHandler())
        port = await srv.start()
        GLOBAL_CONFIG.update({"rpc_request_timeout_s": 0.3})
        try:
            conn = await connect("127.0.0.1", port, retries=3)
            t0 = time.monotonic()
            with pytest.raises(RpcTimeoutError):
                await conn.request("hang", {})
            assert time.monotonic() - t0 < 5
            with pytest.raises(asyncio.TimeoutError):
                await conn.request("hang", {})
            await conn.close()
        finally:
            GLOBAL_CONFIG.reset()
            await srv.stop()

    asyncio.run(main())


def test_keepalive_declares_blackholed_peer_dead():
    """A black-holed peer (frames silently discarded — no RST, no FIN) is
    declared dead in O(rpc_keepalive_timeout_s) instead of hanging."""

    async def main():
        GLOBAL_CONFIG.update({"rpc_keepalive_interval_s": 0.2,
                              "rpc_keepalive_timeout_s": 1.0})
        srv = _serve(ChaosHandler())
        port = await srv.start()
        try:
            faultsim.set_self_id("cli")
            conn = await connect("127.0.0.1", port, retries=3)
            assert await conn.request("echo", {"x": 1}, timeout=10) == {"x": 1}
            faultsim.install(f"cli>127.0.0.1:{port}:partition:1:0")
            t0 = time.monotonic()
            with pytest.raises((ConnectionLost, RpcTimeoutError)):
                await conn.request("echo", {"x": 2}, timeout=20)
            assert time.monotonic() - t0 < 8, \
                "keepalive must beat the request deadline"
        finally:
            faultsim.clear()
            GLOBAL_CONFIG.reset()
            await srv.stop()

    asyncio.run(main())


def test_connect_backoff_is_exponential_and_bounded():
    async def main():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        dead_port = sock.getsockname()[1]
        sock.close()  # nothing listens here now
        t0 = time.monotonic()
        with pytest.raises(ConnectionLost):
            await connect("127.0.0.1", dead_port, retries=4,
                          retry_delay=0.05)
        elapsed = time.monotonic() - t0
        # 3 sleeps with doubling + jitter in [0.5,1.0]x:
        # >= (0.05+0.1+0.2)*0.5 = 0.175 and << the old fixed-delay ceiling
        assert 0.15 <= elapsed < 5

    asyncio.run(main())


# ------------------------------------------------- cluster-level chaos --
# Heavy: each case boots a real multi-process cluster under an armed fault
# plan. chaos+slow keeps them out of the tier-1 lane; scripts/run_chaos.sh
# runs them. Frame-killing kinds (drop/corrupt) target GCS- and peer-plane
# methods: those paths reconnect by design, while a driver's raylet conn is
# its lifeline (its loss is fatal by contract, as in the reference).

_KILLABLE = ("heartbeat|fetch_object|get_object_locations"
             "|add_object_location|publish|add_task_events")
_CHAOS_SPECS = {
    "drop": f"^({_KILLABLE})$:drop:0.05:1001",
    "corrupt": f"^({_KILLABLE})$:corrupt:0.05:1002",
    "delay": ".*:delay:0.05:1003:40",
    "dup": ".*:dup:0.1:1004",
}


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("kind", sorted(_CHAOS_SPECS))
def test_jobs_complete_under_fault_injection(kind, monkeypatch):
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setenv("RAY_TPU_TORCH_RPC_FAULTS", _CHAOS_SPECS[kind])
    faultsim.clear()  # re-probe env: this driver may have disarmed earlier
    cluster = Cluster(initialize_head=False)
    try:
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        cluster.wait_for_nodes()
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(max_retries=4)
        def echo(x):
            return x

        @ray_tpu_torch.remote(max_restarts=1, max_task_retries=4)
        class Seq:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
                return self.n

        # tasks: all complete with correct results
        got = ray_tpu_torch.get(
            [echo.options(scheduling_strategy="SPREAD").remote(i)
             for i in range(16)], timeout=120)
        assert got == list(range(16))
        # actor: strictly sequential — a double-executed submit/dup frame
        # would skip a value
        s = Seq.remote()
        vals = [ray_tpu_torch.get(s.bump.remote(), timeout=60) for _ in range(10)]
        assert vals == list(range(1, 11))
        # object plane: a 1MB array survives put/get under faults
        arr = np.arange(1 << 18, dtype=np.float32)
        ref = ray_tpu_torch.put(arr)
        assert np.array_equal(ray_tpu_torch.get(ref, timeout=120), arr)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


@pytest.mark.chaos
@pytest.mark.slow
def test_partition_and_heal_cross_node_pull(monkeypatch, tmp_path):
    """Satellite: two raylets black-holed from each other while the GCS
    stays reachable. A cross-node object pull stalls during the partition,
    completes after heal, and the outage window is visible in the raylet
    counters."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import state

    fault_file = tmp_path / "faults"
    monkeypatch.setenv("RAY_TPU_TORCH_RPC_FAULTS_FILE", str(fault_file))
    faultsim.clear()  # re-probe env: this driver may have disarmed earlier
    cluster = Cluster(initialize_head=False)
    try:
        head = cluster.add_node(num_cpus=2)
        node_b = cluster.add_node(num_cpus=2, resources={"rb": 4.0})
        node_c = cluster.add_node(num_cpus=2, resources={"rc": 4.0})
        cluster.wait_for_nodes()
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(resources={"rb": 1}, max_retries=0)
        def produce_on_b():
            return np.arange(1 << 18, dtype=np.float32)

        ref = produce_on_b.remote()
        (done, _) = ray_tpu_torch.wait([ref], timeout=60)
        assert done

        # black-hole B <-> C (both directions; GCS/head untouched)
        head.set_network_faults(
            f"{node_b.node_id}>.*:{node_c.raylet_port}:partition:1:0\n"
            f"{node_c.node_id}>.*:{node_b.raylet_port}:partition:1:0\n")
        time.sleep(1.0)  # file poll interval is 0.2s; let plans reload

        @ray_tpu_torch.remote(resources={"rc": 1}, max_retries=4)
        def consume(x):
            return float(x.sum())

        ref2 = consume.remote(ref)
        blocked, _ = ray_tpu_torch.wait([ref2], timeout=8)
        assert not blocked, "pull across the partition must stall"

        head.clear_network_faults()
        expect = float(np.arange(1 << 18, dtype=np.float32).sum())
        assert ray_tpu_torch.get(ref2, timeout=120) == expect

        stats_c = state.get_node_stats(node_c.node_id)
        counters = (stats_c or {}).get("counters", {})
        assert (counters.get("peer_dial_failures", 0)
                + counters.get("peer_conns_lost", 0)) >= 1, counters
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


# ---------------------------------------------- held against the reference --

_SPECS = (
    "heartbeat:drop:0.1:7; echo.*:delay:0.5:8:120\n"
    "submit:dup:1.0:9 ; push_chunks:corrupt:0.05:10",
    "nodeA.*>127.0.0.1:6801:partition:1:0",
    "not-a-rule; echo:badkind:1:2; echo:drop:xx:2; echo:drop:0.5:3",
    "m.*:drop:0.3:42; m1:dup:0.5:43; ^m2$:corrupt:0.25:44:3",
)


def _rules(mod, spec):
    return [(r.pattern, r.kind, r.prob, r.seed, r.param)
            for r in mod.parse_spec(spec)]


@pytest.mark.parametrize("spec", _SPECS)
def test_parse_spec_equals_the_reference(spec):
    from ray_tpu._private import faultsim as ref_faultsim

    assert _rules(faultsim, spec) == _rules(ref_faultsim, spec)


def test_seeded_decisions_equal_the_reference():
    """On one numpy-seeded method stream, each package's plan makes the
    same decision at every frame, partition rules included."""
    import numpy as np

    from ray_tpu._private import faultsim as ref_faultsim

    rng = np.random.default_rng(0)
    methods = [f"m{int(i)}" for i in rng.integers(0, 4, 600)]
    peers = [("127.0.0.1:6801", "127.0.0.1:6802", None)[int(i)]
             for i in rng.integers(0, 3, 600)]
    spec = _SPECS[3] + "\nme>127.0.0.1:6801:partition:1:0"

    def decisions(mod):
        mod.set_self_id("me")
        try:
            plan = mod.FaultPlan(mod.parse_spec(spec))
            out = []
            for m, p in zip(methods, peers):
                fate = plan.on_send(m, p)
                out.append(None if fate is None else fate[0])
            out.append(plan.on_connect("127.0.0.1:6801"))
            out.append(plan.on_connect("127.0.0.1:6802"))
            return out
        finally:
            mod.set_self_id(f"pid:{__import__('os').getpid()}")

    port = decisions(faultsim)
    assert port == decisions(ref_faultsim)
    assert {"drop", "dup", "corrupt", "partition", None} <= set(port)
