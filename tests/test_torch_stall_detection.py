"""A failure detector reads no stall of its own process as its peers'
silence: the GCS's heartbeat check and a connection's keepalive each add
their own late wake-up (``rpcio.own_stall_s``) to the silence clock, so a
GCS or a whole host frozen past the deadline kills no live node or
connection, while a peer that alone falls silent is still found dead."""

import asyncio
import os
import signal
import subprocess
import sys
import time

import ray_tpu_torch
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.rpcio import connect, own_stall_s


@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def test_own_stall_counts_only_the_overshoot_past_one_interval():
    assert own_stall_s(0.5, 0.5) == 0.0
    assert own_stall_s(1.0, 0.5) == 0.0  # late by one interval: no stall
    assert own_stall_s(3.5, 0.5) == 3.0


# an echo server in a process of its own, at the keepalive settings of
# the case below; it prints its port, then a line when it loses its
# first peer, and exits
_ECHO_SERVER = """
import asyncio
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.rpcio import RpcServer
GLOBAL_CONFIG.update({"rpc_keepalive_interval_s": 0.2,
                      "rpc_keepalive_timeout_s": 1.0})
class Echo:
    def __init__(self):
        self.lost = asyncio.Event()
    async def rpc_echo(self, conn, p):
        return p
    def on_disconnect(self, conn):
        print("lost a peer", flush=True)
        self.lost.set()
async def main():
    echo = Echo()
    print(await RpcServer(echo).start(), flush=True)
    await asyncio.wait_for(echo.lost.wait(), 60)
asyncio.run(main())
"""


def test_keepalive_reads_no_stall_of_its_own_as_the_peers_silence():
    """Both ends of a connection frozen alike for longer than
    ``rpc_keepalive_timeout_s`` (a paused host: the server stopped by
    SIGSTOP, the client's loop blocked) keep the connection: each end adds
    its own late wake-up to the peer's silence clock. Read as silence, the
    pause made each end declare the other dead when it resumed, though
    neither had been able to send."""
    from ray_tpu_torch._private.node import package_env

    proc = subprocess.Popen([sys.executable, "-c", _ECHO_SERVER],
                            stdout=subprocess.PIPE, text=True,
                            env=package_env())
    try:
        port = int(proc.stdout.readline())

        async def main():
            GLOBAL_CONFIG.update({"rpc_keepalive_interval_s": 0.2,
                                  "rpc_keepalive_timeout_s": 1.0})
            try:
                conn = await connect("127.0.0.1", port, retries=3)
                assert await conn.request("echo", {"x": 1},
                                          timeout=10) == {"x": 1}
                os.kill(proc.pid, signal.SIGSTOP)
                try:
                    time.sleep(2.5)  # this loop frozen with its peer
                finally:
                    os.kill(proc.pid, signal.SIGCONT)
                await asyncio.sleep(1.0)  # five keepalive rounds on
                assert not conn.closed
                assert await conn.request("echo", {"x": 2},
                                          timeout=10) == {"x": 2}
                await conn.close()
            finally:
                GLOBAL_CONFIG.reset()

        asyncio.run(main())
        # the server lost its one peer when the client closed, not before
        out = proc.communicate(timeout=60)[0]
    finally:
        proc.kill()
    assert out == "lost a peer\n", out
    assert proc.returncode == 0


def test_a_gcs_stalled_past_the_node_death_timeout_kills_no_node(
        monkeypatch):
    """A GCS whose own process stalls (here SIGSTOP) for longer than
    ``node_death_timeout_s`` marks no node dead when it resumes: the
    heartbeats its raylet sent meanwhile wait unread behind the health
    check, so the check adds its own late wake-up to every node's silence
    clock. Read as the node's silence, the stall marked the live node dead
    and every actor on it ("node died: heartbeat timeout"). A raylet that
    itself stops heartbeating is still found dead in that time."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    monkeypatch.setenv("RAY_TPU_TORCH_node_death_timeout_s", "3")
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        c = Counter.remote()
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
        gcs = global_worker.node.gcs_proc.pid
        os.kill(gcs, signal.SIGSTOP)
        try:
            time.sleep(6.0)
        finally:
            os.kill(gcs, signal.SIGCONT)
        time.sleep(1.5)  # three health rounds on
        assert ray_tpu_torch.get(c.incr.remote(), timeout=30) == 2
        assert [n["alive"] for n in ray_tpu_torch.nodes()] == [True]
        assert [a["state"] for a in state.list_actors()] == ["ALIVE"]
    finally:
        ray_tpu_torch.shutdown()


def test_a_raylet_silent_past_the_node_death_timeout_is_still_found_dead(
        monkeypatch):
    """The other side of the case above: a raylet frozen (SIGSTOP) past
    ``node_death_timeout_s`` while the GCS runs on time is a silent node,
    and the GCS marks it dead and fails the actors on it."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    monkeypatch.setenv("RAY_TPU_TORCH_node_death_timeout_s", "3")
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        c = Counter.remote()
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
        raylet = global_worker.node.raylet_proc.pid
        os.kill(raylet, signal.SIGSTOP)
        try:
            time.sleep(6.0)
        finally:
            os.kill(raylet, signal.SIGCONT)
        assert [(a["state"], a["death_cause"])
                for a in state.list_actors()] == [
            ("DEAD", "node died: heartbeat timeout")]
    finally:
        ray_tpu_torch.shutdown()
