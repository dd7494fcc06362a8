"""The port's counterpart of ``tests/test_batched_transport.py`` (3 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name.

The reference's description:

Failure/order semantics of the batched direct transport
(execute_task_batch + streamed task_result notifies): early results must
stream out of a batch, and a mid-burst worker death must fail ONLY the
calls whose results never landed — resubmitting an already-resulted call
would break at-most-once (ray parity: direct_task_transport.cc +
actor_task ordering guarantees).
"""

import time

import pytest

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


def test_wait_sees_fast_task_inside_a_burst(port_regular):
    """A burst drains into one batch frame; a slow task in the batch must
    not gate the delivery of faster ones behind it."""
    @ray_tpu_torch.remote
    def quick(i):
        return i

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return "slow"

    refs = [quick.remote(i) for i in range(20)] + [slow.remote()]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=20, timeout=4)
    assert len(ready) == 20 and not_ready == [refs[-1]]
    assert ray_tpu_torch.get(refs[-1], timeout=30) == "slow"


def test_actor_burst_streams_in_order(port_regular):
    """Sequential-actor bursts ride batch frames; results stream back and
    the calls run strictly in submission order."""
    @ray_tpu_torch.remote
    class Seq:
        def __init__(self):
            self.log = []

        def add(self, i):
            self.log.append(i)
            return i

        def history(self):
            return list(self.log)

    a = Seq.remote()
    refs = [a.add.remote(i) for i in range(200)]
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(200))
    assert ray_tpu_torch.get(a.history.remote(), timeout=30) == list(range(200))
    ray_tpu_torch.kill(a)


def test_mid_burst_actor_death_fails_only_pending_calls(port_regular):
    """Kill the actor while a burst is in flight: calls whose results
    already streamed back keep them; the rest surface ActorDiedError —
    and nothing re-executes (at-most-once)."""
    @ray_tpu_torch.remote(max_restarts=0)
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, delay):
            self.n += 1
            time.sleep(delay)
            return self.n

    a = Counter.remote()
    # first call settles the connection; then a burst where call #3
    # sleeps long enough for the kill to land mid-batch
    assert ray_tpu_torch.get(a.bump.remote(0.0), timeout=30) == 1
    refs = [a.bump.remote(0.0), a.bump.remote(0.0),
            a.bump.remote(3.0)] + [a.bump.remote(0.0) for _ in range(5)]
    # let the early calls complete and stream back
    early = ray_tpu_torch.get(refs[:2], timeout=30)
    assert early == [2, 3]
    ray_tpu_torch.kill(a)
    from ray_tpu_torch._private.serialization import TaskError

    outcomes = []
    for r in refs[2:]:
        # short timeout: a silent hang must FAIL here as GetTimeoutError,
        # not masquerade as a pass after minutes of waiting
        try:
            outcomes.append(("ok", ray_tpu_torch.get(r, timeout=15)))
        except Exception as e:  # noqa: BLE001
            cause = e.cause if isinstance(e, TaskError) else e
            outcomes.append(("err", type(cause).__name__))
    # every unfinished call fails WITH A DEATH ERROR (typed, prompt —
    # never a timeout) and nothing re-executes
    assert all(
        kind == "err" and name in ("ActorDiedError", "WorkerDiedError")
        for kind, name in outcomes
    ), outcomes
    assert ray_tpu_torch.get(refs[0], timeout=5) == 2  # result survives the death
