"""The port's workflows (``ray_tpu_torch.workflow``: durable DAG runs, event
steps, the management actor) on the CPU, beside the reference's.

The reference's two workflow cases of ``tests/test_util_extras.py`` and the
three cases of ``tests/test_workflow_events.py`` run through
``ray_tpu_torch`` with their expected values. A step's checkpoint is keyed
on ``_step_id``, a structural hash of the DAG, so the same DAG shapes built
in both packages must give the same ids, node for node.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow

rt = ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_workflow_run_and_resume(cluster, tmp_path):
    calls = tmp_path / "calls.txt"

    @rt.remote
    def add(a, b):
        with open(calls, "a") as f:
            f.write("add\n")
        return a + b

    @rt.remote
    def boom(x):
        raise RuntimeError("step failed")

    @rt.remote
    def double(x):
        with open(calls, "a") as f:
            f.write("double\n")
        return 2 * x

    storage = str(tmp_path / "wf")
    dag = double.bind(add.bind(1, 2))
    out = workflow.run(dag, workflow_id="wf1", storage=storage)
    assert out == 6
    assert workflow.get_status("wf1", storage=storage) == "SUCCESSFUL"
    assert workflow.get_output("wf1", storage=storage) == 6
    n_calls = len(calls.read_text().splitlines())
    assert n_calls == 2

    # Re-running the finished workflow replays from storage: no new calls.
    assert workflow.run(dag, workflow_id="wf1", storage=storage) == 6
    assert len(calls.read_text().splitlines()) == n_calls

    # A failing workflow checkpoints its completed prefix; after the fix
    # (new DAG tail) the prefix is reused.
    dag2 = boom.bind(add.bind(1, 2))
    with pytest.raises(Exception, match="step failed"):
        workflow.run(dag2, workflow_id="wf2", storage=storage)
    assert workflow.get_status("wf2", storage=storage) == "FAILED"
    fixed = double.bind(add.bind(1, 2))
    out = workflow.resume("wf2", fixed, storage=storage)
    assert out == 6
    # add ran once for wf2's failed attempt, double once on resume; the
    # checkpointed add step did NOT re-execute.
    assert len(calls.read_text().splitlines()) == n_calls + 2
    assert ("wf1", "SUCCESSFUL") in workflow.list_all(storage=storage)
    workflow.delete("wf1", storage=storage)
    assert ("wf1", "SUCCESSFUL") not in workflow.list_all(storage=storage)


def test_workflow_distinct_sibling_steps(cluster, tmp_path):
    """Two binds with identical signatures are distinct steps, each
    executed once (no checkpoint collapse)."""
    marker = tmp_path / "runs.txt"

    @rt.remote
    def sample():
        with open(marker, "a") as f:
            f.write("x\n")
        return 1

    @rt.remote
    def combine(a, b):
        return a + b

    dag = combine.bind(sample.bind(), sample.bind())
    out = workflow.run(dag, workflow_id="wf_sib",
                       storage=str(tmp_path / "wf"))
    assert out == 2
    assert len(marker.read_text().splitlines()) == 2


# ---------------------------------------------------------------------------
# event steps and the management actor (tests/test_workflow_events.py)
# ---------------------------------------------------------------------------

def test_event_checkpoint_and_ack(cluster, tmp_path):
    """An observed event is checkpointed: resume never re-polls, and
    event_checkpointed fires exactly once, after durability."""
    polls = tmp_path / "polls"
    acks = tmp_path / "acks"

    class FileListener(workflow.EventListener):
        def __init__(self, payload):
            self.payload = payload

        def poll_for_event(self):
            polls.write_text(str(int(polls.read_text() or 0) + 1)
                             if polls.exists() else "1")
            return self.payload

        def event_checkpointed(self, event):
            acks.write_text(str(int(acks.read_text() or 0) + 1)
                            if acks.exists() else "1")

    @rt.remote
    def consume(ev):
        return f"got:{ev}"

    storage = str(tmp_path / "wf")
    dag = consume.bind(workflow.wait_for_event(FileListener, "E1"))
    out = workflow.run(dag, workflow_id="evwf", storage=storage)
    assert out == "got:E1"
    assert polls.read_text() == "1" and acks.read_text() == "1"

    # resume: the event step replays from its checkpoint — no new poll
    dag2 = consume.bind(workflow.wait_for_event(FileListener, "E1"))
    out2 = workflow.resume("evwf", dag2, storage=storage)
    assert out2 == "got:E1"
    assert polls.read_text() == "1", "resume must not re-wait for events"


def test_timer_listener(cluster, tmp_path):
    @rt.remote
    def after(ts):
        return time.time() >= ts

    fire_at = time.time() + 1.0
    dag = after.bind(workflow.wait_for_event(workflow.TimerListener,
                                             fire_at))
    assert workflow.run(dag, storage=str(tmp_path / "wf")) is True


def test_cancel_via_management_actor(cluster, tmp_path):
    """A long workflow canceled from 'outside' (the management actor)
    stops before its next step; status and registry reflect CANCELED."""
    storage = str(tmp_path / "wf")

    @rt.remote
    def slow_step(i):
        time.sleep(1.5)
        return i

    @rt.remote
    def combine(*xs):
        return sum(xs)

    # a chain of slow steps gives cancel a window between steps
    n1 = slow_step.bind(1)
    n2 = combine.bind(n1)
    n3 = slow_step.bind(n2)
    n4 = combine.bind(n3)
    fut = workflow.run_async(n4, workflow_id="cancelme", storage=storage)
    time.sleep(0.5)  # let it register + start step 1
    workflow.cancel("cancelme", storage=storage)
    with pytest.raises(workflow.WorkflowCancellationError):
        fut.result(timeout=60)
    assert workflow.get_status("cancelme", storage=storage) == "CANCELED"

    runs = rt.get(
        workflow.get_management_actor().list_runs.remote(), timeout=30
    )
    assert runs["cancelme"]["status"] == "CANCELED"
    assert runs["cancelme"]["host"]


# ---------------------------------------------------------------------------
# step identity against the reference
# ---------------------------------------------------------------------------

def _shapes(pkg, wf, dag_mod):
    """The same DAG shapes through one package's ``remote`` and ``bind``."""

    def add(a, b):
        return a + b

    def double(x):
        return 2 * x

    def sample():
        return 1

    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, x):
            return self.n + x

    add, double, sample = (pkg.remote(f) for f in (add, double, sample))
    counter = pkg.remote(Counter)
    with dag_mod.InputNode() as inp:
        with_input = double.bind(add.bind(inp, 1))
    actor = counter.bind(5)

    def inc(*args):
        return dag_mod.ClassMethodNode(actor, "inc", args, {})

    return {
        "chain": double.bind(add.bind(1, 2)),
        "siblings": add.bind(sample.bind(), sample.bind()),
        "kwargs": add.bind(a=double.bind(3), b=[1, "x", None]),
        "shared": add.bind(*(2 * [double.bind(7)])),
        "actor": inc(add.bind(inc(1), 2)),
        "input": with_input,
        "event": add.bind(wf.wait_for_event(wf.TimerListener, 1.0),
                          double.bind(4)),
    }


def _ids(step_id, root):
    """Every node's step id, in a fixed walk of the DAG from ``root``."""
    cache, out, seen = {}, [], set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for a in list(node._bound_args) + [node._bound_kwargs[k] for k in
                                           sorted(node._bound_kwargs)]:
            if hasattr(a, "_bound_args"):
                walk(a)
        target = getattr(node, "_target", None)
        if hasattr(target, "_bound_args"):
            walk(target)
        out.append((type(node).__name__, step_id(node, cache)))

    walk(root)
    return out


@pytest.mark.parametrize("shape", ["chain", "siblings", "kwargs", "shared",
                                   "actor", "input", "event"])
def test_step_ids_equal_the_reference(shape):
    import ray_tpu
    from ray_tpu import dag as jdag
    from ray_tpu import workflow as jwf
    from ray_tpu_torch import dag as tdag

    want = _ids(jwf._step_id, _shapes(ray_tpu, jwf, jdag)[shape])
    got = _ids(workflow._step_id, _shapes(rt, workflow, tdag)[shape])
    assert got == want
    assert len({sid for _, sid in got}) == len(got)  # every step its own id
