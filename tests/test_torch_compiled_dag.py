"""The port's counterpart of ``tests/test_compiled_dag.py`` (4 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name. The module's cluster starts through
``tests/torch_fixtures.own_port_cluster``, which first shuts down a port
cluster an earlier module on the same xdist worker left up.

The reference's description:

Compiled DAG execution (ray parity: python/ray/dag's accelerated /
experimental_compile path): the graph ships once to a cluster-side
runner, each execute() is a single driver RPC.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, experimental_compile
from tests.torch_fixtures import own_port_cluster


@pytest.fixture(scope="module")
def ray_cluster():
    with own_port_cluster(num_cpus=4):
        yield


def test_compiled_function_chain(ray_cluster):
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))
    compiled = experimental_compile(dag)
    try:
        for i in range(5):
            assert ray_tpu_torch.get(compiled.execute(i), timeout=30) == i * 2 + 1
    finally:
        compiled.teardown()


def test_compiled_actor_pipeline_matches_interpreted(ray_cluster):
    @ray_tpu_torch.remote
    class Stage:
        def __init__(self, offset):
            self.offset = offset
            self.calls = 0

        def apply(self, x):
            self.calls += 1
            return x + self.offset

        def count(self):
            return self.calls

    a = Stage.remote(10)
    b = Stage.remote(100)
    with InputNode() as inp:
        dag = b.apply.bind(a.apply.bind(inp))
    interpreted = ray_tpu_torch.get(dag.execute(1), timeout=30)
    compiled = experimental_compile(dag)
    try:
        assert ray_tpu_torch.get(compiled.execute(1), timeout=30) == interpreted == 111
        # the SAME actor instances serve compiled executions (state shared)
        ray_tpu_torch.get(compiled.execute(2), timeout=30)
        assert ray_tpu_torch.get(a.count.remote(), timeout=30) == 3
    finally:
        compiled.teardown()


def test_compile_rejects_uncreated_actors(ray_cluster):
    @ray_tpu_torch.remote
    class C:
        def f(self, x):
            return x

    @ray_tpu_torch.remote
    def use(actor_result):
        return actor_result

    # a ClassNode anywhere in the graph means the actor would be created
    # per-execution — not a static compiled graph
    dag = use.bind(C.bind())
    with pytest.raises(ValueError, match="pre-created actors"):
        experimental_compile(dag)


def test_compiled_concurrent_executions(ray_cluster):
    """Each execute() is ONE driver RPC whose ref resolves to the final
    value; concurrent executions must stay independent and ordered by
    their inputs (the compiled win is driver round trips — k per call
    interpreted vs 1 — which shows up as latency on remote drivers, not
    as CPU on a single-core box, so this asserts semantics rather than
    wall clock)."""

    @ray_tpu_torch.remote
    class S:
        def f(self, x):
            return x + 1

    stages = [S.remote() for _ in range(4)]
    with InputNode() as inp:
        node = inp
        for s in stages:
            node = s.f.bind(node)
    compiled = experimental_compile(node)
    try:
        refs = [compiled.execute(i * 100) for i in range(10)]
        outs = ray_tpu_torch.get(refs, timeout=120)
        assert outs == [i * 100 + 4 for i in range(10)], outs
    finally:
        compiled.teardown()
