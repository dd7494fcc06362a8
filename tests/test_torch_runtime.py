"""The port's runtime (``ray_tpu_torch``: GCS, raylet, workers, object
plane, core API) on the CPU, beside the reference's (``ray_tpu``).

One port cluster and one reference cluster run for the whole module, at the
same time on this host. Cases mirror ``tests/test_basic.py`` and
``tests/test_actor.py`` with the reference's expected values; three programs
(tasks, actors, objects) run through both packages and must give equal
results; the device resource is "GPU" in the port where it is "TPU" in the
reference; and the two clusters never see each other's nodes, actors or
environment.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from tests.conftest import wait_for_condition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, resources={"custom": 2.0})
    ray_tpu.init(num_cpus=2, num_tpus=1)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


rt = ray_tpu_torch


# ---------------------------------------------------------------------------
# tasks and objects (tests/test_basic.py)
# ---------------------------------------------------------------------------

def test_put_get(clusters):
    assert rt.get(rt.put(41)) == 41
    arr = np.arange(1_000_000, dtype=np.float32)  # large -> slab arena
    out = rt.get(rt.put(arr))
    np.testing.assert_array_equal(out, arr)
    assert not out.flags.writeable  # zero-copy read of the store mapping


def test_task_with_ref_args_and_large_values(clusters):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def double(a):
        return a * 2

    x = rt.put(10)
    y = add.remote(x, 5)
    assert rt.get(add.remote(y, y)) == 30
    arr = np.ones((512, 1024), dtype=np.float32)
    np.testing.assert_array_equal(rt.get(double.remote(arr)), arr * 2)


def test_multiple_returns_and_nested_tasks(clusters):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def inner(x):
        return x * 10

    @rt.remote
    def outer(x):
        import ray_tpu_torch as port

        return port.get(inner.remote(x)) + 1

    @rt.remote
    def make_refs():
        import ray_tpu_torch as port

        return [port.put(1), port.put(2)]

    assert rt.get(list(three.remote())) == [1, 2, 3]
    assert rt.get(outer.remote(4)) == 41
    assert rt.get(rt.get(make_refs.remote())) == [1, 2]


def test_task_error_propagates(clusters):
    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("kaput")

    @rt.remote
    def consume(x):
        return x

    with pytest.raises(rt.TaskError) as exc_info:
        rt.get(boom.remote())
    assert "kaput" in str(exc_info.value)
    assert isinstance(exc_info.value.cause, ValueError)
    with pytest.raises(rt.TaskError):
        rt.get(consume.remote(boom.remote()))


def test_wait_and_get_timeout(clusters):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    a, b = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([a, b], num_returns=1, timeout=4)
    assert ready == [a] and not_ready == [b]
    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.5)


def test_many_small_tasks_options_and_custom_resources(clusters):
    @rt.remote
    def sq(i):
        return i * i

    @rt.remote(num_cpus=1, resources={"custom": 1})
    def f():
        return "ok"

    assert rt.get([sq.remote(i) for i in range(50)]) == [
        i * i for i in range(50)]
    assert rt.get(f.options(num_cpus=2).remote()) == "ok"


def test_runtime_context(clusters):
    ctx = rt.get_runtime_context()
    assert ctx.node_id and ctx.get_job_id()

    @rt.remote
    def get_task_id():
        import ray_tpu_torch as port

        return port.get_runtime_context().get_task_id()

    assert rt.get(get_task_id.remote()) is not None


# ---------------------------------------------------------------------------
# actors (tests/test_actor.py)
# ---------------------------------------------------------------------------

def test_actor_basic_ordering_and_errors(clusters):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start
            self.items = []

        def incr(self, k=1):
            self.n += k
            return self.n

        def add(self, x):
            self.items.append(x)
            return list(self.items)

        def boom(self):
            raise KeyError("nope")

    c = Counter.remote(5)
    assert rt.get(c.incr.remote()) == 6
    assert rt.get(c.incr.remote(10)) == 16
    refs = [c.add.remote(i) for i in range(20)]
    assert rt.get(refs[-1]) == list(range(20))
    with pytest.raises(rt.TaskError):
        rt.get(c.boom.remote())
    assert rt.get(c.incr.remote()) == 17  # the actor survives the error


def test_actor_init_error(clusters):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("bad init")

        def ping(self):
            return "pong"

    with pytest.raises(Exception):
        rt.get(Broken.remote().ping.remote(), timeout=30)


def test_named_actors_get_if_exists_and_kill(clusters):
    @rt.remote
    class A:
        def __init__(self):
            self.t = time.time()

        def created(self):
            return self.t

    a = A.options(name="shared", namespace="ns1").remote()
    with pytest.raises(ValueError):
        rt.get_actor("shared", namespace="ns2")
    h = rt.get_actor("shared", namespace="ns1")
    assert rt.get(h.created.remote()) == rt.get(a.created.remote())
    s1 = A.options(name="singleton", get_if_exists=True).remote()
    s2 = A.options(name="singleton", get_if_exists=True).remote()
    assert rt.get(s1.created.remote()) == rt.get(s2.created.remote())
    rt.kill(a)

    def call_fails():  # kill is asynchronous, as in tests/test_actor_ft.py
        try:
            rt.get(a.created.remote(), timeout=10)
            return False
        except Exception:
            return True

    wait_for_condition(call_fails, timeout=30)
    with pytest.raises(Exception):
        rt.get(a.created.remote(), timeout=10)
    rt.kill(s1)


def test_async_actor_and_handle_pass(clusters):
    import asyncio

    @rt.remote(max_concurrency=8)
    class AsyncActor:
        async def work(self, t):
            await asyncio.sleep(t)
            return "async-done"

    @rt.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    @rt.remote
    def writer(store, k, v):
        import ray_tpu_torch as port

        port.get(store.set.remote(k, v))
        return True

    a = AsyncActor.remote()
    rt.get(a.work.remote(0.01), timeout=60)
    t0 = time.time()
    assert rt.get([a.work.remote(1.0) for _ in range(5)],
                  timeout=60) == ["async-done"] * 5
    assert time.time() - t0 < 4.5  # serial execution would take >= 5s
    s = Store.remote()
    assert rt.get(writer.remote(s, "x", 7))
    assert rt.get(s.get.remote("x")) == 7


def test_placement_group(clusters):
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, placement_group_table,
                                    remove_placement_group)

    pg = placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="PACK")
    assert pg.wait(30)

    @rt.remote(num_cpus=1)
    def where():
        import ray_tpu_torch as port

        return port.get_runtime_context().node_id

    strat = PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=1)
    assert rt.get(where.options(scheduling_strategy=strat).remote(),
                  timeout=30) == rt.get_runtime_context().node_id
    assert placement_group_table(pg)["state"] == "CREATED"
    remove_placement_group(pg)


# ---------------------------------------------------------------------------
# the same program through both packages
# ---------------------------------------------------------------------------

def _tasks_program(pkg):
    @pkg.remote
    def poly(x):
        return 3 * x * x + 2 * x + 1

    @pkg.remote
    def total(*xs):
        return sum(xs)

    return pkg.get(total.remote(*[poly.remote(i) for i in range(12)]))


def _actors_program(pkg):
    @pkg.remote
    class Acc:
        def __init__(self):
            self.log = []

        def push(self, x):
            self.log.append(x * 2)
            return len(self.log)

        def dump(self):
            return list(self.log)

    a = Acc.remote()
    counts = pkg.get([a.push.remote(i) for i in range(10)])
    return counts, pkg.get(a.dump.remote())


def _objects_program(pkg):
    @pkg.remote
    def colsum(a):
        return a.sum(axis=0)

    rng = np.random.default_rng(0)
    big = rng.standard_normal((300, 400)).astype(np.float32)  # > 100 KB
    ref = pkg.put(big)
    ready, _ = pkg.wait([colsum.remote(ref)], num_returns=1, timeout=30)
    return pkg.get(ready[0]).tolist(), pkg.get(ref).dtype.str


@pytest.mark.parametrize("program", [_tasks_program, _actors_program,
                                     _objects_program],
                         ids=["tasks", "actors", "objects"])
def test_same_program_same_result(clusters, program):
    assert program(ray_tpu_torch) == program(ray_tpu)


# ---------------------------------------------------------------------------
# the device resource
# ---------------------------------------------------------------------------

def test_init_num_gpus_advertises_gpu(clusters):
    assert rt.cluster_resources()["GPU"] == 1.0
    assert "TPU" not in rt.cluster_resources()
    assert ray_tpu.cluster_resources()["TPU"] == 1.0


@pytest.mark.parametrize("pkg,resource", [(ray_tpu_torch, "GPU"),
                                          (ray_tpu, "TPU")],
                         ids=["port-GPU", "reference-TPU"])
def test_second_device_actor_stays_pending(clusters, pkg, resource):
    """One card: an actor asking for it is placed; a second stays pending
    until the first is killed, in the port (num_gpus) as in the
    reference (num_tpus)."""
    opt = {"GPU": "num_gpus", "TPU": "num_tpus"}[resource]

    @pkg.remote(**{opt: 1})
    class Holder:
        def ping(self):
            return "up"

    first = Holder.remote()
    assert pkg.get(first.ping.remote(), timeout=30) == "up"
    second = Holder.remote()
    ref = second.ping.remote()
    ready, _ = pkg.wait([ref], num_returns=1, timeout=2.0)
    assert ready == [], "a second one-card actor was placed on one card"
    pkg.kill(first)
    assert pkg.get(ref, timeout=30) == "up"
    pkg.kill(second)


def test_num_tpus_is_not_an_option_of_the_port():
    """No node of the port advertises "TPU", so the option would leave a
    task or actor pending for ever: it is refused like any unknown one."""
    with pytest.raises(ValueError, match="num_tpus"):
        rt.remote(num_tpus=1)(lambda: None)

    @rt.remote
    class A:
        pass

    with pytest.raises(ValueError, match="num_tpus"):
        A.options(num_tpus=1)


def test_detect_resources_reads_cuda_visible_devices(monkeypatch):
    from ray_tpu_torch._private import resource_spec
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,3")
    res, labels = resource_spec.detect_resources()
    assert res["GPU"] == 3.0 and "TPU" not in res and labels == {}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert "GPU" not in resource_spec.detect_resources()[0]
    # the probe reads nvidia-smi's card names, never a CUDA context
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(resource_spec, "_nvidia_smi_cards",
                        lambda: ["NVIDIA H100 80GB HBM3"])
    GLOBAL_CONFIG.update({"gpu_autodetect": True})
    try:
        res, labels = resource_spec.detect_resources()
    finally:
        GLOBAL_CONFIG.update({"gpu_autodetect": False})
    assert res["GPU"] == 1.0
    assert labels == {"gpu-device-kind": "NVIDIA H100 80GB HBM3"}


# ---------------------------------------------------------------------------
# the two runtimes never see each other
# ---------------------------------------------------------------------------

def test_port_worker_imports_nothing_of_the_reference(clusters):
    @rt.remote
    def modules():
        import sys as _sys

        mods = {n: getattr(m, "__file__", None)
                for n, m in list(_sys.modules.items())
                if n == "ray_tpu_torch" or n.startswith("ray_tpu")}
        return mods, _sys.modules["__main__"].__spec__.name

    mods, main = rt.get(modules.remote())
    assert main == "ray_tpu_torch._private.worker_main"
    assert not [n for n in mods if n == "ray_tpu" or
                n.startswith("ray_tpu.")]
    port_dir = os.path.join(REPO, "ray_tpu_torch") + os.sep
    files = [f for f in mods.values() if f]
    assert files and all(f.startswith(port_dir) for f in files), files


def test_clusters_do_not_see_each_other(clusters):
    from ray_tpu.util import state as jstate
    from ray_tpu_torch.util import state as tstate

    port_nodes = {n["node_id"] for n in rt.nodes()}
    ref_nodes = {n["node_id"] for n in ray_tpu.nodes()}
    assert port_nodes and ref_nodes and not port_nodes & ref_nodes

    @rt.remote
    class Named:
        def who(self):
            return "port"

    a = Named.options(name="coexist_only_in_port").remote()
    assert rt.get(a.who.remote()) == "port"
    with pytest.raises(ValueError):
        ray_tpu.get_actor("coexist_only_in_port")
    names = {r.get("name") for r in tstate.list_actors()}
    assert "coexist_only_in_port" in names
    assert "coexist_only_in_port" not in {
        r.get("name") for r in jstate.list_actors()}

    # each runs its own tasks, in its own session root
    @rt.remote
    def port_env():
        import os as _os

        return {k: v for k, v in _os.environ.items()
                if k.startswith("RAY_TPU_")}

    @ray_tpu.remote
    def ref_env():
        import os as _os

        return {k: v for k, v in _os.environ.items()
                if k.startswith("RAY_TPU_")}

    penv, renv = rt.get(port_env.remote()), ray_tpu.get(ref_env.remote())
    assert penv["RAY_TPU_TORCH_SESSION_DIR"].startswith(
        "/dev/shm/ray_tpu_torch/")
    assert renv["RAY_TPU_SESSION_DIR"].startswith("/dev/shm/ray_tpu/")
    port_gcs = ray_tpu_torch._private.worker.global_worker.node.address
    ref_gcs = ray_tpu._private.worker.global_worker.node.address
    assert port_gcs != ref_gcs
    assert penv["RAY_TPU_TORCH_GCS_ADDR"] == port_gcs
    assert renv["RAY_TPU_GCS_ADDR"] == ref_gcs
    # the control-plane processes are the port's own modules
    node = ray_tpu_torch._private.worker.global_worker.node
    for proc in (node.gcs_proc, node.raylet_proc):
        assert any(a.startswith("ray_tpu_torch._private.") for a in proc.args)
    rt.kill(a)


def test_address_auto_in_a_port_worker_joins_the_port_cluster(clusters):
    """``init(address="auto")`` reads RAY_TPU_TORCH_GCS_ADDR, which the
    port's raylet stamps into its workers' environment; a process started
    from a port worker joins the port's cluster, not the reference's."""

    @rt.remote
    def join_from_child():
        import subprocess as sp
        import sys as _sys

        code = ("import json, ray_tpu_torch as p; p.init(address='auto'); "
                "print(json.dumps(sorted(n['node_id'] for n in p.nodes()))); "
                "p.shutdown()")
        out = sp.run([_sys.executable, "-c", code], capture_output=True,
                     text=True, timeout=60)
        return out.returncode, out.stdout, out.stderr

    rc, out, err = rt.get(join_from_child.remote(), timeout=90)
    assert rc == 0, err
    seen = json.loads(out.strip().splitlines()[-1])
    assert set(seen) == {n["node_id"] for n in rt.nodes()}
    assert not set(seen) & {n["node_id"] for n in ray_tpu.nodes()}


def test_import_is_cheap_and_control_plane_needs_no_torch():
    code = ("import sys, ray_tpu_torch; "
            "from ray_tpu_torch._private import gcs, raylet, node; "
            "from ray_tpu_torch.dashboard import prometheus; "
            "import ray_tpu_torch.serve; "
            "print(sorted(m for m in ('torch', 'jax', 'ray_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_grafana_dashboard_shape(tmp_path):
    """The reference's ``test_util_shims.py::test_grafana_dashboard_shape``
    through the port: its dashboard scrapes the port's metric names (the
    cluster built-ins keep the reference's ``ray_tpu_*`` names) and the
    reference's panels, and its own uid."""
    from ray_tpu.dashboard.grafana import generate_dashboard as ref_dash
    from ray_tpu_torch.dashboard import prometheus
    from ray_tpu_torch.dashboard.grafana import (generate_dashboard,
                                                 write_dashboard)

    dash = generate_dashboard(user_metrics=["my_app_requests_total"])
    assert dash["uid"] == "ray-tpu-torch-cluster"
    exprs = [p["targets"][0]["expr"] for p in dash["panels"]]
    assert "ray_tpu_node_count" in exprs
    assert "my_app_requests_total" in exprs
    want = ref_dash(user_metrics=["my_app_requests_total"])
    assert exprs == [p["targets"][0]["expr"] for p in want["panels"]]
    src = open(prometheus.__file__).read()
    for expr in exprs[:4]:  # the built-ins are the port's scrape's names
        assert f'"{expr}"' in src, expr
    path = write_dashboard(str(tmp_path / "dash.json"))
    loaded = json.load(open(path))
    assert loaded["panels"]
