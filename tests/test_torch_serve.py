"""The port's Serve control plane (``ray_tpu_torch.serve``) on the CPU:
``serve.run`` of plain deployments over HTTP through the port's proxy and
through handles, streaming, multiplexed models, a redeploy under the same
name, and the typed load-shed (503 with ``Retry-After``). Cases mirror
``tests/test_serve.py`` and
``tests/test_serve_streaming.py`` with the reference's expected values.

The client always asks ``serve.http_port()``: the proxy counts up from 8000
when the port is taken, and the reference's proxies may hold 8000 on this
host at the same time.
"""

import time

import pytest
import requests

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=4)
    serve.start()
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _url(path):
    return f"http://127.0.0.1:{serve.http_port()}{path}"


def test_basic_deploy_http_and_handle(serve_cluster):
    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, request: serve.Request):
            return {"path": request.path, "q": request.query.get("v")}

        def direct(self, x):
            return x + 1

    handle = serve.run(Echo.bind(), name="echo", route_prefix="/echo")
    r = requests.get(_url("/echo"), params={"v": "5"}, timeout=30)
    assert r.status_code == 200
    assert r.json() == {"path": "/echo", "q": "5"}
    assert handle.direct.remote(41).result(timeout_s=30) == 42
    serve.delete("echo")


def test_function_deployment_and_post_json(serve_cluster):
    @serve.deployment
    def square(request: serve.Request):
        return {"out": int(request.query["x"]) ** 2}

    @serve.deployment
    class Adder:
        def __call__(self, request: serve.Request):
            payload = request.json()
            return {"sum": payload["a"] + payload["b"]}

    serve.run(square.bind(), name="fn", route_prefix="/sq")
    serve.run(Adder.bind(), name="adder", route_prefix="/add")
    assert requests.get(_url("/sq"), params={"x": "9"},
                        timeout=30).json() == {"out": 81}
    assert requests.post(_url("/add"), json={"a": 2, "b": 3},
                         timeout=30).json() == {"sum": 5}
    serve.delete("fn")
    serve.delete("adder")


def test_composition_and_options(serve_cluster):
    @serve.deployment
    class Child:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Parent:
        def __init__(self, child):
            self.child = child

        def __call__(self, request: serve.Request):
            return self.child.remote(int(request.query["x"])).result(
                timeout_s=30)

    serve.run(Parent.bind(Child.options(num_replicas=2).bind()),
              name="comp", route_prefix="/comp")
    r = requests.get(_url("/comp"), params={"x": "4"}, timeout=30)
    assert r.json() == 40
    st = serve.status()["comp"]["deployments"]
    assert st["Child"]["running_replicas"] == 2
    serve.delete("comp")


def test_batching(serve_cluster):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def __call__(self, items):
            return [{"v": i, "batch": len(items)} for i in items]

    handle = serve.run(Batched.bind(), name="batched", route_prefix="/b")
    outs = [f.result(timeout_s=30) for f in
            [handle.remote(i) for i in range(4)]]
    assert sorted(o["v"] for o in outs) == [0, 1, 2, 3]
    assert any(o["batch"] > 1 for o in outs)
    serve.delete("batched")


def test_multiplexed_models(serve_cluster):
    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def load(self, model_id: str):
            return {"id": model_id, "loaded_at": time.time()}

        async def __call__(self, model_id: str):
            m = await self.load(model_id)
            return m["id"]

    handle = serve.run(MultiModel.bind(), name="mm", route_prefix="/mm")
    assert handle.remote("a").result(timeout_s=30) == "a"
    assert handle.remote("b").result(timeout_s=30) == "b"
    assert handle.remote("a").result(timeout_s=30) == "a"
    serve.delete("mm")


def test_http_streaming_incremental(serve_cluster):
    """Chunks arrive while the handler still sleeps between yields."""

    @serve.deployment
    class Streamer:
        def __call__(self, request: serve.Request):
            n = int(request.query.get("n", "5"))
            for i in range(n):
                yield f"tok{i} "
                time.sleep(0.25)

    serve.run(Streamer.bind(), name="stream", route_prefix="/stream")
    t0 = time.time()
    first_chunk_at = None
    chunks = []
    with requests.get(_url("/stream"), params={"n": 5}, stream=True,
                      timeout=60) as r:
        assert r.status_code == 200
        for chunk in r.iter_content(chunk_size=None):
            if first_chunk_at is None:
                first_chunk_at = time.time() - t0
            chunks.append(chunk)
    total = time.time() - t0
    assert b"".join(chunks).decode() == "tok0 tok1 tok2 tok3 tok4 "
    assert first_chunk_at is not None and first_chunk_at < total - 0.5
    serve.delete("stream")


def test_handle_streaming_and_error_delivers_prior_chunks(serve_cluster):
    @serve.deployment
    class Gen:
        async def __call__(self, n: int):
            for i in range(n):
                yield i * i

    @serve.deployment
    class Flaky:
        def __call__(self, _n):
            yield "a"
            yield "b"
            raise RuntimeError("boom mid-stream")

    handle = serve.run(Gen.bind(), name="gen", route_prefix="/gen")
    assert list(handle.options(stream=True).remote(6)) == [
        0, 1, 4, 9, 16, 25]
    flaky = serve.run(Flaky.bind(), name="flaky", route_prefix="/flaky")
    seen = []
    with pytest.raises(Exception, match="boom mid-stream"):
        for item in flaky.options(stream=True).remote(0):
            seen.append(item)
    assert seen == ["a", "b"]
    serve.delete("gen")
    serve.delete("flaky")


def test_overloaded_error_is_503_with_retry_after(serve_cluster):
    """The typed load-shed maps to 503 + ``Retry-After: 1``, for a plain
    handler and for a streaming one that sheds before its first yield;
    any other failure stays a 500."""
    from ray_tpu_torch.serve._common import OverloadedError

    @serve.deployment
    class Shedder:
        def __call__(self, request: serve.Request):
            if request.query.get("fail") == "other":
                raise ValueError("broken handler")
            raise OverloadedError("queue full")

    @serve.deployment
    class StreamShedder:
        async def __call__(self, request: serve.Request):
            raise OverloadedError("kv budget")
            yield b"never"

    serve.run(Shedder.bind(), name="shed", route_prefix="/shed")
    serve.run(StreamShedder.bind(), name="sshed", route_prefix="/sshed")
    r = requests.get(_url("/shed"), timeout=30)
    assert r.status_code == 503 and r.headers.get("Retry-After") == "1"
    assert "SERVE_OVERLOADED" in r.text
    r = requests.get(_url("/sshed"), timeout=30)
    assert r.status_code == 503 and r.headers.get("Retry-After") == "1"
    r = requests.get(_url("/shed"), params={"fail": "other"}, timeout=30)
    assert r.status_code == 500 and "Retry-After" not in r.headers
    serve.delete("shed")
    serve.delete("sshed")


def test_unknown_route_404_and_broken_constructor(serve_cluster):
    assert requests.get(_url("/definitely-not-a-route-xyz"),
                        timeout=30).status_code == 404

    @serve.deployment
    class Broken:
        def __init__(self):
            raise RuntimeError("cannot construct")

        def __call__(self, _r=None):
            return "unreachable"

    with pytest.raises(RuntimeError, match="failed to become ready"):
        serve.run(Broken.bind(), name="broken", route_prefix="/broken")

    @serve.deployment
    def ok(_request):
        return "ok"

    serve.run(ok.bind(), name="okapp", route_prefix="/okapp")
    assert requests.get(_url("/okapp"), timeout=30).text == "ok"
    serve.delete("okapp")
    serve.delete("broken")


def test_serve_actors_are_the_ports(serve_cluster):
    """Controller, proxy and replicas are port actors in namespace
    "serve", listed by the port's cluster state."""
    from ray_tpu_torch.serve._common import (SERVE_CONTROLLER_NAME,
                                             SERVE_NAMESPACE)
    from ray_tpu_torch.util import state

    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                         namespace=SERVE_NAMESPACE)
    assert controller is not None
    names = {r.get("name") for r in state.list_actors()
             if r.get("state") == "ALIVE"}
    assert SERVE_CONTROLLER_NAME in names
    assert any("proxy" in (n or "").lower() for n in names), names


def test_autoscaling_scales_up(serve_cluster):
    """``tests/test_serve.py::test_autoscaling_scales_up`` through the
    port: the controller's ``_autoscale_once`` raises the replica count of
    a deployment whose ongoing requests exceed its target (the CPU case of
    chip_smoke phase 34's path)."""
    @serve.deployment(
        autoscaling_config={
            "min_replicas": 1, "max_replicas": 3,
            "target_ongoing_requests": 1, "upscale_delay_s": 0.1,
        },
    )
    class Slow:
        def __call__(self, _request=None):
            time.sleep(1.5)
            return "done"

    handle = serve.run(Slow.bind(), name="auto", route_prefix="/auto")
    assert serve.status()["auto"]["deployments"]["Slow"][
        "running_replicas"] == 1
    futs = [handle.remote() for _ in range(6)]
    deadline = time.time() + 30
    scaled = False
    while time.time() < deadline:
        n = serve.status()["auto"]["deployments"]["Slow"]["running_replicas"]
        if n > 1:
            scaled = True
            break
        time.sleep(0.25)
    assert scaled, "autoscaler never scaled up under load"
    for f in futs:
        assert f.result(timeout_s=60) == "done"
    serve.delete("auto")


def test_redeploy_updates_code(serve_cluster):
    def make(version):
        @serve.deployment(name="V")
        class V:
            def __call__(self, _request=None):
                return version

        return V

    serve.run(make("v1").bind(), name="ver", route_prefix="/ver")
    # str results render as plain text (dicts/lists as JSON)
    assert requests.get(_url("/ver"), timeout=30).text == "v1"
    serve.run(make("v2").bind(), name="ver", route_prefix="/ver")
    deadline = time.time() + 30
    while time.time() < deadline:
        r = requests.get(_url("/ver"), timeout=30)
        assert r.status_code == 200, r.text  # rolling update: no downtime
        if r.text == "v2":
            break
        time.sleep(0.2)
    assert requests.get(_url("/ver"), timeout=30).text == "v2"
    serve.delete("ver")


def test_load_harness_smoke(serve_cluster):
    """``tests/test_reqtrace.py::test_load_harness_smoke`` through the
    port's ``serve.load_harness``: the open-loop harness drives a 2-replica
    deployment through the port's proxy and reports latency/TTFT
    percentiles and queue-depth samples. Then what the port adds: a
    payload per request in turn, and every answer's body kept."""
    from ray_tpu_torch.serve.load_harness import percentiles, run_load

    @serve.deployment(num_replicas=2, max_ongoing_requests=256)
    class L:
        async def __call__(self, request):
            return b"ok:" + request.body

    serve.run(L.bind(), name="rt_load", route_prefix="/rt_load")
    out = run_load(_url("/rt_load"), rps=40, duration_s=2.0,
                   connections=64, depth_sampler=lambda: 0.0,
                   depth_sample_interval_s=0.5)
    assert out["ok"] >= 0.9 * out["requests"], out["error_kinds"]
    assert out["latency"]["p50"] > 0
    assert out["ttft"]["count"] > 0
    assert out["queue_depth_series"], "no depth samples collected"
    assert out["peak_inflight"] >= 1
    # open-loop: the offered schedule spans ~duration_s whatever the service
    assert out["wall_s"] >= 1.5
    assert "bodies" not in out

    out = run_load(_url("/rt_load"), rps=20, duration_s=1.0, connections=8,
                   method="POST", payloads=[b"a", b"b", b"c"],
                   keep_bodies=True)
    assert [b["i"] for b in out["bodies"]] == list(range(out["requests"]))
    for b in out["bodies"]:
        assert b["status"] == 200
        assert b["body"] == b"ok:" + b"abc"[b["i"] % 3:b["i"] % 3 + 1]
    assert percentiles([]) == {"count": 0, "mean": 0.0, "p50": 0.0,
                               "p95": 0.0, "p99": 0.0, "max": 0.0}
    serve.delete("rt_load")
