"""The port's LLM serving engine back on its runtime: arena-paged KV cache,
prefix-affinity routing and ``serve.run(LLMServer)`` over HTTP.

- The arena-mode KV cases of ``tests/test_serve_llm.py`` (zero-copy pages
  with their ledger row, pages that die with their client, the lease
  released on close), each run through the reference (``ray_tpu``) and the
  port (``ray_tpu_torch``) on the same store layer, with equal results.
- The router cases: the reference's and the port's ``_RouterState`` fed
  the same reports and requests under the same seeds pick the same
  replicas.
- HTTP through the port's proxy (own cluster): stream with prefix reuse and
  metrics, 503 shed, kill -9 mid-decode leaving no pages, a plain
  deployment left byte-identical, GPT-2 (``real_model=True`` on the CPU at
  ``small_test`` size) streaming the same tokens as the in-process port
  server on the same weights, and a cluster whose every process lacks
  ``boto3`` (the module the card's machine does not have).
"""

import asyncio
import importlib
import json
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import requests
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve._common import SERVE_CONTROLLER_NAME, SERVE_NAMESPACE
from ray_tpu_torch.serve.llm import prefix
from ray_tpu_torch.serve.llm.engine import LLMServer
from ray_tpu_torch.serve.llm.kv_cache import KV_PAGE_OID_PREFIX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV_HEX = KV_PAGE_OID_PREFIX.hex()
PACKAGES = ["ray_tpu", "ray_tpu_torch"]


# ---------------------------------------------------------------------------
# KV pool in arena mode against a real LocalObjectStore, both packages
# ---------------------------------------------------------------------------

class _Pkg:
    """The modules of one package the arena cases use."""

    def __init__(self, name):
        self.name = name
        self.memview = importlib.import_module(f"{name}._private.memview")
        self.slab_arena = importlib.import_module(
            f"{name}._private.slab_arena")
        self.ids = importlib.import_module(f"{name}._private.ids")
        self.object_store = importlib.import_module(
            f"{name}._private.object_store")
        self.kv_cache = importlib.import_module(f"{name}.serve.llm.kv_cache")


class _FakeCoreWorker:
    """The slice of core-worker surface KVPool uses, wired straight to a
    LocalObjectStore (as in ``tests/test_serve_llm.py``)."""

    def __init__(self, pkg, store, client_id="kv"):
        self.pkg = pkg
        self.store = store
        self.client_id = client_id
        self.io = self
        self.raylet = self
        self.reports = []

    def run(self, x, timeout=None):
        return x

    def call_soon(self, x):
        return x

    def request(self, op, payload):
        assert op == "lease_slab"
        return self.store.lease_slab(self.client_id, payload["bytes"],
                                     payload.get("seals"))

    def notify(self, op, payload):
        assert op == "free_objects"
        for b in payload["object_ids"]:
            self.store.delete(self.pkg.ids.ObjectID(b))

    def _queue_slab_report(self, ent):
        self.reports.append(ent)
        self.store.record_slab_objects([ent])


def _arena_pool(pkg, path, **kw):
    store = pkg.object_store.LocalObjectStore(str(path), 1 << 22)
    pool = pkg.kv_cache.KVPool(use_arena=False, **kw)
    pool._worker = _FakeCoreWorker(pkg, store)
    pool._writer = pkg.slab_arena.SlabWriter(str(path))
    return store, pool


@pytest.mark.parametrize("name", PACKAGES)
def test_kv_page_arena_zero_copy_and_ledger(tmp_path, name):
    pkg = _Pkg(name)
    pkg.memview.set_enabled(True)
    pkg.memview.reset()
    store, pool = _arena_pool(pkg, tmp_path / "shm", page_tokens=4,
                              kv_dim=8, max_pages=16)
    try:
        page = pool.alloc()
        assert page.oid is not None and page.oid.startswith(b"KVPG")
        page.data[0] = np.arange(8, dtype=np.float32)
        rb = pool.readback(page)
        assert np.shares_memory(page.data, rb)
        assert np.array_equal(rb[0], np.arange(8, dtype=np.float32))
        oid = pkg.ids.ObjectID(page.oid)
        assert store.contains(oid)
        row = {r["object_id"]: r for r in store.memview_objects()}[
            page.oid.hex()]
        assert row["state"] == "arena"
        assert "test_torch_serve_llm_runtime.py" in (
            pool._worker.reports[0].get("c") or "")
        assert page.oid.hex() in {
            o.hex() for o in pkg.memview.external_pins()}
        dead0 = store.arena_introspect()["dead_bytes"]
        pool.decref(page)
        assert not store.contains(oid)
        assert store.arena_introspect()["dead_bytes"] > dead0
        assert page.oid.hex() not in {
            o.hex() for o in pkg.memview.external_pins()}
        assert pool.counts() == {"active": 0, "cached": 0, "free": 16}
    finally:
        pkg.memview.reset()


@pytest.mark.parametrize("name", PACKAGES)
def test_kv_pages_die_with_client_not_adopted(tmp_path, name):
    pkg = _Pkg(name)
    store, pool = _arena_pool(pkg, tmp_path / "shm", page_tokens=4,
                              kv_dim=8, max_pages=16)
    kv_pages = [pool.alloc() for _ in range(3)]
    assert all(p.oid for p in kv_pages)
    r = store.lease_slab("kv", 1 << 20)
    w = pkg.slab_arena.SlabWriter(store.store_dir)
    w.attach(r["seg_id"], r["size"])
    data_oid = pkg.ids.ObjectID.from_random()
    payload = b"d" * 4096
    assert w.try_put(data_oid.binary(), b"", [payload], len(payload))
    new = store.reclaim_client_slabs("kv")
    assert data_oid.binary() in new, "real data must be adopted"
    assert store.contains(data_oid)
    for p in kv_pages:
        assert p.oid not in new, "KV pages must not be adopted"
        assert not store.contains(pkg.ids.ObjectID(p.oid))


@pytest.mark.parametrize("name", PACKAGES)
def test_kv_pool_releases_lease_on_close(tmp_path, name):
    pkg = _Pkg(name)
    store, pool = _arena_pool(pkg, tmp_path / "shm", page_tokens=4,
                              kv_dim=8, max_pages=16)
    pool.decref(pool.alloc())
    pool.close()  # graceful: seals and retires the lease via lease_slab
    assert store.reclaim_client_slabs("kv") == []


def test_kv_page_prefix_and_layout_equal_the_reference():
    ref, port = _Pkg("ray_tpu"), _Pkg("ray_tpu_torch")
    assert port.kv_cache.KV_PAGE_OID_PREFIX == ref.kv_cache.KV_PAGE_OID_PREFIX
    assert port.slab_arena.HDR == ref.slab_arena.HDR
    assert port.slab_arena.entry_size(0, 4096) == \
        ref.slab_arena.entry_size(0, 4096)


# ---------------------------------------------------------------------------
# the affinity router: the same picks as the reference's
# ---------------------------------------------------------------------------

def _router(name, replicas, reported, index, block_tokens=2, fresh=True):
    handle = importlib.import_module(f"{name}.serve.handle")
    st = handle._RouterState("app", "dep")
    st.replicas = [(n, None) for n in replicas]
    st.inflight = {n: 0 for n in replicas}
    st.reported = dict(reported)
    st.reported_age0 = 0.0
    st.reported_at = time.monotonic() if fresh else None
    st.report_max_age_s = 5.0
    st.prefix_index = {n: frozenset(v) for n, v in index.items()}
    st.prefix_block_tokens = block_tokens
    return st


ROUTER_CASES = {
    # the reference's cases (tests/test_serve_llm.py): longest prefix
    # wins, a score tie, a drowning winner, stale digests, a plain
    # deployment
    "longest_prefix": (["r1", "r2"], {"r1": 0, "r2": 0},
                       {"r1": ["c0"], "r2": ["c0", "c1"]}, True,
                       ["c0", "c1", "c2"]),
    "tie_by_score": (["r1", "r2"], {"r1": 3, "r2": 1},
                     {"r1": ["c0", "c1"], "r2": ["c0", "c1"]}, True,
                     ["c0", "c1", "c2"]),
    "yields_to_load": (["r1", "r2"], {"r1": 0.0, "r2": 10.0},
                       {"r2": ["c0", "c1"]}, True, ["c0", "c1"]),
    "stale_report": (["r1", "r2"], {}, {"r2": ["c0"]}, False, ["c0"]),
    "plain": (["r1", "r2"], {"r1": 0, "r2": 5}, {}, True, []),
    "three_replicas": (["a", "b", "c"], {"a": 2, "b": 0, "c": 1},
                       {"a": ["c0", "c1"], "c": ["c0"]}, True,
                       ["c0", "c1", "c9"]),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_picks_equal_the_reference(case):
    replicas, reported, index, fresh, chains = ROUTER_CASES[case]
    picks = {}
    for name in PACKAGES:
        st = _router(name, replicas, reported, index, fresh=fresh)
        out = []
        for seed in range(40):
            random.seed(seed)
            out.append((st.pick(chains)[0], st.affinity_pick(chains),
                        st.reported_stale()))
        picks[name] = out
    assert picks["ray_tpu_torch"] == picks["ray_tpu"]
    if case == "longest_prefix":
        assert {p[0] for p in picks["ray_tpu_torch"]} == {"r2"}
    if case == "stale_report":
        assert {p[0] for p in picks["ray_tpu_torch"]} == {"r1", "r2"}


def test_router_request_chains_equal_the_reference():
    toks = prefix.tokenize("w0 w1 w2 w3")
    want = prefix.chain_hashes(toks, 2)
    for args, kwargs, expect in (((), {"prompt": "w0 w1 w2 w3"}, want),
                                 ((), {"tokens": toks}, want),
                                 ((7,), {}, [])):
        got = [_router(name, ["r1"], {"r1": 0}, {"r1": ["x"]}
                       ).request_chains(args, kwargs) for name in PACKAGES]
        assert got[0] == got[1] == expect


# ---------------------------------------------------------------------------
# e2e: the port's serve cluster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llm_cluster():
    ray_tpu_torch.init(num_cpus=4)
    serve.start()
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _url(path):
    return f"http://127.0.0.1:{serve.http_port()}{path}"


def _stream_tokens(body, path="/llm", timeout=60):
    toks = []
    with requests.post(_url(path), json=body, stream=True,
                       timeout=timeout) as r:
        assert r.status_code == 200, r.text
        for line in r.iter_lines():
            if line:
                toks.append(json.loads(line)["token"])
    return toks


def test_llm_http_stream_prefix_reuse_and_metrics(llm_cluster):
    dep = serve.deployment(LLMServer, name="llm").options(num_replicas=1)
    h = serve.run(dep.bind(page_tokens=4, max_pages=64,
                           prefix_cache_pages=16),
                  name="llm", route_prefix="/llm")
    body = {"prompt": "sess1 w1 w2 w3 w4 w5 w6 w7", "max_tokens": 6}
    out1 = _stream_tokens(body)
    out2 = _stream_tokens(body)
    assert len(out1) == 6 and out1 == out2
    info = ray_tpu_torch.get(
        h.options(method_name="debug_info").remote().ref)
    assert info["arena_backed"] is True
    assert info["hit_rate"] > 0 and info["counts"]["cached"] > 0
    assert info["tokens_decode"] >= 12
    assert {"kv_cache_hit_rate", "kv_cache_pages", "serve_llm_batch_size",
            "serve_llm_shed_total", "serve_llm_tokens_total"} \
        <= set(info["metric_names"])
    proof = ray_tpu_torch.get(
        h.options(method_name="debug_zero_copy").remote().ref)
    assert proof == {"oid_prefix_ok": True, "shares_memory": True,
                     "roundtrip_ok": True}
    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                         namespace=SERVE_NAMESPACE)
    deadline = time.time() + 15
    llm_state = {}
    while time.time() < deadline:
        st = ray_tpu_torch.get(
            controller.get_replica_state.remote("llm", "llm"))
        llm_state = st.get("llm") or {}
        if any(r.get("prefix_digest") for r in llm_state.values()):
            break
        time.sleep(0.3)
    rep = next(iter(llm_state.values()))
    assert rep["block_tokens"] == 4 and rep["prefix_digest"]
    serve.delete("llm")


def test_llm_http_shed_returns_503(llm_cluster):
    dep = serve.deployment(LLMServer, name="tiny").options(num_replicas=1)
    serve.run(dep.bind(page_tokens=4, max_pages=4, max_queued=2),
              name="tiny", route_prefix="/tiny")
    r = requests.post(_url("/tiny"),
                      json={"prompt": "a b c", "max_tokens": 500},
                      timeout=30)
    assert r.status_code == 503
    assert r.headers.get("Retry-After") == "1"
    assert _stream_tokens({"prompt": "a b c", "max_tokens": 3},
                          path="/tiny") != []
    serve.delete("tiny")


def test_llm_kill9_mid_decode_leaves_no_pages(llm_cluster):
    from ray_tpu_torch.util import state

    dep = serve.deployment(LLMServer, name="victim").options(
        num_replicas=1)
    h = serve.run(dep.bind(page_tokens=4, max_pages=64,
                           step_delay_s=0.05),
                  name="victim", route_prefix="/victim")
    info = ray_tpu_torch.get(
        h.options(method_name="debug_info").remote().ref)
    assert info["arena_backed"] is True
    r = requests.post(_url("/victim"),
                      json={"prompt": "k1 k2 k3 k4 k5", "max_tokens": 200},
                      stream=True, timeout=30)
    it = r.iter_lines()
    next(it)
    next(it)
    os.kill(info["pid"], signal.SIGKILL)
    r.close()
    deadline = time.time() + 20
    kv_rows = None
    while time.time() < deadline:
        merged = state.object_summary()
        kv_rows = [row for row in merged["objects"]
                   if row["object_id"].startswith(KV_HEX)]
        if not kv_rows:
            break
        time.sleep(0.5)
    assert kv_rows == [], f"KV pages survived replica death: {kv_rows}"
    assert not [v for v in merged["verdicts"]
                if v["kind"] == "leak"
                and v.get("object_id", "").startswith(KV_HEX)]
    serve.delete("victim")


def test_flags_off_plain_deployment_byte_identical(llm_cluster):
    @serve.deployment
    class Plain:
        def __call__(self, request):
            return "ok"

    h = serve.run(Plain.bind(), name="plain", route_prefix="/plain")
    assert ray_tpu_torch.get(h.remote(None).ref) == "ok"
    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                         namespace=SERVE_NAMESPACE)
    st = ray_tpu_torch.get(
        controller.get_replica_state.remote("plain", "Plain"))
    assert "llm" not in st and st["names"]
    rep = ray_tpu_torch.get_actor(st["names"][0], namespace=SERVE_NAMESPACE)
    m = ray_tpu_torch.get(rep.get_metrics.remote())
    assert set(m) == {"ongoing", "total"}
    h._state.refresh(force=True)
    assert h._state.prefix_index == {}
    assert h._state.prefix_block_tokens == 0
    serve.delete("plain")


def test_gpt2_over_http_equals_in_process(llm_cluster):
    """``LLMServer(real_model=True, device="cpu")`` at ``small_test`` size
    as a replica streams over HTTP, concurrently, the same greedy tokens as
    the in-process port server built from the same seed."""
    kw = dict(real_model=True, device="cpu", kv_dim=64, page_tokens=4,
              max_pages=128, max_running=4, prefix_cache_pages=16,
              model_kwargs=dict(attention="flash", dtype=torch.float32,
                                seed=3))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 11, 17)]

    local = LLMServer(**kw)

    async def in_process():
        async def one(p):
            from ray_tpu_torch.serve._common import Request

            body = json.dumps({"tokens": p, "max_tokens": 5}).encode()
            return [json.loads(line)["token"]
                    async for line in local(Request(body=body))]
        return await asyncio.gather(*(one(p) for p in prompts))

    try:
        want = asyncio.run(in_process())
    finally:
        local.close()

    dep = serve.deployment(LLMServer, name="gpt2")
    h = serve.run(dep.bind(**kw), name="gpt2", route_prefix="/gpt2")
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(prompts)) as pool:
        got = list(pool.map(lambda p: _stream_tokens(
            {"tokens": p, "max_tokens": 5}, path="/gpt2"), prompts))
    assert got == want
    assert _stream_tokens({"tokens": prompts[0], "max_tokens": 5},
                          path="/gpt2") == want[0]
    info = ray_tpu_torch.get(
        h.options(method_name="debug_info").remote().ref)
    assert info["arena_backed"] is True and info["hit_rate"] > 0
    assert info["pid"] != os.getpid()
    serve.delete("gpt2")


_NO_BOTO3 = """
import json, sys, urllib.request
try:
    import boto3
except ImportError:
    pass
else:
    raise SystemExit("the boto3 stub did not load")
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve.llm import LLMServer

rt.init(num_cpus=2)
try:
    @rt.remote
    def worker_lacks_boto3():
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            return str(e)
        return "imported"

    print("WORKER", rt.get(worker_lacks_boto3.remote(), timeout=60))
    serve.run(serve.deployment(LLMServer, name="llm").bind(
        page_tokens=4, max_pages=32), route_prefix="/llm")
    req = urllib.request.Request(
        f"http://127.0.0.1:{serve.http_port()}/llm", method="POST",
        data=json.dumps({"tokens": [1, 2, 3, 4, 5], "max_tokens": 4}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        toks = [json.loads(line)["token"] for line in r.read().splitlines()]
    print("TOKENS", json.dumps(toks))
    serve.shutdown()
finally:
    rt.shutdown()
"""


def test_cluster_serves_without_boto3(tmp_path):
    """Every process of a port cluster whose ``PYTHONPATH`` starts with a
    stub ``boto3`` that raises ImportError (the card's machine has no
    boto3) serves one request through ``serve.run`` and HTTP."""
    stubs = tmp_path / "stubs"
    (stubs / "boto3").mkdir(parents=True)
    (stubs / "boto3" / "__init__.py").write_text(
        "raise ImportError('boto3 is not installed on this machine')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stubs), REPO]))
    out = subprocess.run([sys.executable, "-c", _NO_BOTO3], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("WORKER ", "TOKENS ")))
    assert lines["WORKER"] == "boto3 is not installed on this machine"
    assert len(json.loads(lines["TOKENS"])) == 4
