"""The port's LLM engine against ``ray_tpu.serve.llm`` on the same inputs.

Synthetic-model scenarios run through both schedulers and must stream
IDENTICAL tokens. The GPT-2 adapter runs JAX-initialised small_test
weights bridged into the port, in f32, and must give the JAX adapter's
greedy tokens exactly. Tests also pin where the port departs from the
reference on purpose (the reference's serving faults), the import rule of
the port, and that its entry points refuse to run on the CPU unless asked.
"""

import ast
import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu._private.config import GLOBAL_CONFIG
from ray_tpu.serve._common import OverloadedError as JOverloaded
from ray_tpu.serve.llm import engine as jeng
from ray_tpu.serve.llm import kv_cache as jkv
from ray_tpu.serve.llm import model as jmodel
from ray_tpu.serve.llm import prefix as jprefix
from ray_tpu_torch.serve._common import OverloadedError as TOverloaded
from ray_tpu_torch.serve._common import Request, is_overloaded_error
from ray_tpu_torch.serve.llm import engine as teng
from ray_tpu_torch.serve.llm import kv_cache as tkv
from ray_tpu_torch.serve.llm import model as tmodel
from ray_tpu_torch.serve.llm import prefix as tprefix

pytestmark = pytest.mark.llm

REPO = Path(__file__).resolve().parents[1]

IMPLS = {
    "jax": dict(sched=jeng.SequenceScheduler, model=jmodel.SyntheticLLM,
                pool=lambda **kw: jkv.KVPool(use_arena=False, **kw),
                cache=jkv.PrefixCache, overloaded=JOverloaded),
    "torch": dict(sched=teng.SequenceScheduler, model=tmodel.SyntheticLLM,
                  pool=lambda **kw: tkv.KVPool(**kw),
                  cache=tkv.PrefixCache, overloaded=TOverloaded),
}


def _both(scenario):
    """Run ``scenario(impl)`` on both engines; the traces must be equal."""
    traces = {name: scenario(impl) for name, impl in IMPLS.items()}
    assert traces["torch"] == traces["jax"]
    return traces["torch"]


def _sched(impl, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("max_queued", 8)
    pool = impl["pool"](page_tokens=kw.pop("page_tokens", 4), kv_dim=8,
                        max_pages=kw.pop("max_pages", 32))
    return impl["sched"](impl["model"](kv_dim=8), pool, **kw)


async def _run_one(s, tokens, n):
    seq = await s.submit(tokens, n)
    out = [t async for t in s.stream(seq)]
    return seq, out


# ---------------------------------------------------------------------------
# prefix identity: byte-identical to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,block", [
    ([1, 2, 3, 4, 5, 6, 7], 2), ([9, 9, 3, 4, 5, 6], 2), ([1], 2),
    (list(range(100)), 16), ([1, 2, 3], 0), ([2 ** 40, -3, 7], 1),
])
def test_chain_hashes_equal_reference(tokens, block):
    assert tprefix.chain_hashes(tokens, block) \
        == jprefix.chain_hashes(tokens, block)


def test_tokenize_digest_and_match_equal_reference():
    text = "the quick fox the lazy dog"
    assert tprefix.tokenize(text) == jprefix.tokenize(text)
    assert tprefix.tokenize(text, vocab=97) == jprefix.tokenize(text, vocab=97)
    chains = tprefix.chain_hashes(list(range(64)), 4)
    for cap in (0, 3, 100):
        assert tprefix.digest(chains, cap) == jprefix.digest(chains, cap)
    held = set(chains[:5]) | {chains[7]}
    assert tprefix.longest_match_depth(chains, held) \
        == jprefix.longest_match_depth(chains, held) == 5
    for args, kwargs in ((((),), {"tokens": [1, 2]}),
                         (({"prompt": "a b"},), {}), ((42,), {})):
        assert tprefix.extract_tokens(args, kwargs) \
            == jprefix.extract_tokens(args, kwargs)


# ---------------------------------------------------------------------------
# KV pool (heap mode) and prefix cache
# ---------------------------------------------------------------------------

def test_kv_pool_heap_budget_and_free():
    def scenario(impl):
        pool = impl["pool"](page_tokens=4, kv_dim=8, max_pages=3)
        assert not pool.arena_backed
        pages = [pool.alloc() for _ in range(3)]
        assert all(p is not None for p in pages)
        trace = [pool.alloc() is None, pool.counts()]
        pool.incref(pages[0])
        pool.decref(pages[0])
        trace.append(pool.available())
        for p in pages:
            pool.decref(p)
        return trace + [pool.counts()]

    assert _both(scenario) == [True, {"active": 3, "cached": 0, "free": 0}, 0,
                               {"active": 0, "cached": 0, "free": 3}]


def test_prefix_cache_match_and_lru_eviction():
    def scenario(impl):
        pool = impl["pool"](page_tokens=4, kv_dim=8, max_pages=8)
        cache = impl["cache"](pool, max_pages=2)
        p0, p1, p2 = (pool.alloc() for _ in range(3))
        cache.insert("c0", p0)
        cache.insert("c1", p1)
        got = cache.match(["c0", "c1", "c-miss", "c1"])
        trace = [[{id(p0): 0, id(p1): 1}[id(p)] for p in got]]
        for p in got:
            pool.decref(p)
        cache.insert("c2", p2)
        trace.append(sorted(cache.chains()))
        for p in (p0, p1, p2):
            pool.decref(p)
        trace.append(pool.counts()["cached"])
        cache.note_lookup(10, 4)
        trace.append(cache.hit_rate())
        cache.clear()
        return trace + [pool.counts()]

    assert _both(scenario) == [[0, 1], ["c1", "c2"], 2, 0.4,
                               {"active": 0, "cached": 0, "free": 8}]


# ---------------------------------------------------------------------------
# sequence scheduler: identical streams
# ---------------------------------------------------------------------------

def test_scheduler_deterministic_and_prefix_reuse():
    def scenario(impl):
        async def main():
            s = _sched(impl, prefix_cache_pages=16)
            seq1, out1 = await _run_one(s, list(range(10)), 6)
            seq2, out2 = await _run_one(s, list(range(10)), 6)
            assert len(out1) == 6 and out1 == out2
            trace = [out1, seq1.cached_tokens, seq2.cached_tokens,
                     s.cache.hit_rate()]
            s.stop()
            return trace + [s.pool.counts()]
        return asyncio.run(main())

    trace = _both(scenario)
    assert trace[1:3] == [0, 8] and trace[3] > 0
    assert trace[4]["active"] == 0 and trace[4]["cached"] == 0


def test_scheduler_copy_on_extend_protects_cached_tail():
    def scenario(impl):
        async def main():
            s = _sched(impl, prefix_cache_pages=16)
            _, out1 = await _run_one(s, list(range(8)), 4)
            chains = s.cache.chains()
            assert chains
            snap = {c: s.cache._pages[c].data.copy() for c in chains}
            _, out2 = await _run_one(s, list(range(8)), 8)
            for c in chains:
                assert np.array_equal(s.cache._pages[c].data, snap[c]), \
                    "cached page mutated by a borrowing sequence"
            s.stop()
            return [out1, out2, len(chains)]
        return asyncio.run(main())

    _both(scenario)


def test_scheduler_continuous_admits_mid_batch_drain_does_not():
    def scenario(impl):
        async def main():
            trace = []
            cont = _sched(impl, batching="continuous")
            cont.ensure_running = lambda: None
            a = await cont.submit(list(range(4)), 8)
            cont._admit()
            cont._decode_step()
            b = await cont.submit(list(range(4)), 8)
            cont._admit()
            assert a in cont.running and b in cont.running
            cont._decode_step()
            trace += [(a.generated, b.generated), list(a.tokens),
                      list(b.tokens)]
            cont.stop()

            drain = _sched(impl, batching="drain")
            drain.ensure_running = lambda: None
            a = await drain.submit(list(range(4)), 8)
            drain._admit()
            drain._decode_step()
            b = await drain.submit(list(range(4)), 8)
            drain._admit()
            assert b not in drain.running
            while a in drain.running:
                drain._decode_step()
            trace.append(b.generated)
            drain._admit()
            assert b in drain.running
            drain.stop()
            return trace + [list(a.tokens)]
        return asyncio.run(main())

    trace = _both(scenario)
    assert trace[0] == (2, 1) and trace[3] == 0


def test_scheduler_sheds_on_queue_and_impossible_kv():
    def scenario(impl):
        async def main():
            s = _sched(impl, max_queued=1, max_pages=4, page_tokens=4)
            with pytest.raises(impl["overloaded"]):
                await s.submit(list(range(4)), 16)
            await s.submit(list(range(4)), 4)
            with pytest.raises(impl["overloaded"]) as ei:
                await s.submit(list(range(4)), 4)
            trace = [str(ei.value), s.shed_total, s.queue_depth()]
            s.stop()
            return trace
        return asyncio.run(main())

    trace = _both(scenario)
    assert "SERVE_OVERLOADED" in trace[0] and trace[1:] == [2, 1]
    assert is_overloaded_error(TOverloaded("x"))
    assert is_overloaded_error(RuntimeError("SERVE_OVERLOADED: remote"))


def test_scheduler_kv_budget_holds_admission_until_frees():
    def scenario(impl):
        async def main():
            s = _sched(impl, max_pages=4, page_tokens=4, max_running=4)
            a = await s.submit(list(range(8)), 4)
            b = await s.submit(list(range(8)), 4)
            out_a = [t async for t in s.stream(a)]
            out_b = [t async for t in s.stream(b)]
            assert s.steps >= 8, "b cannot have run concurrently with a"
            s.stop()
            return [out_a, out_b]
        return asyncio.run(main())

    out_a, out_b = _both(scenario)
    assert len(out_a) == len(out_b) == 4


def test_concurrent_mixed_submissions_stream_identically():
    """Many prompts arriving one per step boundary, shared prefixes, a
    batch cap below the offered load: every stream of the port equals the
    reference's. Steps are driven by hand so arrival order is exact."""
    prompts = [list(range(i, i + 3 + 2 * i)) for i in range(6)]
    prompts += [list(range(10)), list(range(10)) + [7, 7]]

    def scenario(impl):
        async def main():
            s = _sched(impl, prefix_cache_pages=8, max_running=3)
            s.ensure_running = lambda: None
            seqs = []
            for i, p in enumerate(prompts):
                seqs.append(await s.submit(p, 3 + i % 4))
                s._admit()
                s._decode_step()
            while s.running or s.queued:
                s._admit()
                s._decode_step()
            # the longest prompt again, once its pages are in the cache
            seqs.append(await s.submit(prompts[-1], 3))
            while s.running or s.queued:
                s._admit()
                s._decode_step()
            outs = [[t async for t in s.stream(q)] for q in seqs]
            trace = [outs, [q.cached_tokens for q in seqs],
                     s.tokens_prefill, s.tokens_decode, s.steps]
            s.stop()
            return trace
        return asyncio.run(main())

    trace = _both(scenario)
    assert [len(o) for o in trace[0]] == [3 + i % 4 for i in range(8)] + [3]
    assert trace[1][-1] == 12  # three full pages came from the cache


def test_llm_server_synthetic_streams_like_reference_scheduler():
    """The port's ingress with its default (synthetic) model streams the
    reference scheduler's tokens for the same request."""
    async def port():
        srv = teng.LLMServer(page_tokens=4, max_pages=64,
                             prefix_cache_pages=16)
        out = [json.loads(line)["token"] async for line in
               srv({"tokens": list(range(10)), "max_tokens": 6})]
        again = [json.loads(line)["token"] async for line in
                 srv(json.dumps({"tokens": list(range(10)),
                                 "max_tokens": 6}))]
        body = json.dumps({"tokens": list(range(10)), "max_tokens": 6})
        third = [json.loads(line)["token"] async for line in
                 srv(Request(body=body.encode()))]
        assert third == out
        report = srv.__serve_llm_report__()
        assert report["prefix_digest"] == tprefix.digest(
            srv.scheduler.cache.chains(), 256) != []
        assert report["queued_seqs"] == srv.__serve_queue_depth__() == 0
        info = srv.debug_info()
        srv.close()
        return out, again, info

    async def ref():
        s = jeng.SequenceScheduler(
            jmodel.SyntheticLLM(kv_dim=64),
            jkv.KVPool(page_tokens=4, kv_dim=64, max_pages=64,
                       use_arena=False), prefix_cache_pages=16)
        out = (await _run_one(s, list(range(10)), 6))[1]
        s.stop()
        return out

    out, again, info = asyncio.run(port())
    assert out == again == asyncio.run(ref())
    assert info["hit_rate"] > 0 and info["arena_backed"] is False
    assert info["tokens_decode"] == 18


# ---------------------------------------------------------------------------
# GPT-2 adapter on bridged weights
# ---------------------------------------------------------------------------

# one prompt length: the JAX adapter compiles its attention once per length
PROMPTS = [list(range(10)), [5, 17, 300, 2, 2, 9, 41, 8, 8, 1],
           list(range(100, 110))]
N_DECODE = 6


def _greedy(llm, prompt, n=N_DECODE):
    toks, out = list(prompt), []
    for _ in range(n):
        t = llm.forward_next(toks)
        toks.append(t)
        out.append(t)
    return out


def _jax_greedy(jllm, apply, prompt, n=N_DECODE):
    """``jllm.forward_next`` in a loop, with its ``apply`` jitted: the same
    function, compiled once per length instead of dispatched op by op."""
    toks, out = list(prompt), []
    for _ in range(n):
        logits = apply({"params": jllm._params},
                       jnp.asarray([toks], dtype=jnp.int32))
        t = int(jnp.argmax(logits[0, -1]))
        toks.append(t)
        out.append(t)
    return out


@pytest.fixture(scope="module")
def bridged():
    """(JAX GPT2LLM, its params as numpy, its greedy tokens per prompt)."""
    jllm = jmodel.GPT2LLM(attention="flash", dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jllm._params)
    apply = jax.jit(jllm._model.apply)
    ref = [_jax_greedy(jllm, apply, p) for p in PROMPTS]
    assert jllm.forward_next(PROMPTS[0]) == ref[0][0]  # the adapter itself
    return jllm, tree, ref


def _port_llm(tree, **kw):
    llm = tmodel.GPT2LLM(device="cpu", attention="flash", dtype=torch.float32,
                         **kw)
    llm.load_params(tree)
    return llm


def test_gpt2_llm_greedy_matches_reference(bridged):
    _, tree, ref = bridged
    llm = _port_llm(tree)
    assert [_greedy(llm, p) for p in PROMPTS] == ref
    assert llm.forwards == len(PROMPTS) * N_DECODE
    assert len(set(sum(ref, []))) > 1, "degenerate greedy stream"


def test_llm_server_real_model_streams_greedy_tokens(bridged):
    _, tree, ref = bridged

    async def main():
        srv = teng.LLMServer(real_model=True, device="cpu", kv_dim=64,
                             page_tokens=4, max_pages=64,
                             prefix_cache_pages=16,
                             model_kwargs=dict(attention="flash",
                                               dtype=torch.float32))
        srv.model.load_params(tree)

        async def one(p):
            return [json.loads(line)["token"] async for line in
                    srv({"tokens": p, "max_tokens": N_DECODE})]

        outs = await asyncio.gather(*(one(p) for p in PROMPTS))
        srv.close()
        return outs

    assert asyncio.run(main()) == ref


def test_reference_engine_never_runs_gpt2_port_does(bridged):
    """Reference fault: engine.py:226 calls next_token without tokens=, so
    the JAX GPT2LLM returns 0 every step. The port passes the tokens."""
    jllm, tree, ref = bridged

    async def run(sched):
        out = (await _run_one(sched, PROMPTS[0], N_DECODE))[1]
        sched.stop()
        return out

    jsched = jeng.SequenceScheduler(
        jllm, jkv.KVPool(page_tokens=4, kv_dim=64, max_pages=64,
                         use_arena=False))
    tsched = teng.SequenceScheduler(
        _port_llm(tree), tkv.KVPool(page_tokens=4, kv_dim=64, max_pages=64))
    assert asyncio.run(run(jsched)) == [0] * N_DECODE
    assert asyncio.run(run(tsched)) == ref[0] != [0] * N_DECODE
    with pytest.raises(ValueError, match="tokens"):
        tsched.model.next_token([], 3)


def test_kv_dim_mismatch_raises_in_port_breaks_reference(bridged):
    """Reference fault: the pool's kv_dim is not the model's (the JAX
    LLMServer sizes the pool from its kv_dim flag, GPT2LLM from n_embd).
    The JAX scheduler fails on the first KV write; the port's server
    refuses the pair up front."""
    jllm = bridged[0]
    assert jllm.kv_dim == 64

    async def ref():
        s = jeng.SequenceScheduler(
            jllm, jkv.KVPool(page_tokens=4, kv_dim=32, max_pages=64,
                             use_arena=False))
        s.ensure_running = lambda: None
        await s.submit(list(range(5)), 2)
        with pytest.raises(ValueError):
            s._admit()

    asyncio.run(ref())
    with pytest.raises(ValueError, match="kv_dim"):
        teng.LLMServer(real_model=True, device="cpu", kv_dim=64,
                       model_kwargs=dict(n_embd=128, n_layer=1))


def test_load_model_raises_instead_of_serving_synthetic(monkeypatch):
    """Reference fault: load_model swallows a failed GPT2LLM and serves
    SyntheticLLM. The port's load_model raises."""
    def broken(**kw):
        raise RuntimeError("no device")

    monkeypatch.setitem(GLOBAL_CONFIG._values, "serve_llm_real_model", True)
    monkeypatch.setattr(jmodel, "GPT2LLM", broken)
    assert isinstance(jmodel.load_model(kv_dim=64), jmodel.SyntheticLLM)

    with pytest.raises(ValueError, match="attention"):
        tmodel.load_model(kv_dim=64, real_model=True, device="cpu",
                          model_kwargs={"attention": "bogus"})
    with pytest.raises(TypeError):
        tmodel.load_model(real_model=True, device="cpu",
                          model_kwargs={"n_embed": 64})
    assert isinstance(tmodel.load_model(kv_dim=8), tmodel.SyntheticLLM)


# ---------------------------------------------------------------------------
# entry points and the import rule
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models import gpt2 as tgpt2

    cfg = tgpt2.GPT2Config.small_test()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt2.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt2.synthetic_batch(0, 2, 8, cfg.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt2.make_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.LLMServer(real_model=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.GPT2LLM()
    teng.LLMServer().close()  # the synthetic model needs no device


def _imported_roots(tree):
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _reference_module_strings(tree):
    """String constants that name a module of the JAX package: ``ray_tpu``
    itself or ``ray_tpu.<...>``, as in ``-m`` argv lists,
    ``sys.modules.get(...)`` or ``importlib.import_module(...)``. The pieces
    of an f-string are constants too, so ``f"ray_tpu.{name}"`` is caught."""
    return sorted(node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and (node.value == "ray_tpu"
                       or node.value.startswith("ray_tpu.")))


def test_port_imports_no_jax_and_nothing_of_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        bad = _imported_roots(tree) & banned
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
        named = _reference_module_strings(tree)
        assert not named, f"{f.relative_to(REPO)} names {named}"


def test_string_guard_bites_on_a_module_named_in_a_string():
    snippet = (
        "import sys, importlib\n"
        "argv = [sys.executable, '-m', 'ray_tpu._private.worker_main']\n"
        "sess = sys.modules.get('ray_tpu.train.session')\n"
        "mod = importlib.import_module(f'ray_tpu.{sys.argv[1]}')\n"
        "pkg = 'ray_tpu'\n"
        "ok = ['ray_tpu_torch._private.worker_main', 'ray_tpu/ops/x.py:1',\n"
        "      'ray_tpu_spill', 'the ray_tpu package']\n")
    tree = ast.parse(snippet)
    assert not _imported_roots(tree) & {"ray_tpu"}
    assert _reference_module_strings(tree) == [
        "ray_tpu", "ray_tpu.", "ray_tpu._private.worker_main",
        "ray_tpu.train.session"]
