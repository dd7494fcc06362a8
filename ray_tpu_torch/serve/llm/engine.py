"""Continuous-batching engine: iteration-level scheduling over paged KV.

Port of ``ray_tpu/serve/llm/engine.py``. The unit of scheduling is one
decode STEP, not one request. The ``SequenceScheduler`` keeps a running
batch; at every step boundary it (a) admits queued sequences while KV
budget and batch slots allow, (b) prefills admissions (reusing prefix-cache
pages for every full block already held), (c) runs one decode step for the
whole batch, (d) streams each new token to its sequence's consumer, and
(e) retires finished sequences — full pages into the prefix cache, partial
pages back to the pool.

``batching="drain"`` is the A/B baseline: admit only into an EMPTY batch and
run it to completion. Admission control sheds load with ``OverloadedError``
before the replica wedges: a bounded wait queue plus KV-budget-aware
admission.

Differences from the reference, each pinned by a test in
``tests/test_torch_serve_llm.py``: the decode step passes the sequence's
tokens to ``next_token`` (the reference omits them, so its GPT-2 adapter
never runs the model), ``LLMServer`` refuses a model whose ``kv_dim``
differs from the pool's, and a real model that cannot be built raises.
The runtime hooks are the reference's: the metrics counters, the replica
context's deployment tags, the request id from the request tracer, and
arena-backed KV pages inside a cluster.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import math
import os
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve._common import OverloadedError, Request
from ray_tpu_torch.serve.llm import prefix as prefix_mod
from ray_tpu_torch.serve.llm.kv_cache import KVPage, KVPool, PrefixCache
from ray_tpu_torch.serve.llm.model import load_model

logger = logging.getLogger(__name__)

_EOS = object()


class Sequence:
    """One in-flight generation: prompt, block table, output queue."""

    def __init__(self, sid: int, tokens: List[int], max_tokens: int,
                 rid: str = ""):
        self.sid = sid
        self.tokens = list(tokens)      # prompt + generated, in order
        self.prompt_len = len(tokens)
        self.max_tokens = int(max_tokens)
        self.rid = rid
        self.pages: List[KVPage] = []   # block table
        self.generated = 0
        self.cached_tokens = 0          # prompt tokens served from cache
        self.out: asyncio.Queue = asyncio.Queue()

    def kv_views(self):
        """Read views over the used region of every page, block order."""
        return [p.data[:p.used] for p in self.pages]


class SequenceScheduler:
    def __init__(self, model, pool: KVPool, *,
                 max_running: int = 8, max_queued: int = 32,
                 batching: str = "continuous",
                 prefix_cache_pages: int = 0):
        if batching not in ("continuous", "drain"):
            raise ValueError(f"unknown batching mode: {batching!r}")
        self.model = model
        self.pool = pool
        self.max_running = int(max_running)
        self.max_queued = int(max_queued)
        self.batching = batching
        self.cache = PrefixCache(pool, prefix_cache_pages) \
            if prefix_cache_pages > 0 else None
        self.running: List[Sequence] = []
        self.queued: List[Sequence] = []
        self._sids = itertools.count()
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.tokens_prefill = 0
        self.tokens_decode = 0
        self.shed_total = 0
        self.steps = 0

    # -- admission -------------------------------------------------------
    def _pages_needed(self, seq: Sequence) -> int:
        total = seq.prompt_len + seq.max_tokens
        return math.ceil(total / self.pool.page_tokens)

    async def submit(self, tokens: List[int], max_tokens: int,
                     rid: str = "") -> Sequence:
        """Enqueue one sequence, or shed. Sheds when the wait queue is
        full, or when the request could NEVER run (worst-case pages
        exceed the whole pool)."""
        if self._stopped:
            raise OverloadedError("engine stopped")
        seq = Sequence(next(self._sids), tokens, max_tokens, rid=rid)
        if self._pages_needed(seq) > self.pool.max_pages:
            self.shed_total += 1
            raise OverloadedError(
                f"sequence needs {self._pages_needed(seq)} KV pages, "
                f"pool holds {self.pool.max_pages}")
        if len(self.queued) >= self.max_queued:
            self.shed_total += 1
            raise OverloadedError(
                f"{len(self.queued)} sequences queued (cap "
                f"{self.max_queued})")
        self.queued.append(seq)
        self.ensure_running()
        self._wake.set()
        return seq

    def queue_depth(self) -> int:
        """Queued SEQUENCES (not HTTP requests)."""
        return len(self.queued)

    def load(self) -> int:
        return len(self.queued) + len(self.running)

    # -- the step loop ---------------------------------------------------
    def ensure_running(self):
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self):
        try:
            while not self._stopped:
                if not self.running and not self.queued:
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self._admit()
                if not self.running:
                    # queued but nothing admittable: yield so frees can
                    # land, then retry
                    await asyncio.sleep(0.005)
                    continue
                self._decode_step()
                await asyncio.sleep(0)  # stream flushes between steps
        except Exception:
            logger.exception("llm scheduler loop died")
            for seq in self.running + self.queued:
                seq.out.put_nowait(_EOS)

    def _admit(self):
        """Step-boundary admission. Continuous: top the batch up every
        step. Drain: only refill an EMPTY batch (the A/B baseline)."""
        if self.batching == "drain" and self.running:
            return
        while self.queued and len(self.running) < self.max_running:
            seq = self.queued[0]
            if not self._try_prefill(seq):
                break  # KV budget: head-of-line waits for frees
            self.queued.pop(0)
            self.running.append(seq)

    def _try_prefill(self, seq: Sequence) -> bool:
        """Prefix-cache reuse + page-at-a-time prefill. Budget-checked
        up front so a half-prefilled sequence never strands pages."""
        chains = prefix_mod.chain_hashes(
            seq.tokens[:seq.prompt_len], self.pool.page_tokens)
        reused: List[KVPage] = self.cache.match(chains) if self.cache else []
        reused_tokens = len(reused) * self.pool.page_tokens
        fresh_pages = math.ceil(
            (seq.prompt_len + seq.max_tokens - reused_tokens)
            / self.pool.page_tokens)
        if fresh_pages > self.pool.available():
            for p in reused:
                self.pool.decref(p)
            return False
        seq.pages = reused
        seq.cached_tokens = reused_tokens
        if self.cache:
            self.cache.note_lookup(seq.prompt_len, reused_tokens)
        for pos in range(reused_tokens, seq.prompt_len):
            self._append_kv(seq, seq.tokens[pos], pos)
            self.tokens_prefill += 1
        return True

    def _append_kv(self, seq: Sequence, token: int, pos: int):
        """Copy-on-extend append: the tail page is extended in place only
        when this sequence owns it exclusively; a shared (prefix-cached)
        partial tail is copied first."""
        page = seq.pages[-1] if seq.pages else None
        if page is None or page.full:
            page = self._alloc_page_or_die(seq)
            seq.pages.append(page)
        elif page.refs > 1 or page.cached:
            fresh = self._alloc_page_or_die(seq)
            fresh.data[:page.used] = page.data[:page.used]
            fresh.used = page.used
            self.pool.decref(page)
            seq.pages[-1] = page = fresh
        page.data[page.used] = self.model.kv_vec(token, pos)
        page.used += 1

    def _alloc_page_or_die(self, seq: Sequence) -> KVPage:
        page = self.pool.alloc()
        if page is None:
            # admission reserved worst-case pages, so this is a real
            # invariant break, not load
            raise RuntimeError("KV pool exhausted mid-sequence")
        return page

    def _decode_step(self):
        """One iteration for the whole batch: model step cost once,
        then one token per running sequence."""
        self.steps += 1
        self.model.step_cost(len(self.running))
        finished: List[Sequence] = []
        for seq in self.running:
            tok = self.model.next_token(seq.kv_views(), len(seq.tokens),
                                        tokens=seq.tokens)
            pos = len(seq.tokens)
            seq.tokens.append(tok)
            self._append_kv(seq, tok, pos)
            seq.generated += 1
            self.tokens_decode += 1
            seq.out.put_nowait(tok)
            if seq.generated >= seq.max_tokens:
                finished.append(seq)
        for seq in finished:
            self.running.remove(seq)
            self._finish(seq)

    def _finish(self, seq: Sequence):
        """Retire: full pages become prefix-cache entries (named by the
        chain over the tokens they hold), partial pages free."""
        if self.cache is not None:
            chains = prefix_mod.chain_hashes(
                seq.tokens, self.pool.page_tokens)
            for i, page in enumerate(seq.pages):
                if page.full and i < len(chains) and not page.cached:
                    self.cache.insert(chains[i], page)
        for page in seq.pages:
            self.pool.decref(page)
        seq.pages = []
        seq.out.put_nowait(_EOS)

    def cancel(self, seq: Sequence):
        """Consumer went away mid-generation: drop the sequence and free
        its pages now, not at max_tokens."""
        if seq in self.queued:
            self.queued.remove(seq)
        elif seq in self.running:
            self.running.remove(seq)
        else:
            return
        for page in seq.pages:
            self.pool.decref(page)
        seq.pages = []
        seq.out.put_nowait(_EOS)

    async def stream(self, seq: Sequence):
        while True:
            tok = await seq.out.get()
            if tok is _EOS:
                return
            yield tok

    def stop(self):
        self._stopped = True
        self._wake.set()
        for seq in self.running + self.queued:
            for page in seq.pages:
                self.pool.decref(page)
            seq.pages = []
            seq.out.put_nowait(_EOS)
        self.running = []
        self.queued = []
        if self.cache is not None:
            self.cache.clear()


class LLMServer:
    """The deployable ingress: POST {"tokens": [...], "max_tokens": n}
    (or {"prompt": "...", ...} with a whitespace tokenizer) streams one
    JSON line per token. An async-generator handler, so the replica's
    existing stream protocol carries the tokens and the proxy's
    first_byte/last_byte reqtrace marks time TTFT per request.

    Deploy with ``serve.deployment(LLMServer).bind(...)``; tune via init
    kwargs (defaults come from the serve_llm_* flags). ``real_model=True``
    serves ``GPT2LLM`` built from ``model_kwargs`` on ``device`` (None: the
    CUDA card, raising when there is none); ``kv_dim`` must then equal the
    model's ``n_embd``.
    """

    def __init__(self, kv_dim: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 max_pages: Optional[int] = None,
                 max_running: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 batching: str = "continuous",
                 prefix_cache_pages: Optional[int] = None,
                 step_delay_s: float = 0.0,
                 use_arena: bool = True,
                 prefix_digest_max: Optional[int] = None,
                 real_model: bool = False,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 device=None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

        if not cfg.serve_llm_enabled:
            raise RuntimeError(
                "LLM serving is disabled (serve_llm_enabled=0)")
        kv_dim = int(kv_dim or cfg.serve_llm_kv_dim)
        self.pool = KVPool(
            page_tokens=int(page_tokens or cfg.serve_llm_page_tokens),
            kv_dim=kv_dim,
            max_pages=int(max_pages or cfg.serve_llm_kv_pages),
            use_arena=use_arena,
        )
        self.model = load_model(kv_dim=kv_dim, step_delay_s=step_delay_s,
                                real_model=real_model, device=device,
                                model_kwargs=model_kwargs)
        if self.model.kv_dim != self.pool.kv_dim:
            self.pool.close()
            raise ValueError(
                f"model kv_dim {self.model.kv_dim} != KV pool kv_dim "
                f"{self.pool.kv_dim}: pass kv_dim={self.model.kv_dim}")
        if prefix_cache_pages is None:
            prefix_cache_pages = cfg.serve_llm_prefix_cache_pages
        self.scheduler = SequenceScheduler(
            self.model, self.pool,
            max_running=int(max_running or cfg.serve_llm_max_running),
            max_queued=int(max_queued or cfg.serve_llm_max_queued),
            batching=batching,
            prefix_cache_pages=int(prefix_cache_pages),
        )
        self._digest_cap = int(prefix_digest_max
                               or cfg.serve_llm_prefix_digest_max)
        self._setup_metrics()

    # -- serve integration hooks ----------------------------------------
    def __serve_queue_depth__(self) -> int:
        """Replica queue-depth gauge override: queued SEQUENCES, not
        HTTP requests (a streaming LLM replica has ~0 pool backlog while
        holding a deep sequence queue — autoscaling must see the
        latter)."""
        return self.scheduler.queue_depth()

    def __serve_llm_report__(self) -> dict:
        """Rides the controller's load-report probe (replica
        get_metrics): sequence load for routing/autoscaling plus the
        prefix digest the affinity router matches against."""
        out = {
            "queued_seqs": self.scheduler.queue_depth(),
            "running_seqs": len(self.scheduler.running),
            "block_tokens": self.pool.page_tokens,
        }
        if self.scheduler.cache is not None:
            out["prefix_digest"] = prefix_mod.digest(
                self.scheduler.cache.chains(), self._digest_cap)
        return out

    def _setup_metrics(self):
        try:
            from ray_tpu_torch._private import metrics_core as mc
            from ray_tpu_torch.serve._common import get_replica_context

            reg = mc.registry()
            # deployment tags: same-tag series SUM in the cluster merge,
            # so replicas of one deployment fold into per-deployment
            # totals while distinct deployments stay separate
            ctx = get_replica_context()
            dep = {"deployment": ctx["deployment"]} if ctx else {}
            c = reg.counter(
                "serve_llm_tokens_total",
                "Tokens processed by the LLM engine, by phase")
            c.labels(phase="prefill", **dep).set_fn(
                lambda: self.scheduler.tokens_prefill)
            c.labels(phase="decode", **dep).set_fn(
                lambda: self.scheduler.tokens_decode)
            g = reg.gauge("kv_cache_pages",
                          "KV cache pages by state (arena page budget)")
            for state in ("active", "cached", "free"):
                g.labels(state=state, **dep).set_fn(
                    lambda s=state: self.pool.counts()[s])
            # ratios can't be summed: tag by replica so the merge keeps
            # one series per replica process instead of folding them
            replica = ctx["replica"] if ctx and ctx.get("replica") \
                else f"pid{os.getpid()}"
            reg.gauge("kv_cache_hit_rate",
                      "Prefix-cache hit rate (prompt tokens reused / "
                      "prompt tokens looked up), per replica"
                      ).labels(replica=replica, **dep).set_fn(
                lambda: (self.scheduler.cache.hit_rate()
                         if self.scheduler.cache else 0.0))
            reg.counter("serve_llm_shed_total",
                        "Sequences shed by admission control (503s)"
                        ).labels(**dep).set_fn(
                lambda: self.scheduler.shed_total)
            reg.gauge("serve_llm_batch_size",
                      "Sequences in the running batch (iteration-level "
                      "batch occupancy)").labels(**dep).set_fn(
                lambda: len(self.scheduler.running))
        except Exception:
            logger.debug("llm metrics unavailable", exc_info=True)

    # -- introspection (handle-callable debug surface: tests, bench)
    def debug_info(self) -> Dict:
        from ray_tpu_torch._private import metrics_core as mc

        return {
            "pid": os.getpid(),
            "arena_backed": self.pool.arena_backed,
            "counts": self.pool.counts(),
            "page_tokens": self.pool.page_tokens,
            "max_pages": self.pool.max_pages,
            "batching": self.scheduler.batching,
            "queued_seqs": self.scheduler.queue_depth(),
            "running_seqs": len(self.scheduler.running),
            "hit_rate": (self.scheduler.cache.hit_rate()
                         if self.scheduler.cache else 0.0),
            "tokens_prefill": self.scheduler.tokens_prefill,
            "tokens_decode": self.scheduler.tokens_decode,
            "shed_total": self.scheduler.shed_total,
            "steps": self.scheduler.steps,
            "metric_names": sorted(
                n for n in mc.registry().snapshot()
                if n.startswith(("kv_cache", "serve_llm"))),
        }

    def debug_zero_copy(self) -> Dict:
        """Allocate one page, write through the engine's view, read it
        back through an independent view of the store mapping — the
        np.shares_memory proof that pages are arena-backed, zero-copy."""
        import numpy as np

        page = self.pool.alloc()
        if page is None:
            return {"oid_prefix_ok": False, "shares_memory": False,
                    "roundtrip_ok": False, "error": "pool exhausted"}
        try:
            page.data[0, 0] = 42.5
            rb = self.pool.readback(page)
            from ray_tpu_torch.serve.llm.kv_cache import KV_PAGE_OID_PREFIX

            return {
                "oid_prefix_ok": (page.oid or b"").startswith(
                    KV_PAGE_OID_PREFIX),
                "shares_memory": bool(np.shares_memory(page.data, rb)),
                "roundtrip_ok": float(rb[0, 0]) == 42.5,
            }
        finally:
            self.pool.decref(page)

    # -- request path ----------------------------------------------------
    @staticmethod
    def parse_request(request) -> Dict:
        if isinstance(request, Request):
            body = request.json() if request.body else {}
        elif isinstance(request, dict):
            body = request
        else:
            body = json.loads(request)
        if not isinstance(body, dict):
            raise ValueError("expected a JSON object body")
        tokens = body.get("tokens")
        if tokens is None:
            tokens = prefix_mod.tokenize(body.get("prompt", ""))
        return {"tokens": [int(t) for t in tokens],
                "max_tokens": int(body.get("max_tokens", 16))}

    async def __call__(self, request):
        from ray_tpu_torch._private import reqtrace

        req = self.parse_request(request)
        ctx = reqtrace.CURRENT.get(None)
        rid = ctx[0] if ctx else ""
        self.scheduler.ensure_running()
        seq = await self.scheduler.submit(
            req["tokens"], req["max_tokens"], rid=rid)
        try:
            async for tok in self.scheduler.stream(seq):
                yield (json.dumps({"token": tok}) + "\n").encode()
        finally:
            self.scheduler.cancel(seq)

    def close(self):
        """Stop the scheduler, release every page and retire the pool's
        arena lease."""
        self.scheduler.stop()
        self.pool.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
