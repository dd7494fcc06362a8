#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc versions.
   TF32 is switched off for the checks.
2. build: nvcc builds every kernel of the serving path from the sources in
   the checkout (``ray_tpu_torch/ops/csrc/``), all at once.
3. kernel vs plain: the ``flash_fwd`` sm_90a kernel against its plain
   PyTorch version (f32 math on the same rounded inputs) over dtypes
   {f32, bf16, f16} x head dims {16, 32, 64, 128} x B*H {12, 24} x causal
   x lengths, plus cross lengths and rows with no live column.
   Tolerance: out atol = rtol = 1e-4 in f32 (sums in another order) and
   2e-2 in bf16/f16 (the output rounds to 8 or 11 mantissa bits); lse
   atol 1e-3 and +inf on exactly the same rows.
4. serve in f32: GPT-2-124M at full width with random weights decodes 3
   prompts x 16 tokens through the kernel and through its plain version
   on the same weights; the tokens must be equal. ``entry()`` runs its
   (2, 256) forward.
5. serve at bf16 (the main path): ``LLMServer`` answers 4 concurrent
   requests (prompts of 32, 129, 300, 512 tokens) and then the 32-token
   prompt again, 16 tokens each. Launch counts are zeroed just before and
   read just after; every kernel of the path must have launched. Checks:
   16 tokens per stream, the repeat streams the same tokens and hits the
   prefix cache, flash_fwd launches >= 12 x forwards, last-position logits
   within atol 5e-2 of the plain version's. Prints TTFT and tokens/s.
6. kernels: per kernel its launches on the main path, error, time (CUDA
   events) at the serving shape (B*H 12, S 512, D 64, causal, bf16), the
   plain version's time, torch's SDPA time as a yardstick (the port never
   calls it) and the least time the card could take.

The last two lines are the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

GPT2_124M = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True
                          ).stdout.strip()


def phase_device():
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = _run([f"{CUDA_HOME}/bin/nvcc", "--version"]).splitlines()[-1]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc)
    return smi


def _ptxas_summary(log_path):
    """{kernel instantiation: "N registers, M bytes spilled"} from the
    ``-Xptxas -v`` log nvcc left beside the library (empty when the
    library was already built)."""
    if not log_path.exists():
        return {}
    out, name = {}, None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"kernelI(\w+?)Li(\d+)E", name)
            if t:
                name = f"{t.group(1).lstrip('0123456789_')}/{t.group(2)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = f"{m.group(1)} bytes spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    sources = [attn._SOURCE]  # every kernel source of the serving path
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    wall = time.perf_counter() - t0
    attn._load_kernel()
    ptxas = {src.name: _ptxas_summary(path.with_suffix(".log"))
             for (path, _), src in zip(built, sources)}
    emit("build", wall_s=wall,
         seconds={src.name: s for (_, s), src in zip(built, sources)},
         ptxas=ptxas)


def _close(got, want, atol, rtol):
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _check_flash(q, k, v, causal, tol):
    """Kernel vs plain on one input; returns (ok, out_err, lse_err)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = attn._flash_plain(q.float(), k.float(), v.float(),
                                     causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5)
    ok_out, out_err = _close(out.float(), ref, tol, tol)
    same_inf = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)))
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() \
        else 0.0
    return ok_out and same_inf and lse_err <= 1e-3, out_err, lse_err


def phase_kernel_vs_plain():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
    cases = []
    for s in (1, 64, 129, 512, 1024):
        for causal in (False, True):
            cases.append((s, s, causal))
    for causal in (False, True):
        cases += [(16, 64, causal), (1, 300, causal)]
    cases.append((64, 16, True))
    worst = {}
    failures = []
    n = 0
    for dtype, tol in tols.items():
        for d in (16, 32, 64, 128):
            for bh in (12, 24):
                for sq, sk, causal in cases:
                    mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                               device=dev).to(dtype)
                    q, k, v = mk(sq), mk(sk), mk(sk)
                    ok, out_err, lse_err = _check_flash(q, k, v, causal, tol)
                    n += 1
                    key = str(dtype).split(".")[-1]
                    w = worst.setdefault(key, [0.0, 0.0])
                    w[0], w[1] = max(w[0], out_err), max(w[1], lse_err)
                    if not ok:
                        failures.append(dict(dtype=key, d=d, bh=bh, sq=sq,
                                             sk=sk, causal=causal,
                                             out_err=out_err,
                                             lse_err=lse_err))
    torch.cuda.synchronize()
    emit("kernel_vs_plain", kernel="flash_fwd", cases=n,
         max_err={k: {"out": v[0], "lse": v[1]} for k, v in worst.items()},
         failures=failures[:10])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"in {len(failures)} of {n} cases")


@contextlib.contextmanager
def _plain_attention():
    """Route the model's flash-attention calls to the kernel's plain
    version (f32 math on the same inputs, same output dtype), so one model
    with one set of weights runs either path."""
    import ray_tpu_torch.ops as ops

    kernel_path = ops.flash_attention
    ops.flash_attention = functools.partial(kernel_path, impl="plain")
    try:
        yield
    finally:
        ops.flash_attention = kernel_path


def phase_serve_f32():
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.serve.llm.model import GPT2LLM

    llm = GPT2LLM(seed=0, attention="flash", dtype=torch.float32,
                  **GPT2_124M)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50257, size=n).tolist() for n in (16, 64, 129)]

    def greedy(prompt):
        toks = list(prompt)
        for _ in range(16):
            toks.append(llm.forward_next(toks))
        return toks[len(prompt):]

    kernel_toks = [greedy(p) for p in prompts]
    with _plain_attention():
        plain_toks = [greedy(p) for p in prompts]
    equal = kernel_toks == plain_toks
    del llm

    forward, (model, batch) = entry()
    logits = forward(model, batch)
    torch.cuda.synchronize()
    entry_ok = (tuple(logits.shape) == (2, 256, 50257)
                and bool(torch.isfinite(logits.float()).all()))
    del model, logits
    torch.cuda.empty_cache()
    emit("serve_f32", tokens_equal=equal, kernel_tokens=kernel_toks,
         plain_tokens=plain_toks, entry_forward_ok=entry_ok)
    if not equal:
        raise AssertionError("f32 greedy tokens differ between the flash "
                             "kernel and its plain version")
    if not entry_ok:
        raise AssertionError("entry() forward gave a wrong shape or "
                             "non-finite logits")


async def _serve_requests(server, prompts, repeat):
    """Concurrent requests, then ``repeat``; per-request tokens and
    timestamps (submit, first token, last token)."""

    async def one(p):
        t0 = time.perf_counter()
        toks, stamps = [], []
        async for line in server({"tokens": p, "max_tokens": 16}):
            toks.append(json.loads(line)["token"])
            stamps.append(time.perf_counter())
        return toks, t0, stamps

    first = await asyncio.gather(*(one(p) for p in prompts))
    second = await one(repeat)
    return list(first) + [second]


def phase_serve_bf16():
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.serve.llm.engine import LLMServer

    server = LLMServer(real_model=True, kv_dim=768, page_tokens=16,
                       max_pages=512, max_running=8, prefix_cache_pages=128,
                       model_kwargs=dict(attention="flash",
                                         dtype=torch.bfloat16, **GPT2_124M))
    llm = server.model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 50257, size=n).tolist()
               for n in (32, 129, 300, 512)]

    attn.flash_fwd_launches = 0
    llm.forwards = 0
    t0 = time.perf_counter()
    results = asyncio.run(_serve_requests(server, prompts, prompts[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": attn.flash_fwd_launches}
    forwards = llm.forwards
    info = server.debug_info()

    streams = [r[0] for r in results]
    ttft = [r[2][0] - r[1] for r in results]
    decode_rate = [(len(r[2]) - 1) / (r[2][-1] - r[2][0]) for r in results]
    total_tokens = sum(len(s) for s in streams)

    seq = prompts[0] + streams[0][:-1]  # the input of the last forward
    kernel_logits = llm.logits(seq)[-1].float()
    with _plain_attention():
        plain_logits = llm.logits(seq)[-1].float()
    logit_err = float((kernel_logits - plain_logits).abs().max())
    # one full forward of the 512-token prompt, host clock to sync: the
    # unit of work a decode step repeats per running sequence
    forward_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        llm.logits(prompts[3])
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t1) * 1e3)
    server.close()

    emit("serve_bf16", prompt_lens=[len(p) for p in prompts] + [32],
         tokens=streams, ttft_s=ttft, decode_tokens_per_s=decode_rate,
         total_tokens=total_tokens, wall_s=wall,
         tokens_per_s=total_tokens / wall, forwards=forwards,
         launches=launches, hit_rate=info["hit_rate"],
         forward_512_ms=sorted(forward_ms[1:])[2],
         last_logits_max_abs_err=logit_err)
    problems = []
    if any(len(s) != 16 for s in streams):
        problems.append("a stream did not give 16 tokens")
    if streams[-1] != streams[0]:
        problems.append("the repeated prompt streamed other tokens")
    if not info["hit_rate"] > 0:
        problems.append("the repeated prompt missed the prefix cache")
    if forwards != 16 * len(streams):
        problems.append(f"{forwards} forwards for {len(streams)} x 16 tokens")
    if launches["flash_fwd"] < 12 * forwards or launches["flash_fwd"] == 0:
        problems.append(f"flash_fwd launched {launches['flash_fwd']} times "
                        f"for {forwards} forwards")
    if not logit_err <= 5e-2:
        problems.append(f"last-position logits differ by {logit_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _time_ms(fn, iters):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(launches):
    from ray_tpu_torch.ops import attention as attn

    bh, s, d = 12, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    out, _ = attn.flash_attention_fwd(q, k, v, causal=True)
    ref, _ = attn._flash_plain(q, k, v, causal=True, sm_scale=scale)
    err = float((out.float() - ref.float()).abs().max())
    ms = _time_ms(lambda: attn.flash_attention_fwd(q, k, v, causal=True), 100)
    plain_ms = _time_ms(lambda: attn._flash_plain(q, k, v, causal=True,
                                                  sm_scale=scale), 20)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 100)
    # least work: q, k, v read once, out (bf16) and lse (f32) written once;
    # causal QK^T and PV on the live half of the score matrix
    nbytes = 4 * bh * s * d * 2 + bh * s * 4
    flops = 2 * bh * s * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    line = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:138",
        "launches": launches["flash_fwd"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shape": {"bh": bh, "s": s, "d": d, "causal": True,
                  "dtype": "bfloat16"},
    }]}
    print(json.dumps(line), flush=True)
    if not err <= 2e-2:
        raise AssertionError(f"flash_fwd at the serving shape: error {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import ray_tpu_torch.ops.attention  # noqa: F401  (fails outside the repo)

    smi = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    phase_serve_f32()
    launches = phase_serve_bf16()
    phase_kernels(launches)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
