#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc versions.
   TF32 is switched off for the checks.
2. build: nvcc builds every kernel source of the ported paths
   (``ray_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``), all at
   once, and reports each kernel's registers and spills from ptxas (the
   backward's tensor-core ``*_mma_kernel`` instantiations for f16 and bf16,
   its CUDA-core ones for f32), and lists every instantiation that spills.
3. kernel vs plain: the ``flash_fwd`` sm_90a kernel against its plain
   PyTorch version (f32 math on the same rounded inputs) over dtypes
   {f32, bf16, f16} x head dims {16, 32, 64, 128} x B*H {12, 24} x causal
   x lengths, plus cross lengths and rows with no live column.
   Tolerance, element by element, |err| <= atol + rtol * |ref| (``TOLS``):
   f32 1e-4, 1e-4 (sums in another order); bf16 1e-3, 1.6e-2 and f16 1e-3,
   2e-3 (the kernel rounds each output once to 8 or 11 significant bits;
   rtol is 4x that rounding). lse atol 1e-3 and +inf on exactly the same
   rows.
4. bwd kernel vs plain: dq from ``flash_bwd_dq`` and dk, dv from
   ``flash_bwd_dkv`` against the plain blockwise backward, both given the
   same q, k, v, a non-uniform dO and the forward kernel's out and lse, over
   {f32, bf16, f16} x D {16, 32, 64, 128} x B*H 12 x causal x S {1, 64, 129,
   512, 1024}, plus (16, 64), (1, 300) and causal (64, 16), whose dead rows
   must get dq = 0 exactly, and the training shape (B*H 192, S 1024, D 64,
   causal) in f32. Tolerance: ``TOLS``, element by element, per tensor. One
   bf16 case is also held against torch.autograd through
   ``attention_reference`` in f32, at atol 1e-2 (delta takes the forward's
   bf16-rounded output) and rtol 1.6e-2. Then the edges of the tensor-core
   design (bf16 and f16 run on it, f32 on the CUDA cores; the library
   reports which): bf16 and f16 x D {16, 32, 64, 128} x causal Sq {65, 127,
   1000} x Sk 1024, where the diagonal crosses a 64-row tile off its
   corner, and the training shape in bf16.
5. serve in f32: GPT-2-124M at full width with random weights decodes 3
   prompts x 16 tokens through the kernel and through its plain version
   on the same weights; the tokens must be equal. ``entry()`` runs its
   (2, 256) forward.
6. serve at bf16 (the serving path): ``LLMServer`` answers 4 concurrent
   requests (prompts of 32, 129, 300, 512 tokens) and then the 32-token
   prompt again, 16 tokens each. Launch counts are zeroed just before and
   read just after. Checks: 16 tokens per stream, the repeat streams the
   same tokens and hits the prefix cache, flash_fwd launches >= 12 x
   forwards and no backward launch, last-position logits within atol 5e-2
   of the plain version's. Prints TTFT and tokens/s.
7. train in f32: GPT-2-124M at full width, batch 2, seq 256,
   ``loss_chunks=8``: one ``build_train_step`` step through the kernels and
   one through the plain attention (autograd through the blockwise
   forward), from the same weights. Loss within 1e-5 relative; every
   parameter's gradient within 1e-4 relative norm.
8. train at bf16 (the training path, ``bench.py``'s first flash
   configuration): GPT-2-124M, batch 16, seq 1024, ``loss_chunks=8``,
   AdamW, one fixed batch. Launch counts are zeroed, then 3 warm-up and 10
   timed steps run. Checks: finite loss, lower at step 13 than at step 1,
   and flash_fwd = flash_bwd_dq = flash_bwd_dkv = 12 x 13 launches. Prints
   step ms, tokens/s, the losses and the peak memory.
9. kernels: per kernel its launches on its path, error, time (CUDA events)
   at that path's shape, the plain version's time, a PyTorch call as a
   yardstick (the port never calls it) and the least time the card could
   take: flash_fwd at the serving shape (B*H 12, S 512, D 64, causal, bf16)
   and all three kernels at the training shape (B*H 192, S 1024, D 64,
   causal, bf16), each held to the bf16 ``TOLS`` element by element (the
   line prints the tolerance and the largest error's share of its limit),
   with an estimate of attention's share of the step. Each entry also
   gives its design ("mma.sync" or "cuda-core f32") and its rate in
   TFLOP/s (the live pairs' FLOPs over its time); the backward entries give
   dq + dk/dv over SDPA's backward. Two launches of each backward kernel at
   the training shape must give the same bits.

The last two lines are the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import json
import math
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
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SOURCE = {"flash_fwd": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
          "flash_bwd_dq": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "flash_bwd_dkv": "ray_tpu_torch/ops/csrc/flash_bwd.cu"}
REPLACES = {"flash_fwd": "ray_tpu/ops/attention.py:138",
            "flash_bwd_dq": "ray_tpu/ops/attention.py:194",
            "flash_bwd_dkv": "ray_tpu/ops/attention.py:233"}


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


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    # every kernel source of the ported paths, one nvcc each, all at once
    sources = [attn._SOURCE, attn._BWD_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    wall = time.perf_counter() - t0
    attn._load_kernel()
    attn._load_bwd_kernel()
    ptxas = {src.name: _build.ptxas_summary(path)
             for (path, _), src in zip(built, sources)}
    spills = sorted(name for kernels in ptxas.values()
                    for name, summary in kernels.items()
                    if not summary.endswith(" 0 bytes spilled"))
    emit("build", wall_s=wall,
         seconds={src.name: s for (_, s), src in zip(built, sources)},
         ptxas=ptxas, spills=spills)


def _close(got, want, atol, rtol):
    """Element by element |got - want| <= atol + rtol * |want|; returns
    (ok, max abs error, largest error as a share of its element's limit).
    A NaN fails."""
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    return share <= 1.0, float(err.max()), share


# kernel vs plain (f32 math on the same rounded inputs), (atol, rtol) by
# dtype, element by element
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1.6e-2),
        torch.float16: (1e-3, 2e-3)}
TOL_REASON = ("f32: sums in another order; bf16/f16: the kernel rounds each "
              "output once to 8 or 11 significant bits (relative error at "
              "most 2^-8 or 2^-11), rtol is 4x that, atol covers values "
              "near 0")


def _tol_fields(dtype):
    atol, rtol = TOLS[dtype]
    return {"atol": atol, "rtol": rtol}


def _check_flash(q, k, v, causal):
    """Kernel vs plain on one input; returns (ok, out_err, lse_err,
    out error's share of its limit)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = attn._flash_plain(q.float(), k.float(), v.float(),
                                     causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5)
    ok_out, out_err, share = _close(out.float(), ref, *TOLS[q.dtype])
    same_inf = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)))
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() \
        else 0.0
    return ok_out and same_inf and lse_err <= 1e-3, out_err, lse_err, share


def _flash_cases():
    """(Sq, Sk, causal): square lengths, cross lengths, and causal (64, 16)
    whose rows 0..47 see no key."""
    cases = [(s, s, causal) for s in (1, 64, 129, 512, 1024)
             for causal in (False, True)]
    for causal in (False, True):
        cases += [(16, 64, causal), (1, 300, causal)]
    return cases + [(64, 16, True)]


def phase_kernel_vs_plain():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = _flash_cases()
    worst = {}
    failures = []
    n = 0
    for dtype in TOLS:
        for d in (16, 32, 64, 128):
            for bh in (12, 24):
                for sq, sk, causal in cases:
                    mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                               device=dev).to(dtype)
                    q, k, v = mk(sq), mk(sk), mk(sk)
                    ok, out_err, lse_err, share = _check_flash(q, k, v,
                                                               causal)
                    n += 1
                    key = str(dtype).split(".")[-1]
                    w = worst.setdefault(key, [0.0, 0.0, 0.0])
                    worst[key] = [max(a, b) for a, b in
                                  zip(w, (out_err, lse_err, share))]
                    if not ok:
                        failures.append(dict(dtype=key, d=d, bh=bh, sq=sq,
                                             sk=sk, causal=causal,
                                             out_err=out_err,
                                             lse_err=lse_err))
    torch.cuda.synchronize()
    emit("kernel_vs_plain", kernel="flash_fwd", cases=n,
         max_err={k: {"out": v[0], "lse": v[1], "out_share_of_limit": v[2]}
                  for k, v in worst.items()},
         tolerance={"out": {str(dt).split(".")[-1]: _tol_fields(dt)
                            for dt in TOLS}, "reason": TOL_REASON,
                    "lse": "atol 1e-3, +inf on exactly the same rows"},
         failures=failures[:10])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"in {len(failures)} of {n} cases")


def _check_bwd(q, k, v, do, causal):
    """Backward kernels vs the plain backward (f32 math on the same rounded
    inputs, the same out and lse from the forward kernel), element by
    element at ``TOLS``; returns (ok, [dq, dk, dv max abs errors],
    [their largest shares of the limit], grads)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    got = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = attn._flash_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                do.float(), causal=causal,
                                sm_scale=q.shape[-1] ** -0.5)
    held = [_close(g.float(), r, *TOLS[q.dtype]) for g, r in zip(got, ref)]
    return (all(h[0] for h in held), [h[1] for h in held],
            [h[2] for h in held], got)


def phase_bwd_kernel_vs_plain():
    from ray_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, failures, n = {}, [], 0

    def case(dtype, bh, d, sq, sk, causal):
        nonlocal n
        key = str(dtype).split(".")[-1]
        mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype)
        q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
        ok, errs, shares, got = _check_bwd(q, k, v, do, causal)
        if sq > sk and causal:  # dead rows: exactly 0, no NaN
            ok = ok and not bool(got[0][:, :sq - sk].any())
        n += 1
        w = worst.setdefault(key, [0.0] * 6)
        worst[key] = [max(a, b) for a, b in zip(w, errs + shares)]
        if not ok:
            failures.append(dict(dtype=key, bh=bh, d=d, sq=sq, sk=sk,
                                 causal=causal, errs=errs, shares=shares))

    for dtype in TOLS:
        for d in (16, 32, 64, 128):
            for sq, sk, causal in _flash_cases():
                case(dtype, 12, d, sq, sk, causal)
    # the training shape (B*H 192, S 1024, D 64, causal) in f32 as well
    case(torch.float32, 192, 64, 1024, 1024, True)
    # one bf16 case against autograd through the naive reference in f32.
    # Besides rounding, delta = rowsum(dO * O) takes O rounded to bf16 by
    # the forward, an error shared by a whole row of dS: atol 1e-2.
    autograd_tol = (1e-2, TOLS[torch.bfloat16][1])
    q, k, v, do = (torch.randn((12, 512, 64), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attn.attention_reference(*leaves, causal=True)
    ref_grads = torch.autograd.grad(ref, leaves, do.float())
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    got = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    vs_autograd = [_close(g.float(), r, *autograd_tol)
                   for g, r in zip(got, ref_grads)]
    autograd_ok = all(h[0] for h in vs_autograd)
    # the tensor-core design's edges: causal cross lengths whose diagonal
    # crosses a 64-row tile off its corner, and the training shape in bf16
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32, 64, 128):
            for sq in (65, 127, 1000):
                case(dtype, 12, d, sq, 1024, True)
    case(torch.bfloat16, 192, 64, 1024, 1024, True)
    torch.cuda.synchronize()
    design = {str(dt).split(".")[-1]: attn.bwd_design(dt) for dt in TOLS}
    names = ("dq", "dk", "dv", "dq_share", "dk_share", "dv_share")
    emit("bwd_kernel_vs_plain", kernels=["flash_bwd_dq", "flash_bwd_dkv"],
         cases=n, design=design,
         bh=[12, "192 (f32 and bf16, S 1024, D 64, causal)"],
         max_err={k: dict(zip(names, v)) for k, v in worst.items()},
         tolerance={**{str(dt).split(".")[-1]: _tol_fields(dt)
                       for dt in TOLS}, "reason": TOL_REASON,
                    "share": "largest |err| / (atol + rtol*|ref|), at most 1"},
         vs_autograd_reference={
             "case": "bf16, B*H 12, S 512, D 64, causal",
             "atol": autograd_tol[0], "rtol": autograd_tol[1],
             "errs": [h[1] for h in vs_autograd],
             "shares": [h[2] for h in vs_autograd], "ok": autograd_ok},
         failures=failures[:10])
    if failures or not autograd_ok:
        raise AssertionError(f"backward kernels disagree: {len(failures)} of "
                             f"{n} cases vs plain, autograd ok={autograd_ok}")
    if design != {"float32": "cuda-core f32", "bfloat16": "mma.sync",
                  "float16": "mma.sync"}:
        raise AssertionError(f"backward design by dtype is {design}")


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

    _zero_launches()
    llm.forwards = 0
    t0 = time.perf_counter()
    results = asyncio.run(_serve_requests(server, prompts, prompts[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
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
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        problems.append(f"serving launched backward kernels: {launches}")
    if not logit_err <= 5e-2:
        problems.append(f"last-position logits differ by {logit_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _zero_launches():
    from ray_tpu_torch.ops import attention as attn

    for name in KERNELS:
        setattr(attn, f"{name}_launches", 0)


def _read_launches():
    from ray_tpu_torch.ops import attention as attn

    return {name: getattr(attn, f"{name}_launches") for name in KERNELS}


def phase_train_f32():
    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.gpt2_124m(attention="flash", loss_chunks=8,
                                    dtype=torch.float32)
    batch = gpt2.synthetic_batch(4, 2, 256, cfg.vocab_size)
    runs = {}
    for path, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", _plain_attention)):
        model, optimizer = gpt2.make_train_state(
            cfg, torch.Generator().manual_seed(0))
        step = gpt2.build_train_step(model, optimizer)
        _zero_launches()
        with ctx():
            _, _, loss = step(model, optimizer, batch)
        torch.cuda.synchronize()
        runs[path] = (float(loss), _read_launches(),
                      {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()})
        del model, optimizer, step
        torch.cuda.empty_cache()
    (kloss, klaunch, kgrads), (ploss, plaunch, pgrads) = \
        runs["kernel"], runs["plain"]
    loss_rel = abs(kloss - ploss) / abs(ploss)
    grad_rel = {n: float((kgrads[n] - pgrads[n]).norm()
                         / pgrads[n].norm().clamp_min(1e-30))
                for n in pgrads}
    worst = max(grad_rel, key=grad_rel.get)
    del runs, kgrads, pgrads
    torch.cuda.empty_cache()
    emit("train_f32", loss_kernel=kloss, loss_plain=ploss,
         loss_rel_err=loss_rel, worst_grad_rel_err=grad_rel[worst],
         worst_grad_leaf=worst, launches_kernel_path=klaunch,
         launches_plain_path=plaunch,
         tolerance={"loss": "1e-5 relative", "grads": "1e-4 relative norm "
                    "per parameter (f32 sums in another order)"})
    problems = []
    if not (math.isfinite(kloss) and loss_rel <= 1e-5):
        problems.append(f"loss {kloss} vs plain {ploss}")
    if not grad_rel[worst] <= 1e-4:
        problems.append(f"{worst} gradient off by {grad_rel[worst]}")
    if klaunch != dict.fromkeys(KERNELS, 12) or any(plaunch.values()):
        problems.append(f"launches {klaunch} (kernel), {plaunch} (plain)")
    if problems:
        raise AssertionError("train_f32: " + "; ".join(problems))


def phase_train_bf16():
    from ray_tpu_torch.models import gpt2

    batch_size, seq, warmup, timed = 16, 1024, 3, 10
    cfg = gpt2.GPT2Config.gpt2_124m(attention="flash", loss_chunks=8)
    model, optimizer = gpt2.make_train_state(
        cfg, torch.Generator().manual_seed(0))
    step = gpt2.build_train_step(model, optimizer)
    batch = gpt2.synthetic_batch(1, batch_size, seq, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    _zero_launches()
    for _ in range(warmup):
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    losses = [float(x) for x in losses]
    step_ms = wall / timed * 1e3
    peak = torch.cuda.max_memory_allocated()
    del model, optimizer, step, batch
    torch.cuda.empty_cache()
    n_steps = warmup + timed
    emit("train_bf16", config="gpt2_124m attention=flash loss_chunks=8 "
         "remat=False bf16/f32-params AdamW", batch=batch_size, seq=seq,
         steps=n_steps, step_ms=step_ms,
         tokens_per_s=batch_size * seq * timed / wall, losses=losses,
         launches=launches, peak_memory_bytes=peak)
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append("non-finite loss")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    want = cfg.n_layer * n_steps
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    if problems:
        raise AssertionError("train_bf16: " + "; ".join(problems))
    return launches, step_ms


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


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _live_pairs(bh, sq, sk, causal):
    """(query, key) pairs the causal mask leaves live: the work these
    inputs need."""
    if not causal:
        return bh * sq * sk
    return bh * sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))


def _entry(name, launches, err, ms, plain_ms, bound, library_ms, flops,
           design, **extra):
    """One kernel's entry of the ``kernels`` line; ``flops`` are the live
    pairs' FLOPs, which give its rate in TFLOP/s."""
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "design": design, **extra}


def _serve_shape_entry(launches):
    """flash_fwd at the serving shape of the 512-token prompt."""
    from ray_tpu_torch.ops import attention as attn

    bh, s, d = 12, 512, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    out, _ = attn.flash_attention_fwd(q, k, v, causal=True)
    ref, _ = attn._flash_plain(q.float(), k.float(), v.float(), causal=True,
                               sm_scale=scale)
    ok, err, share = _close(out.float(), ref, *TOLS[torch.bfloat16])
    ms = _time_ms(lambda: attn.flash_attention_fwd(q, k, v, causal=True), 100)
    plain_ms = _time_ms(lambda: attn._flash_plain(q, k, v, causal=True,
                                                  sm_scale=scale), 20)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 100)
    # q, k, v read once, out (bf16) and lse (f32) written once; QK^T and PV
    # over the live pairs
    nbytes = 4 * bh * s * d * 2 + bh * s * 4
    flops = 4 * _live_pairs(bh, s, s, True) * d
    if not ok:
        raise AssertionError(f"flash_fwd at the serving shape: error {err}, "
                             f"{share} of its limit")
    return _entry("flash_fwd", launches["flash_fwd"], err, ms, plain_ms,
                  _bound(nbytes, flops), library_ms, flops, "cuda-core f32",
                  path="serve",
                  tolerance=_tol_fields(torch.bfloat16),
                  err_share_of_limit=share, library="torch SDPA forward",
                  shape={"bh": bh, "s": s, "d": d, "causal": True,
                         "dtype": "bfloat16"})


def _train_shape_entries(launches, step_ms):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at the shape the training
    path gives them (batch 16 x 12 heads, seq 1024, D 64, causal, bf16)."""
    from ray_tpu_torch.ops import attention as attn

    b, h, s, d = 16, 12, 1024, 64
    bh, n = b * h, b * h * s * d
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    kw = dict(causal=True, sm_scale=scale)
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    delta = attn._delta(out, do)
    # errors against the plain versions in f32 on the same rounded inputs
    f32 = [t.float() for t in (q, k, v, do)]
    ref_out, _ = attn._flash_plain(*f32[:3], **kw)
    ref_dq = attn._bwd_dq_plain(*f32, lse, delta, block_q=64, block_k=64,
                                **kw)
    ref_dk, ref_dv = attn._bwd_dkv_plain(*f32, lse, delta, block_q=64,
                                         block_k=64, **kw)
    dq = attn._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = attn._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    # element by element at the bf16 tolerance of the kernel-vs-plain phases
    pairs = {"flash_fwd": ((out, ref_out),), "flash_bwd_dq": ((dq, ref_dq),),
             "flash_bwd_dkv": ((dk, ref_dk), (dv, ref_dv))}
    tol = TOLS[torch.bfloat16]
    held = {name: [_close(g.float(), r, *tol) for g, r in ps]
            for name, ps in pairs.items()}
    errs = {name: max(h[1] for h in hs) for name, hs in held.items()}
    shares = {name: max(h[2] for h in hs) for name, hs in held.items()}
    # no atomics, a fixed order of sums: a second launch gives the same bits
    again = {"flash_bwd_dq": (attn._flash_bwd_dq_kernel(
                 q, k, v, do, lse, delta, **kw),),
             "flash_bwd_dkv": attn._flash_bwd_dkv_kernel(
                 q, k, v, do, lse, delta, **kw)}
    first = {"flash_bwd_dq": (dq,), "flash_bwd_dkv": (dk, dv)}
    same_bits = {name: all(torch.equal(a, b) for a, b in
                           zip(first[name], again[name])) for name in first}
    del f32, pairs, ref_out, ref_dq, ref_dk, ref_dv, dq, dk, dv, again, first

    ms = {"flash_fwd": _time_ms(lambda: attn.flash_attention_fwd(
              q, k, v, causal=True), 20),
          "flash_bwd_dq": _time_ms(lambda: attn._flash_bwd_dq_kernel(
              q, k, v, do, lse, delta, **kw), 10),
          "flash_bwd_dkv": _time_ms(lambda: attn._flash_bwd_dkv_kernel(
              q, k, v, do, lse, delta, **kw), 10)}
    delta_ms = _time_ms(lambda: attn._delta(out, do), 20)
    plain_ms = {"flash_fwd": _time_ms(lambda: attn._flash_plain(
                    q, k, v, **kw), 3),
                "flash_bwd_dq": _time_ms(lambda: attn._bwd_dq_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3),
                "flash_bwd_dkv": _time_ms(lambda: attn._bwd_dkv_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3)}
    # yardsticks: SDPA's forward, and its backward as (forward + backward)
    # minus forward, both with grad enabled
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(b, h, s, d)
    sdpa_fwd = _time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), 20)
    sdpa_fwd_bwd = _time_ms(lambda: torch.autograd.grad(
        sdpa(q4, k4, v4, is_causal=True), (q4, k4, v4), do4), 20)
    sdpa_bwd = sdpa_fwd_bwd - sdpa_fwd

    live = _live_pairs(bh, s, s, True)
    stats = bh * s * 4   # one f32 per row: lse or delta
    flops = {"flash_fwd": 4 * live * d, "flash_bwd_dq": 6 * live * d,
             "flash_bwd_dkv": 8 * live * d}
    nbytes = {"flash_fwd": 4 * n * 2 + stats,
              "flash_bwd_dq": 5 * n * 2 + 2 * stats,
              "flash_bwd_dkv": 6 * n * 2 + 2 * stats}
    bounds = {name: _bound(nbytes[name], flops[name]) for name in KERNELS}
    bwd_design = attn.bwd_design(torch.bfloat16)
    bwd_vs_sdpa = (ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]) / sdpa_bwd
    extra = {name: {"bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
                    "same_bits_twice": same}
             for name, same in same_bits.items()}
    library = {"flash_fwd": (sdpa_fwd, "torch SDPA forward"),
               "flash_bwd_dq": (sdpa_bwd, "torch SDPA backward (dq, dk and "
                                "dv together)"),
               "flash_bwd_dkv": (sdpa_bwd, "torch SDPA backward (dq, dk and "
                                 "dv together)")}
    shape = {"bh": bh, "s": s, "d": d, "causal": True, "dtype": "bfloat16"}
    entries = [_entry(name, launches[name], errs[name],
                      ms[name], plain_ms[name], bounds[name],
                      library[name][0], flops[name],
                      bwd_design if name in same_bits else "cuda-core f32",
                      path="train", tolerance=_tol_fields(torch.bfloat16),
                      err_share_of_limit=shares[name],
                      library=library[name][1], shape=shape,
                      **extra.get(name, {}))
               for name in KERNELS]
    attn_ms = (sum(ms.values()) + delta_ms) * GPT2_124M["n_layer"]
    share = {"attention_ms_per_step": attn_ms, "step_ms": step_ms,
             "share": attn_ms / step_ms, "delta_ms": delta_ms,
             "bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
             "note": "estimate: kernel ms at this shape x 12 layers / step "
                     "ms, not a trace"}
    bad = [name for name, hs in held.items() if not all(h[0] for h in hs)]
    if bad:
        raise AssertionError(f"at the training shape {bad} disagree with "
                             f"their plain versions: {errs}, {shares} of "
                             "their limits")
    if not all(same_bits.values()):
        raise AssertionError(f"a second launch gave other bits: {same_bits}")
    return entries, share


def phase_kernels(serve_launches, train_launches, step_ms):
    entries = [_serve_shape_entry(serve_launches)]
    train_entries, share = _train_shape_entries(train_launches, step_ms)
    emit("attention_share", **share)
    print(json.dumps({"kernels": entries + train_entries}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import ray_tpu_torch.ops.attention  # noqa: F401  (fails outside the repo)

    smi = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    phase_bwd_kernel_vs_plain()
    phase_serve_f32()
    serve_launches = phase_serve_bf16()
    phase_train_f32()
    train_launches, step_ms = phase_train_bf16()
    phase_kernels(serve_launches, train_launches, step_ms)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
