#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc versions.
   TF32 is switched off for the checks.
2. build: nvcc builds every kernel source of the ported paths
   (``ray_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``, both
   including ``mma_sm90.cuh``), all at once, and reports each kernel's
   registers and spills from ptxas (the tensor-core ``*_mma_kernel``
   instantiations for f16 and bf16, the CUDA-core ones for f32), and lists
   every instantiation that spills.
3. kernel vs plain: the ``flash_fwd`` sm_90a kernel against its plain
   PyTorch version (f32 math on the same rounded inputs) over dtypes
   {f32, bf16, f16} x head dims {16, 32, 64, 128} x B*H {12, 24} x causal
   x lengths, plus cross lengths, rows with no live column and ViT's
   non-causal lengths (197, 197) and (17, 17). Then the live length
   ``k_len`` on the device over a static cache of 544 rows (the Llama
   decode's): every dtype x D {64, 128} x Sq {1, 5} x k_len {1, 64, 513,
   543} x causal, with NaN in the rows past k_len, which the kernel must
   never read. Then the
   edges of the tensor-core design (bf16 and f16 run on it, f32 on the CUDA
   cores; the library reports which, and the phase asserts it): bf16 and
   f16 x D {16, 32, 64, 128} x causal Sq {65, 127, 1000} x Sk 1024, where
   the diagonal crosses a 64-row tile off its corner, and the training
   shape (B*H 192, S 1024, D 64, causal) in bf16, launched twice: the two
   launches must give the same bits. Tolerance, element by element,
   |err| <= atol + rtol * |ref| (``TOLS``): f32 1e-4, 1e-4 (sums in another
   order); bf16 1e-3, 1.6e-2 and f16 1e-3, 2e-3 (the kernel rounds each
   output once to 8 or 11 significant bits; rtol is 4x that rounding). lse
   atol 1e-3 and +inf on exactly the same rows, whose outputs must be 0.
4. bwd kernel vs plain: dq from ``flash_bwd_dq`` and dk, dv from
   ``flash_bwd_dkv`` against the plain blockwise backward, both given the
   same q, k, v, a non-uniform dO and the forward kernel's out and lse, over
   {f32, bf16, f16} x D {16, 32, 64, 128} x B*H 12 x causal x S {1, 64, 129,
   512, 1024}, plus (16, 64), (1, 300) and causal (64, 16), whose dead rows
   must get dq = 0 exactly, ViT's non-causal (197, 197) and (17, 17), and
   the training shape (B*H 192, S 1024, D 64,
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
   parameter's gradient within 1e-4 relative norm (the worst and the median
   leaf are printed).
8. train at bf16 (the training path, ``bench.py``'s first flash
   configuration): GPT-2-124M, batch 16, seq 1024, ``loss_chunks=8``,
   AdamW, one fixed batch. Launch counts are zeroed, then 3 warm-up and 10
   timed steps run (``train_bf16`` in ``ray_tpu_torch/tools/train_runs.py``,
   which ``tools/fwd_ab.py`` times too). Checks: finite loss, lower at step
   13 than at step 1, and flash_fwd = flash_bwd_dq = flash_bwd_dkv = 12 x 13
   launches. Prints
   step ms, tokens/s, the losses and the peak memory.
9. llama_f32: Llama-2-7B width cut to 4 layers, f32, random weights from
   seed 0 drawn on the card: the prefill's last logits and 8
   teacher-forced decode steps (2 prompts of 128 tokens) through the f32
   kernel against the plain attention, max |d| / max |ref| <= 1e-3
   (``LLAMA_F32_LIMIT``), and the full causal pass's last logits against a
   step-by-step decode from empty caches at the same limit; flash_fwd
   launches 9 x 4.
10. llama_serve Llama-2-7B, 11. llama_serve Llama-3-8B (GQA, 8 KV heads):
   full depth and width, bf16 Dense and Embed weights, f32 norm scales.
   ``generate`` over 4 prompts of 512 random tokens, 32 greedy new tokens,
   caches of 544 handed whole to the kernel with the live length on the
   device, launch counts zeroed just before and read just after:
   flash_fwd exactly 32 per prefill + 32 per decode step x 31 = 1024, no
   backward launch; the tokens' sha256. Then its prefill and decode steps
   timed again (3 runs), and the prefill's last logits and every
   teacher-forced decode step against the plain attention on the same
   weights and tokens: ||d|| / ||ref|| <= 5e-2 and max |d| <= 0.25
   (``LLAMA_BF16_LIMITS``, argued before the first chip run; torch SDPA in
   the kernel's place, with the kernel's mask, is an ungated control).
   The kernel is also held on real activations: the q, k, v the model
   hands it at layers 0, 16 and 31 during the prefill and during one
   decode step, against its plain version at ``TOLS`` element by element.
   Prints prefill ms, decode ms per token, tokens/s, peak memory and the
   decode step's share of its HBM bound.
12. llama_train: Llama-2-7B width cut to 2 layers, bf16 compute over f32
   weights, batch 2 x 2048: one step's gradients through the kernels
   against the plain attention's (worst parameter's relative error norm
   <= 5e-2, ``LLAMA_GRAD_LIMIT``), then 5 AdamW steps on one batch: finite
   losses, the last below the first, and each kernel launched exactly 2
   x 5 times.
13. vit_train: ViT-B/16 at full depth and width (224^2, S 197, 86.6 M
   parameters), bf16 over f32 weights, batch 64, ``make_train_state``'s
   AdamW (lr ``VIT["lr"]``): 5 steps on one batch, finite losses, the last
   below the first, 12 launches of each kernel per step (non-causal,
   B*H 768, S 197, D 64); the kernel held on the real q, k, v of layers
   0, 6 and 11 at ``TOLS``; an f32 pass cut to 2 layers at full width,
   kernel path against plain path on the logits, max |d| / max |ref| <=
   1e-4 (``VIT_F32_LIMIT``). Prints step ms and images/s.
14. resnet_train: ResNet-50 with the CIFAR stem, bf16 over f32 weights,
   batch 256 of 32^2 images, AdamW (lr ``RESNET["lr"]``): 5 steps on one
   batch, finite losses, the last below the first, and no flash kernel
   launched (its convolutions are cuDNN's). Prints step ms and images/s.
17. moe_train (runs before 15): the Switch-MoE LM, ``MoELMConfig()`` at full
   width and depth (vocab 50257, 768 wide, 12 layers, 12 heads, 8 experts,
   an MoE FFN in every second block, capacity factor 1.25; 322.6 M
   parameters), bf16 over f32 weights with the MoE FFN in f32, batch 16 x
   1024, AdamW at the reference's lr 3e-4: 5 steps on one batch with launch
   counts zeroed just before the steps and read just after (12 of each
   kernel per step), finite losses, the last below the first, aux finite
   and above 0.1 at every step. Prints step ms, tokens/s, peak memory and
   each MoE block's share of dropped tokens. Then the yardstick: the
   reference's one-hot (T, E, C) dispatch in place of the index dispatch
   for 2 steps on the same weights and batch; its first loss within 1e-6
   relative of the index form's (the forward is the same to the bit), the
   same drop shares, its step ms and peak memory. Then the f32 check, cut
   to 2 layers at full width (one dense block, one MoE block), batch 2 x
   256: one step's loss and gradients through the
   kernels against the plain attention's at phase 7's limits, with 2
   launches of each kernel on the kernel path and none on the plain path.
15. kernels: per kernel its launches on its path, error, time (CUDA events)
   at that path's shape, the plain version's time, a PyTorch call as a
   yardstick (the port never calls it) and the least time the card could
   take: flash_fwd at GPT-2's serving shape (B*H 12, S 512, D 64, causal,
   bf16) and at Llama's prefill (B*H 128, Sq 512 over the cache of 544
   rows, k_len 512, D 128) and decode (B*H 128, Sq 1, cache 544, k_len
   543, D 128) shapes, and all three kernels at GPT-2's training shape
   (B*H 192, S 1024, D 64, causal, bf16), Llama's (B*H 64, S 2048, D 128)
   ViT-B/16's (B*H 768, S 197, D 64, non-causal) and the MoE LM's (GPT-2's
   training shape, the MoE path's launches), each held to the
   bf16 ``TOLS`` element by element
   (the line prints the tolerance and the largest error's share of its
   limit), with an estimate of attention's share of each training step.
   Each entry also gives its design as the library reports it
   ("mma.sync" or "cuda-core f32") and its rate in TFLOP/s (the live
   pairs' FLOPs over its time); the backward entries give dq + dk/dv over
   SDPA's backward. Beside SDPA's
   forward time the forward entries give which SDPA backend ran (from the
   profiler's op names), its kernels' device time, and SDPA's own output
   error as a share of the bf16 limit against the same plain reference; the
   backward entries name the backend of SDPA's backward. ``device_ms`` is
   the kernel's own time from the profiler (each of the three); ``ms``
   (CUDA events around many
   calls) also holds the host's work per call, the larger part at the
   serving shape. Two launches of each backward kernel at the training
   shape must give the same bits.

16. llama_trace: Llama-2-7B serving once more, after every events
   timing, under the profiler: one prefill and 4 decode steps, each
   call's device time (the sum of its kernels' durations, the matrix
   products' part, flash_fwd's part, the rest, the largest kernels)
   against phase 10's host clock of the same calls, and the device's idle
   share.
18. moe_trace: one bf16 step of phase 17's model and batch, last, under the
   profiler: the device's time by class (each flash kernel, matrix
   products, the rest) and by the host op that launched it (the expert
   products' ``bmm``, beside their least time at the f32 rate, the MoE
   dispatch and combine's index ops),
   the flash kernels' device ms per launch at B*H 192, S 1024, D 64 causal,
   and the idle share against phase 17's median host-clock step.

Every phase raises on a failed check; no failure is caught.

Then one line with each phase's seconds. The last two lines are the
``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
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


def _check_flash(q, k, v, causal, k_len=None):
    """Kernel vs plain on one input; returns (ok, out_err, lse_err,
    out error's share of its limit). Rows with no live column must get
    lse = +inf and out = 0 exactly. With a live length ``k_len``, the rows
    of k and v past it may hold NaN: the kernel must not read them, and the
    plain version takes them as 0 (they are masked)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal, k_len=k_len)
    ref, ref_lse = attn._flash_plain(q.float(), k.float().nan_to_num(),
                                     v.float().nan_to_num(), causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5,
                                     k_len=k_len)
    ok_out, out_err, share = _close(out.float(), ref, *TOLS[q.dtype])
    same_inf = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)))
    dead_zero = not bool((out[torch.isinf(ref_lse)] != 0).any())
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() \
        else 0.0
    return (ok_out and same_inf and dead_zero and lse_err <= 1e-3, out_err,
            lse_err, share)


def _flash_cases():
    """(Sq, Sk, causal): square lengths, cross lengths, causal (64, 16)
    whose rows 0..47 see no key, and ViT's non-causal lengths: 197 (196
    patches and the class token of ViT-B/16) and 17 (``small_test``)."""
    cases = [(s, s, causal) for s in (1, 64, 129, 512, 1024)
             for causal in (False, True)]
    for causal in (False, True):
        cases += [(16, 64, causal), (1, 300, causal)]
    return cases + [(64, 16, True), (197, 197, False), (17, 17, False)]


# the live lengths of a decode over a whole static cache: Llama's cache of
# 544 rows (4 x 512 prompts + 32 new tokens), queries of 1 and 5 tokens
K_LEN_CACHE, K_LEN_QUERIES, K_LENS = 544, (1, 5), (1, 64, 513, 543)


def phase_kernel_vs_plain():
    from ray_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}   # {group: {dtype: [out_err, lse_err, share]}}
    failures = []
    n = 0

    def case(group, dtype, bh, d, sq, sk, causal, k_len=None):
        nonlocal n
        mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype)
        q, k, v = mk(sq), mk(sk), mk(sk)
        live = None
        if k_len is not None:   # NaN past the live length: never read
            k[:, k_len:] = v[:, k_len:] = float("nan")
            live = torch.tensor(k_len, dtype=torch.int32, device=dev)
        ok, out_err, lse_err, share = _check_flash(q, k, v, causal, live)
        n += 1
        key = str(dtype).split(".")[-1]
        w = worst.setdefault(group, {}).setdefault(key, [0.0, 0.0, 0.0])
        worst[group][key] = [max(a, b) for a, b in
                             zip(w, (out_err, lse_err, share))]
        if not ok:
            failures.append(dict(dtype=key, d=d, bh=bh, sq=sq, sk=sk,
                                 causal=causal, k_len=k_len, out_err=out_err,
                                 lse_err=lse_err, share=share))

    for dtype in TOLS:
        for d in (16, 32, 64, 128):
            for bh in (12, 24):
                for sq, sk, causal in _flash_cases():
                    case("lengths", dtype, bh, d, sq, sk, causal)
    # a live length k_len on the device over a static cache (the Llama
    # decode's); with Sq 5 and k_len 1, rows 0..3 see no key
    for dtype in TOLS:
        for d in (64, 128):
            for sq in K_LEN_QUERIES:
                for k_len in K_LENS:
                    for causal in (False, True):
                        case("k_len", dtype, 12, d, sq, K_LEN_CACHE, causal,
                             k_len)
    # the tensor-core design's edges: causal cross lengths whose diagonal
    # crosses a 64-row tile off its corner, and the training shape in bf16
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32, 64, 128):
            for sq in (65, 127, 1000):
                case("tensor_core_edges", dtype, 12, d, sq, 1024, True)
    case("training_shape", torch.bfloat16, 192, 64, 1024, 1024, True)
    # no atomics, a fixed order of sums: a second launch gives the same bits
    q, k, v = (torch.randn((192, 1024, 64), generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    first = attn.flash_attention_fwd(q, k, v, causal=True)
    again = attn.flash_attention_fwd(q, k, v, causal=True)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
    del q, k, v, first, again
    torch.cuda.synchronize()
    design = {str(dt).split(".")[-1]: attn.fwd_design(dt) for dt in TOLS}
    emit("kernel_vs_plain", kernel="flash_fwd", cases=n, design=design,
         max_err={group: {k: {"out": v[0], "lse": v[1],
                              "out_share_of_limit": v[2]}
                          for k, v in by_dtype.items()}
                  for group, by_dtype in worst.items()},
         same_bits_twice=same_bits,
         tolerance={"out": {str(dt).split(".")[-1]: _tol_fields(dt)
                            for dt in TOLS}, "reason": TOL_REASON,
                    "share": "largest |err| / (atol + rtol*|ref|), at most 1",
                    "lse": "atol 1e-3, +inf on exactly the same rows, "
                           "whose outputs are 0"},
         failures=failures[:10])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"in {len(failures)} of {n} cases")
    if not same_bits:
        raise AssertionError("a second flash_fwd launch gave other bits")
    if design != {"float32": "cuda-core f32", "bfloat16": "mma.sync",
                  "float16": "mma.sync"}:
        raise AssertionError(f"forward design by dtype is {design}")


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


def phase_serve_f32():
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.serve.llm.model import GPT2LLM
    from ray_tpu_torch.tools.train_runs import plain_attention

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
    with plain_attention():
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
    from ray_tpu_torch.serve.llm.engine import LLMServer
    from ray_tpu_torch.tools.train_runs import plain_attention

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
    with plain_attention():
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


def _loss_problems(losses):
    """A training run's loss checks: finite, and the last below the
    first."""
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append("non-finite loss")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return problems


def _zero_launches():
    from ray_tpu_torch.ops import attention as attn

    for name in KERNELS:
        setattr(attn, f"{name}_launches", 0)


def _read_launches():
    from ray_tpu_torch.ops import attention as attn

    return {name: getattr(attn, f"{name}_launches") for name in KERNELS}


def _f32_kernel_vs_plain(step_grads, n_layer):
    """One f32 step's loss and gradients from the same weights through the
    kernels and through the plain attention (``step_grads()`` -> (loss,
    grads)): (fields, problems) at phase 7's limits, loss 1e-5 relative and
    each gradient 1e-4 relative norm, with ``n_layer`` launches of each
    kernel on the kernel path and none on the plain path."""
    from ray_tpu_torch.tools import train_runs

    runs = {}
    for path, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", train_runs.plain_attention)):
        _zero_launches()
        with ctx():
            loss, grads = step_grads()
        runs[path] = (loss, _read_launches(), grads)
    (kloss, klaunch, kgrads), (ploss, plaunch, pgrads) = \
        runs["kernel"], runs["plain"]
    loss_rel = abs(kloss - ploss) / abs(ploss)
    grad = train_runs.grad_rel_errs(kgrads, pgrads)
    del runs, kgrads, pgrads
    torch.cuda.empty_cache()
    fields = dict(loss_kernel=kloss, loss_plain=ploss, loss_rel_err=loss_rel,
                  worst_grad_rel_err=grad["worst"],
                  worst_grad_leaf=grad["worst_leaf"],
                  median_grad_rel_err=grad["median"],
                  launches_kernel_path=klaunch, launches_plain_path=plaunch)
    problems = []
    if not (math.isfinite(kloss) and loss_rel <= 1e-5):
        problems.append(f"loss {kloss} vs plain {ploss}")
    if not grad["worst"] <= 1e-4:
        problems.append(f"{grad['worst_leaf']} gradient off by "
                        f"{grad['worst']}")
    if klaunch != dict.fromkeys(KERNELS, n_layer) or any(plaunch.values()):
        problems.append(f"launches {klaunch} (kernel), {plaunch} (plain)")
    return fields, problems


def phase_train_f32():
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tools import train_runs

    cfg = gpt2.GPT2Config.gpt2_124m(attention="flash", loss_chunks=8,
                                    dtype=torch.float32)
    batch = gpt2.synthetic_batch(4, 2, 256, cfg.vocab_size)
    fields, problems = _f32_kernel_vs_plain(
        lambda: train_runs.step_grads(cfg, batch), cfg.n_layer)
    emit("train_f32", **fields,
         tolerance={"loss": "1e-5 relative", "grads": "1e-4 relative norm "
                    "per parameter (f32 sums in another order)"})
    if problems:
        raise AssertionError("train_f32: " + "; ".join(problems))


def phase_train_bf16():
    from ray_tpu_torch.tools import train_runs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, step_ms = train_runs.train_bf16()
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_steps = train_runs.WARMUP + train_runs.TIMED
    emit("train_bf16", config="gpt2_124m attention=flash loss_chunks=8 "
         "remat=False bf16/f32-params AdamW", batch=train_runs.BATCH,
         seq=train_runs.SEQ, steps=n_steps, step_ms=step_ms,
         tokens_per_s=train_runs.BATCH * train_runs.SEQ / step_ms * 1e3,
         losses=losses, launches=launches, peak_memory_bytes=peak)
    problems = _loss_problems(losses)
    want = GPT2_124M["n_layer"] * n_steps
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    if problems:
        raise AssertionError("train_bf16: " + "; ".join(problems))
    return launches, step_ms


# Llama. The f32 check cuts Llama-2-7B to 4 of its 32 layers; serving runs
# Llama-2-7B and Llama-3-8B at full depth and width with bf16 weights;
# training cuts Llama-2-7B to 2 layers (full depth needs ~108 GB of f32
# weights, gradients and AdamW moments).
LLAMA_F32_LAYERS = 4
LLAMA_SERVE = {"batch": 4, "prompt": 512, "new_tokens": 32}
LLAMA_TRAIN = {"layers": 2, "batch": 2, "seq": 2048, "steps": 5}
# f32 kernel path vs plain path: max |kernel - plain| / max |plain| over
# every compared logit (f32 sums in another order through 4 layers)
LLAMA_F32_LIMIT = 1e-3
# bf16 serving, kernel path vs plain path on the same weights and tokens,
# over the prefill's last logits and every teacher-forced decode step.
# Argued before the first chip run (PERF.md): the two paths round
# attention's f32 result to bf16 at different points, and 32 bf16 layers
# carry any such difference up to bf16's own noise floor. A CPU emulation
# of a 32-layer, 256- and 512-wide Llama with random weights, perturbing
# attention's f32 output by 1e-7 to 4e-3 relative before its bf16 cast,
# gave ||d|| / ||ref|| 0.013-0.022 and max |d| 0.06-0.11 on logits of std
# ~1: the limits are 2.3x those
LLAMA_BF16_LIMITS = {"rel_norm": 5e-2, "max_abs_err": 0.25}
# bf16 training, one step's gradients, kernel path vs plain path: the
# relative error norm of the worst parameter; GPT-2-124M measured 0.0127
# on the H100 (PERF.md) and a 2-layer CPU emulation of this one 0.0072
LLAMA_GRAD_LIMIT = 5e-2


# substrings of the names of cuBLAS's matrix-product kernels
MATMUL_KERNELS = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")


def phase_llama_trace(serve):
    """Llama-2-7B serving once more (phase 10's weights and prompts), last,
    under the profiler: one prefill and 4 decode steps, the card's time per
    call by kernel. The idle share is taken against phase 10's host-clock
    times of the same calls (``serve``), read before any profiler session:
    after one, every launch costs the host more."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs, timing

    cfg = llama.LlamaConfig.llama2_7b()
    model = llama.init_params(cfg, _cuda_gen(20))
    llama.cast_for_serving(model, torch.bfloat16)
    B, T = LLAMA_SERVE["batch"], LLAMA_SERVE["prompt"]
    prompts = llama_runs.prompts(21, B, T, cfg.vocab_size, "cuda")
    caches = llama.init_kv_caches(cfg, B, T + 8)
    index = torch.tensor(T, device="cuda")   # on the device, as in generate

    def prefill():
        llama._prefill(model, prompts, caches)

    def decode():
        llama._decode_step(model, prompts[:, -1:], index, caches)
        index.add_(1)

    calls = {"prefill": (prefill, 1), "decode_step": (decode, 4)}
    fields = {}
    for name, (fn, n) in calls.items():
        index.fill_(T)
        kernels, per_call = timing.kernel_ms(fn, n)
        device = sum(kernels.values())
        matmul = sum(ms for k, ms in kernels.items()
                     if any(m in k.lower() for m in MATMUL_KERNELS))
        flash = sum(ms for k, ms in kernels.items() if "flash_fwd" in k)
        fields[name] = {
            "wall_ms": serve[name],
            "device_ms": device, "idle_share": 1 - device / serve[name],
            "kernels_per_call": per_call, "matmul_ms": matmul,
            "flash_fwd_ms": flash, "other_ms": device - matmul - flash,
            "top_kernels": [[k[:90], ms] for k, ms in
                            list(kernels.items())[:8]]}
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    emit("llama_trace", config="llama2_7b", batch=B, prompt=T,
         note="the profiler's kernel durations against phase 10's host "
              "clock of the same calls (its median prefill and decode step); "
              "decode steps here at positions 512-515", **fields)


@contextlib.contextmanager
def _sdpa_attention():
    """Route the model's flash-attention calls to torch SDPA, the control
    of the bf16 serving limits. The caches reach it whole with a live
    length ``k_len`` on the device, so it gets the kernel's mask as a
    boolean one, built on the device: query i sees key j iff j < k_len and
    j <= i + (k_len - Sq)."""
    import ray_tpu_torch.ops as ops

    kernel_path = ops.flash_attention

    def sdpa(q, k, v, *, causal=False, sm_scale=None, k_len=None, **_):
        sq, sk = q.shape[-2], k.shape[-2]
        live = sk if k_len is None else k_len
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        mask = kj < live
        if causal:
            mask = mask & (kj <= qi + (live - sq))
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm_scale)

    ops.flash_attention = sdpa
    try:
        yield
    finally:
        ops.flash_attention = kernel_path


def _cuda_gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def phase_llama_f32():
    """Llama-2-7B width, 4 layers, f32: the prefill logits and 8
    teacher-forced decode steps through the f32 kernel against the plain
    attention; then the full causal pass against a step-by-step decode."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    cfg = llama.LlamaConfig.llama2_7b(n_layer=LLAMA_F32_LAYERS,
                                      dtype=torch.float32)
    model = llama.init_params(cfg, _cuda_gen(0))
    prompt_len, steps = 128, 8
    prompts = llama_runs.prompts(10, 2, prompt_len, cfg.vocab_size, "cuda")
    tokens = llama.generate(model, prompts, steps + 1)
    _zero_launches()
    kernel, plain = llama_runs.teacher_forced_logits_both(model, tokens,
                                                          prompt_len)
    launches = _read_launches()
    errs = llama_runs.logit_errors(kernel, plain)
    argmax_equal = all(torch.equal(x.argmax(-1), tokens[:, prompt_len + i])
                       for i, x in enumerate(kernel))
    full_pass = llama_runs.decode_equals_full_pass(
        model, llama_runs.prompts(11, 2, 12, cfg.vocab_size, "cuda"))
    del model, kernel, plain
    torch.cuda.empty_cache()
    want = {"flash_fwd": (steps + 1) * cfg.n_layer, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    emit("llama_f32", config="llama2_7b", layers=cfg.n_layer,
         depth_cut=f"{cfg.n_layer} of 32 layers", batch=2,
         prompt=prompt_len, decode_steps=steps, **errs,
         share_of_limit=errs["max_rel_to_max"] / LLAMA_F32_LIMIT,
         generate_tokens_equal_kernel_argmax=argmax_equal,
         decode_vs_full_pass=full_pass,
         decode_vs_full_pass_share=full_pass / LLAMA_F32_LIMIT,
         launches=launches,
         tolerance={"max_rel_to_max": LLAMA_F32_LIMIT,
                    "reason": "f32 sums in another order through 4 layers",
                    "decode_vs_full_pass": LLAMA_F32_LIMIT})
    problems = []
    if not errs["max_rel_to_max"] <= LLAMA_F32_LIMIT:
        problems.append(f"kernel vs plain logits {errs}")
    if not full_pass <= LLAMA_F32_LIMIT:
        problems.append(f"decode vs full pass {full_pass}")
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    if problems:
        raise AssertionError("llama_f32: " + "; ".join(problems))


def _checked_layers(n_layer):
    """The layers whose attention inputs are held: first, middle, last."""
    return (0, n_layer // 2, n_layer - 1)


def _digest(tokens):
    """sha256 of the tokens' int64 bytes, to compare runs and trees."""
    return hashlib.sha256(tokens.to(torch.int64).cpu().numpy().tobytes()
                          ).hexdigest()


def _real_activation_checks(inputs):
    """Each captured flash-attention call (label, folded (q, k, v), its
    keywords) run again through the kernel and held against the plain
    version on the same real activations, element by element at ``TOLS``,
    as ``_check_flash`` holds random inputs."""
    rows = []
    for label, (q, k, v), kw in inputs:
        causal, k_len = kw.get("causal", False), kw.get("k_len")
        ok, out_err, lse_err, share = _check_flash(q, k, v, causal, k_len)
        rows.append({"call": label, "bh": q.shape[0], "sq": q.shape[1],
                     "sk": k.shape[1], "d": q.shape[2],
                     "k_len": None if k_len is None else int(k_len),
                     "causal": causal, "dtype": str(q.dtype).split(".")[-1],
                     "ok": ok, "out_err": out_err, "lse_err": lse_err,
                     "share_of_limit": share})
    return rows


def _activation_problems(rows):
    return [f"kernel vs plain on the real activations of {r['call']}: "
            f"error {r['out_err']}, {r['share_of_limit']} of its limit"
            for r in rows if not r["ok"]]


def phase_llama_serve(name, cfg, seed):
    """One model at full width, bf16 Dense and Embed weights, f32 norm
    scales: ``generate`` over 4 prompts of 512 random tokens, 32 greedy new
    tokens each, launch counts zeroed just before and read just after; its
    prefill and decode steps timed again; the prefill's last logits and
    every teacher-forced decode step against the plain attention, and the
    same for torch SDPA in the kernel's place, as a control of how much the
    bf16 limits can see."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    gc.collect()
    torch.cuda.empty_cache()
    B, T, new = (LLAMA_SERVE[k] for k in ("batch", "prompt", "new_tokens"))
    t0 = time.perf_counter()
    model = llama.init_params(cfg, _cuda_gen(seed))
    llama.cast_for_serving(model, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = llama_runs.prompts(seed + 1, B, T, cfg.vocab_size, "cuda")
    llama.generate(model, prompts[:, :16], 2)  # cuBLAS and the library warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    tokens, generate_s = llama_runs.time_generate(model, prompts, new)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = [llama_runs.time_steps(model, tokens, T,
                                   counts=(_zero_launches, _read_launches))
             for _ in range(3)]
    kernel, plain = llama_runs.teacher_forced_logits_both(model, tokens, T)
    errs = llama_runs.logit_errors(kernel, plain)
    with _sdpa_attention():
        control = llama_runs.logit_errors(
            llama_runs.teacher_forced_logits(model, tokens, T), plain)
    finite = all(bool(torch.isfinite(x.float()).all()) for x in kernel)
    argmax_equal = sum(int((x.argmax(-1) == tokens[:, T + i]).sum())
                       for i, x in enumerate(kernel)) / (B * new)
    activations = _real_activation_checks(llama_runs.attention_inputs(
        model, tokens, T, _checked_layers(cfg.n_layer)))
    del model, kernel, plain
    gc.collect()
    torch.cuda.empty_cache()

    prefill_ms = sorted(x["prefill_ms"] for x in steps)
    decode_ms = sorted(x["decode_ms_per_token"] for x in steps)
    # bounds: a decode step reads every weight but the embedding table (B
    # rows of it) and the live K and V of every layer; the prefill reads
    # the same weights (B x T rows of the table) and does the matmuls' 2
    # FLOPs per weight and token and attention's 4·d per live pair
    d, kv_row = cfg.head_dim, cfg.n_kv_head * cfg.head_dim * 2
    embed_bytes = cfg.vocab_size * cfg.n_embd * 2
    step_weights = weight_bytes - embed_bytes + B * cfg.n_embd * 2
    kv_reads = [2 * cfg.n_layer * B * (t + 1) * kv_row
                for t in range(T, T + new - 1)]
    decode_bound_weights = step_weights / HBM_BYTES_PER_S * 1e3
    decode_bound = (step_weights + sum(kv_reads) / len(kv_reads)) \
        / HBM_BYTES_PER_S * 1e3
    matmul_params = (cfg.num_params() - cfg.vocab_size * cfg.n_embd
                     - cfg.n_embd * (2 * cfg.n_layer + 1))
    prefill_flops = (2 * matmul_params * B * T + 4 * d * cfg.n_layer
                     * _live_pairs(B * cfg.n_head, T, T, True))
    prefill_bytes = weight_bytes - embed_bytes + B * T * cfg.n_embd * 2
    prefill_bound, prefill_bound_by = _bound(prefill_bytes, prefill_flops)
    want = {"flash_fwd": cfg.n_layer * new, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    want_steps = {"prefill_launches": dict(want, flash_fwd=cfg.n_layer),
                  "decode_launches": dict(want, flash_fwd=cfg.n_layer
                                          * (new - 1))}
    step_launches = {k: [x[k] for x in steps] for k in want_steps}
    emit("llama_serve", config=name, layers=cfg.n_layer,
         n_kv_head=cfg.n_kv_head, vocab=cfg.vocab_size, batch=B, prompt=T,
         new_tokens=new, cache_len=T + new, weight_bytes=weight_bytes,
         init_s=init_s, generate_s=generate_s,
         tokens_per_s=B * new / generate_s,
         prefill_ms=prefill_ms[1], prefill_ms_runs=prefill_ms,
         prefill_bound_ms=prefill_bound, prefill_bound_by=prefill_bound_by,
         decode_ms_per_token=decode_ms[1], decode_ms_runs=decode_ms,
         decode_bound_ms_weights=decode_bound_weights,
         decode_bound_ms=decode_bound,
         decode_share_of_bound=decode_bound / decode_ms[1],
         peak_memory_bytes=peak, launches=launches, **step_launches,
         generated_tokens_equal_kernel_argmax=argmax_equal, finite=finite,
         tokens_sha256=_digest(tokens), real_activations=activations,
         **errs, share_of_limits={k: errs[k] / v
                                  for k, v in LLAMA_BF16_LIMITS.items()},
         tolerance={**LLAMA_BF16_LIMITS, "reason": "2.3x what a CPU "
                    "emulation of bf16 noise over 32 layers gave (PERF.md)"},
         control_sdpa={**control, "share_of_limits": {
             k: control[k] / v for k, v in LLAMA_BF16_LIMITS.items()},
             "within_limits": all(control[k] <= v for k, v in
                                  LLAMA_BF16_LIMITS.items()),
             "note": "torch SDPA in the kernel's place against the plain "
                     "attention: not gated, it shows what the limits "
                     "can tell apart"})
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    for k, w in want_steps.items():
        if any(x != w for x in step_launches[k]):
            problems.append(f"{k} {step_launches[k]}, want {w}")
    if not finite:
        problems.append("non-finite logits")
    problems += _activation_problems(activations)
    for k, limit in LLAMA_BF16_LIMITS.items():
        if not errs[k] <= limit:
            problems.append(f"kernel vs plain {k} {errs[k]} > {limit}")
    if problems:
        raise AssertionError(f"llama_serve {name}: " + "; ".join(problems))
    return {"prefill_launches": steps[0]["prefill_launches"]["flash_fwd"],
            "decode_launches": steps[0]["decode_launches"]["flash_fwd"],
            "prefill": prefill_ms[1], "decode_step": decode_ms[1]}


def phase_llama_train():
    """Llama-2-7B width, 2 layers, bf16 compute over f32 weights, batch 2 x
    2048: one step's gradients through the kernels against the plain
    attention's, then 5 AdamW steps on one batch with launch counts zeroed
    just before and read just after."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    c = LLAMA_TRAIN
    cfg = llama.LlamaConfig.llama2_7b(n_layer=c["layers"])
    batch = llama.synthetic_batch(12, c["batch"], c["seq"], cfg.vocab_size)
    grads = llama_runs.grads_both(cfg, batch, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = llama_runs.train(cfg, batch, c["steps"], "cuda")
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    losses, step_ms = run["losses"], run["step_ms"]
    timed = sorted(step_ms[1:])
    step_median = timed[len(timed) // 2]
    emit("llama_train", config="llama2_7b", layers=cfg.n_layer,
         depth_cut=f"{cfg.n_layer} of 32 layers", batch=c["batch"],
         seq=c["seq"], steps=c["steps"], losses=losses, step_ms=step_ms,
         step_ms_median_after_first=step_median,
         tokens_per_s=c["batch"] * c["seq"] / step_median * 1e3,
         launches=launches, peak_memory_bytes=peak, grads_vs_plain=grads,
         tolerance={"worst_grad_rel_err": LLAMA_GRAD_LIMIT})
    problems = _loss_problems(losses)
    want = cfg.n_layer * c["steps"]
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    if not grads["worst"] <= LLAMA_GRAD_LIMIT:
        problems.append(f"{grads['worst_leaf']} gradient off by "
                        f"{grads['worst']}")
    if problems:
        raise AssertionError("llama_train: " + "; ".join(problems))
    return launches, step_median


# ViT-B/16 (224^2, batch 64: one Tune trial per card) and ResNet-50 with
# the CIFAR stem (32^2, batch 256), both bf16 over f32 weights with the
# reference's AdamW at lr 1e-4: at its default 1e-3, with no warm-up, the
# first Adam steps overshoot at full width, in the reference as in the
# port (PERF.md), and the loss of 5 steps rises. The f32 check cuts
# ViT-B/16 to 2 of its 12 layers
VIT = {"batch": 64, "steps": 5, "lr": 1e-4, "f32_layers": 2,
       "f32_batch": 16}
RESNET = {"batch": 256, "steps": 5, "lr": 1e-4}
# f32 kernel path vs plain path: max |kernel - plain| / max |plain| over
# the logits (f32 sums in another order through 2 layers; Llama's 4 layers
# measured 2.5e-6 of its largest logit, PERF.md)
VIT_F32_LIMIT = 1e-4


def _train_fields(run, batch):
    """Step ms (the median of the steps after the first) and images/s."""
    timed = sorted(run["step_ms"][1:])
    median = timed[len(timed) // 2]
    return {"losses": run["losses"], "step_ms": run["step_ms"],
            "step_ms_median_after_first": median,
            "images_per_s": batch / median * 1e3}


def phase_vit():
    """ViT-B/16 at full depth and width, bf16 over f32 weights, batch 64:
    5 AdamW steps on one batch, launch counts zeroed just before and read
    just after (12 of each kernel per step); the kernel held on the real
    attention inputs of layers 0, 6 and 11 (non-causal, S 197); then an
    f32 pass cut to 2 layers at full width, kernel path against plain
    path on the logits."""
    import gc

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import vision_runs

    cfg = vision.ViTConfig.vit_b16()
    batch = vision.synthetic_image_batch(40, VIT["batch"], cfg.image_size,
                                         cfg.num_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = vision_runs.train(cfg, batch, VIT["steps"], "cuda", VIT["lr"])
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    net = vision_runs.model(cfg, "cuda")
    n_params = sum(p.numel() for p in net.parameters())
    activations = _real_activation_checks(vision_runs.attention_inputs(
        net, batch["image"], _checked_layers(cfg.n_layer)))
    del net
    f32 = vision.ViTConfig.vit_b16(n_layer=VIT["f32_layers"],
                                   dtype=torch.float32)
    net = vision_runs.model(f32, "cuda")
    _zero_launches()
    kernel, plain = vision_runs.logits_both(net,
                                            batch["image"][:VIT["f32_batch"]])
    f32_launches = _read_launches()
    f32_err = float((kernel - plain).abs().max() / plain.abs().max())
    del net, kernel, plain, batch
    gc.collect()
    torch.cuda.empty_cache()
    fields = _train_fields(run, VIT["batch"])
    emit("vit_train", config="vit_b16", image_size=cfg.image_size,
         layers=cfg.n_layer, seq=cfg.seq_len, params=n_params,
         batch=VIT["batch"], steps=VIT["steps"], lr=VIT["lr"], **fields,
         launches=launches, peak_memory_bytes=peak,
         real_activations=activations,
         f32_check={"layers": f32.n_layer, "batch": VIT["f32_batch"],
                    "max_rel_to_max": f32_err,
                    "share_of_limit": f32_err / VIT_F32_LIMIT,
                    "launches": f32_launches},
         tolerance={"f32_max_rel_to_max": VIT_F32_LIMIT,
                    "real_activations": _tol_fields(torch.bfloat16)})
    problems = _loss_problems(run["losses"])
    want = cfg.n_layer * VIT["steps"]
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    problems += _activation_problems(activations)
    if not f32_err <= VIT_F32_LIMIT:
        problems.append(f"f32 kernel vs plain logits {f32_err}")
    if f32_launches != {"flash_fwd": f32.n_layer, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}:
        problems.append(f"f32 pass launches {f32_launches}")
    if problems:
        raise AssertionError("vit_train: " + "; ".join(problems))
    return launches, fields["step_ms_median_after_first"]


def phase_resnet():
    """ResNet-50 with the CIFAR stem, bf16 over f32 weights, batch 256 of
    32^2 images: 5 AdamW steps on one batch, launch counts zeroed just
    before and read just after; its convolutions are cuDNN's, so no flash
    kernel may launch."""
    import gc

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import vision_runs

    cfg = vision.ResNetConfig.resnet50_cifar()
    batch = vision.synthetic_image_batch(50, RESNET["batch"],
                                         cfg.image_size, cfg.num_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = vision_runs.train(cfg, batch, RESNET["steps"], "cuda",
                            RESNET["lr"])
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    emit("resnet_train", config="resnet50_cifar",
         stage_sizes=list(cfg.stage_sizes), image_size=cfg.image_size,
         batch=RESNET["batch"], steps=RESNET["steps"], lr=RESNET["lr"],
         **_train_fields(run, RESNET["batch"]), launches=launches,
         peak_memory_bytes=peak)
    problems = _loss_problems(run["losses"])
    if any(launches.values()):
        problems.append(f"flash kernels launched: {launches}")
    if problems:
        raise AssertionError("resnet_train: " + "; ".join(problems))


# Switch-MoE LM, ``MoELMConfig()`` (GPT-2 width, 12 layers, 8 experts, an
# MoE FFN in every second block), bf16 over f32 weights, the MoE FFN in f32:
# batch 16 x 1024, GPT-2's training shape, so that the two steps compare at
# the same tokens; the reference's lr 3e-4. The f32 check cuts it to 2
# layers (one dense block, one MoE block)
MOE = {"batch": 16, "seq": 1024, "steps": 5, "lr": 3e-4, "f32_layers": 2,
       "f32_batch": 2, "f32_seq": 256}
# H100 SXM published f32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12


def phase_moe_train():
    """MoELMConfig() at full width and depth, bf16 over f32 weights, batch
    16 x 1024: 5 AdamW steps on one batch with launch counts zeroed just
    before the steps and read just after (12 of each kernel per step); the
    reference's one-hot dispatch for 2 steps on the same weights and batch
    (the yardstick); then the f32 check, 2 layers at full width, kernel
    path against plain path on one step's loss and gradients."""
    import gc

    from ray_tpu_torch.models import gpt2, moe_lm
    from ray_tpu_torch.tools import moe_runs

    cfg = moe_lm.MoELMConfig()
    batch = gpt2.synthetic_batch(60, MOE["batch"], MOE["seq"],
                                 cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = moe_runs.train(cfg, batch, MOE["steps"], "cuda", MOE["lr"],
                         counts=(_zero_launches, _read_launches))
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with moe_runs.one_hot_dispatch():
        yard = moe_runs.train(cfg, batch, 2, "cuda", MOE["lr"])
    yard_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    f32 = moe_lm.MoELMConfig(n_layer=MOE["f32_layers"], dtype=torch.float32)
    f32_batch = gpt2.synthetic_batch(61, MOE["f32_batch"], MOE["f32_seq"],
                                     cfg.vocab_size)
    f32_fields, f32_problems = _f32_kernel_vs_plain(
        lambda: moe_runs.step_grads(f32, f32_batch, "cuda"), f32.n_layer)
    del batch, f32_batch
    gc.collect()
    torch.cuda.empty_cache()

    fields = _train_fields(run, MOE["batch"])
    median = fields.pop("step_ms_median_after_first")
    fields.pop("images_per_s")
    yard_rel = abs(yard["losses"][0] - run["losses"][0]) / abs(
        run["losses"][0])
    emit("moe_train", config="MoELMConfig() bf16/f32-params, MoE FFN f32",
         layers=cfg.n_layer, moe_blocks=sum(map(cfg.is_moe,
                                                range(cfg.n_layer))),
         experts=cfg.num_experts, capacity_factor=cfg.capacity_factor,
         params=run["params"], batch=MOE["batch"], seq=MOE["seq"],
         steps=MOE["steps"], lr=MOE["lr"], **fields, lm=run["lm"],
         aux=run["aux"], step_ms_median_after_first=median,
         tokens_per_s=MOE["batch"] * MOE["seq"] / median * 1e3,
         launches=run["launches"], peak_memory_bytes=peak,
         drop_shares=run["drop_shares"],
         one_hot_yardstick={"losses": yard["losses"],
                            "step_ms": yard["step_ms"],
                            "loss_rel_to_index": yard_rel,
                            "drop_shares_start": yard["drop_shares"]["start"],
                            "peak_memory_bytes": yard_peak},
         f32_check={"layers": f32.n_layer, "batch": MOE["f32_batch"],
                    "seq": MOE["f32_seq"], **f32_fields},
         tolerance={"one_hot_loss_rel": 1e-6, "f32_loss": "1e-5 relative",
                    "f32_grads": "1e-4 relative norm per parameter",
                    "aux": "finite and > 0.1 at every step"})
    problems = _loss_problems(run["losses"])
    want = cfg.n_layer * MOE["steps"]
    if run["launches"] != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {run['launches']}, want {want} each")
    if not all(math.isfinite(a) and a > 0.1 for a in run["aux"]):
        problems.append(f"aux {run['aux']}")
    if not yard_rel <= 1e-6:
        problems.append(f"one-hot loss {yard['losses'][0]} vs index "
                        f"{run['losses'][0]}")
    if yard["drop_shares"]["start"] != run["drop_shares"]["start"]:
        problems.append("the one-hot dispatch drops other tokens")
    problems += [f"f32 {p}" for p in f32_problems]
    if problems:
        raise AssertionError("moe_train: " + "; ".join(problems))
    return run["launches"], median


# the host ops whose kernels are the MoE dispatch and combine (index_copy,
# index_select and index_add_ in the backward; the embedding lookup is an
# index_select too), and the expert products (the model's only bmm)
INDEX_OPS = ("aten::index_copy", "aten::index_select", "aten::index_add_")
EXPERT_OPS = ("aten::bmm",)


def phase_moe_trace(step_ms):
    """One bf16 step of phase 17's model and batch, last, under the
    profiler: the card's time by class of kernel (each flash kernel, matrix
    products, the rest) and by the host op that launched it (the expert
    products, the MoE dispatch and combine), the flash kernels' device ms
    per launch at the path's shape, and the device's idle share against
    phase 17's host-clock step (``step_ms``)."""
    import gc

    from ray_tpu_torch.models import gpt2, moe_lm
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.tools import moe_runs, timing

    cfg = moe_lm.MoELMConfig()
    batch = gpt2.synthetic_batch(60, MOE["batch"], MOE["seq"],
                                 cfg.vocab_size)
    model, optimizer, step = moe_runs.state(cfg, "cuda", MOE["lr"])
    _zero_launches()
    kernels, per_call = timing.kernel_ms(
        lambda: step(model, optimizer, batch), 1)
    launches = _read_launches()   # two steps: one outside the profiler
    by_op = timing.kernel_ms_by_op(lambda: step(model, optimizer, batch), 1)
    del model, optimizer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    device = sum(kernels.values())
    classes = {**{name: (name,) for name in KERNELS},
               "matmul": MATMUL_KERNELS}
    split = dict.fromkeys(classes, 0.0)
    for k, ms in kernels.items():
        for name, keys in classes.items():
            if any(key in k.lower() for key in keys):
                split[name] += ms
                break
    per_launch = {name: split[name] / cfg.n_layer for name in KERNELS}
    ops = {"expert_products": sum(by_op.get(op, 0.0) for op in EXPERT_OPS),
           "moe_dispatch_combine": sum(by_op.get(op, 0.0)
                                       for op in INDEX_OPS)}
    # the expert products' least time: E*C rows of each MoE block through
    # two products forward and four backward, 2 * rows * D * 4D FLOP each,
    # at the f32 rate (they run in f32)
    D, E = cfg.n_embd, cfg.num_experts
    rows = E * moe.expert_capacity(MOE["batch"] * MOE["seq"], E,
                                   cfg.capacity_factor)
    blocks = sum(map(cfg.is_moe, range(cfg.n_layer)))
    expert_bound_ms = (blocks * 6 * 2 * rows * D * 4 * D / F32_FLOPS_PER_S
                       * 1e3)
    emit("moe_trace", config="MoELMConfig()", batch=MOE["batch"],
         seq=MOE["seq"], host_step_ms=step_ms, device_ms=device,
         idle_share=1 - device / step_ms, kernels_per_step=per_call,
         device_ms_by_class={**split, "other": device - sum(split.values())},
         device_ms_by_op=ops, expert_products_bound_ms=expert_bound_ms,
         ops={"expert_products": EXPERT_OPS,
                                   "moe_dispatch_combine": INDEX_OPS},
         top_ops=[[op, ms] for op, ms in list(by_op.items())[:14]],
         flash_device_ms_per_launch=per_launch,
         flash_shape={"bh": MOE["batch"] * cfg.n_head, "s": MOE["seq"],
                      "d": cfg.n_embd // cfg.n_head, "causal": True,
                      "dtype": "bfloat16"},
         launches_two_steps=launches,
         top_kernels=[[k[:90], ms] for k, ms in list(kernels.items())[:14]],
         note="the profiler's kernel durations of one step against phase "
              "17's median host-clock step")
    if launches != dict.fromkeys(KERNELS, 2 * cfg.n_layer):
        raise AssertionError(f"moe_trace: launches {launches}")


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


# the aten op through which SDPA dispatches to each of its backends
SDPA_OPS = {"flash": "_scaled_dot_product_flash_attention",
            "efficient": "_scaled_dot_product_efficient_attention",
            "cuDNN": "_scaled_dot_product_cudnn_attention",
            "math": "_scaled_dot_product_attention_math"}


def _sdpa_error(out, ref):
    """SDPA's own output against the plain reference ``ref``, at the bf16
    limit: its max abs error and largest share of the limit."""
    _, err, share = _close(out.detach().reshape(ref.shape).float(), ref,
                           *TOLS[torch.bfloat16])
    return {"library_max_abs_err": err, "library_err_share_of_limit": share}


def _sdpa_profile(fn, suffix=""):
    """From the profiler, over 20 calls of the SDPA call ``fn``: the backend
    it dispatched to (the aten op, + ``suffix``), its CUDA kernels and their
    device time per call."""
    from ray_tpu_torch.tools import timing

    ops, kernels, device_ms = timing.profile_calls(fn, 20)
    ran = [b for b, op in SDPA_OPS.items() if any(op + suffix in x
                                                   for x in ops)]
    return {"library_backend": ",".join(ran) or "not measured",
            "library_kernels": kernels[:6], "library_device_ms": device_ms}


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


def _fwd_shape_entry(launches, path, bh, sq, sk, d, seed, k_len=None):
    """flash_fwd at one shape of a serving path (causal, bf16; with a live
    length ``k_len`` over Sk rows where the path gives one): (entry, a
    function giving the entry's profiler fields, to run after every
    CUDA-event timing)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    live = sk if k_len is None else k_len
    if sq not in (1, live):
        raise ValueError(f"no SDPA yardstick for causal Sq {sq} < {live}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for s in (sq, sk, sk))
    dev_len = None if k_len is None else torch.tensor(
        k_len, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, k_len=dev_len)
    scale = d ** -0.5
    out, _ = attn.flash_attention_fwd(q, k, v, **kw)
    ref, _ = attn._flash_plain(q.float(), k.float(), v.float(),
                               sm_scale=scale, **kw)
    ok, err, share = _close(out.float(), ref, *TOLS[torch.bfloat16])
    fwd = lambda: attn.flash_attention_fwd(q, k, v, **kw)
    ms = timing.time_ms(fwd, 100)
    plain_ms = timing.time_ms(lambda: attn._flash_plain(
        q, k, v, sm_scale=scale, **kw), 20)
    # SDPA over the live rows (a view of the same k and v): its is_causal
    # aligns top-left, the kernel bottom-right, the same mask at Sq = live;
    # at Sq = 1 the one query sees every live key, so SDPA runs without a
    # mask there
    q4, k4, v4 = (t[None] for t in (q, k[:, :live], v[:, :live]))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=sq == live)
    library_ms = timing.time_ms(sdpa, 100)
    sdpa_error = _sdpa_error(sdpa(), ref)
    profile = lambda: {"device_ms": timing.device_ms(fwd),
                       **_sdpa_profile(sdpa)}
    # q and the live rows of k and v read once, out (bf16) and lse (f32)
    # written once; QK^T and PV over the live pairs
    nbytes = (2 * sq + 2 * live) * bh * d * 2 + bh * sq * 4
    flops = 4 * _live_pairs(bh, sq, live, True) * d
    if not ok:
        raise AssertionError(f"flash_fwd at the {path} shape: error {err}, "
                             f"{share} of its limit")
    return _entry("flash_fwd", launches, err, ms, plain_ms,
                  _bound(nbytes, flops), library_ms, flops,
                  attn.fwd_design(torch.bfloat16), path=path,
                  tolerance=_tol_fields(torch.bfloat16),
                  err_share_of_limit=share, library="torch SDPA forward",
                  **sdpa_error,
                  shape={"bh": bh, "sq": sq, "sk": sk, "k_len": k_len,
                         "d": d, "causal": True, "dtype": "bfloat16"}), profile


def _train_shape_entries(launches, step_ms, path, b, h, s, d, n_layer,
                         seed, causal=True):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at the shape a training
    path gives them (batch b x h heads, seq s, head dim d, causal or not,
    bf16):
    (entries, attention's share of the step of ``n_layer`` layers, a
    function giving each entry's profiler fields by name, to run after
    every CUDA-event timing)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    bh, n = b * h, b * h * s * d
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale)
    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
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
    del f32, pairs, ref_dq, ref_dk, ref_dv, dq, dk, dv, again, first

    ms = {"flash_fwd": timing.time_ms(lambda: attn.flash_attention_fwd(
              q, k, v, causal=causal), 20),
          "flash_bwd_dq": timing.time_ms(lambda: attn._flash_bwd_dq_kernel(
              q, k, v, do, lse, delta, **kw), 10),
          "flash_bwd_dkv": timing.time_ms(lambda: attn._flash_bwd_dkv_kernel(
              q, k, v, do, lse, delta, **kw), 10)}
    delta_ms = timing.time_ms(lambda: attn._delta(out, do), 20)
    plain_ms = {"flash_fwd": timing.time_ms(lambda: attn._flash_plain(
                    q, k, v, **kw), 3),
                "flash_bwd_dq": timing.time_ms(lambda: attn._bwd_dq_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3),
                "flash_bwd_dkv": timing.time_ms(lambda: attn._bwd_dkv_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3)}
    # yardsticks: SDPA's forward, and its backward as (forward + backward)
    # minus forward, both with grad enabled
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(b, h, s, d)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4)
    sdpa_error = _sdpa_error(sdpa(), ref_out)
    del ref_out
    sdpa_fwd_ms = timing.time_ms(sdpa, 20)
    sdpa_bwd_ms = timing.time_ms(sdpa_fwd_bwd, 20) - sdpa_fwd_ms

    def profile():
        fwd = _sdpa_profile(sdpa)
        bwd = _sdpa_profile(sdpa_fwd_bwd, "_backward")
        if None not in (fwd["library_device_ms"], bwd["library_device_ms"]):
            bwd["library_device_ms"] -= fwd["library_device_ms"]
        flash_ms = timing.device_ms(lambda: attn.flash_attention_fwd(
            q, k, v, causal=causal))
        dq_ms = timing.device_ms(lambda: attn._flash_bwd_dq_kernel(
            q, k, v, do, lse, delta, **kw))
        dkv_ms = timing.device_ms(lambda: attn._flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta, **kw))
        return {"flash_fwd": {"device_ms": flash_ms, **fwd},
                "flash_bwd_dq": {"device_ms": dq_ms, **bwd},
                "flash_bwd_dkv": {"device_ms": dkv_ms, **bwd}}

    live = _live_pairs(bh, s, s, causal)
    stats = bh * s * 4   # one f32 per row: lse or delta
    flops = {"flash_fwd": 4 * live * d, "flash_bwd_dq": 6 * live * d,
             "flash_bwd_dkv": 8 * live * d}
    nbytes = {"flash_fwd": 4 * n * 2 + stats,
              "flash_bwd_dq": 5 * n * 2 + 2 * stats,
              "flash_bwd_dkv": 6 * n * 2 + 2 * stats}
    bounds = {name: _bound(nbytes[name], flops[name]) for name in KERNELS}
    design = {"flash_fwd": attn.fwd_design(torch.bfloat16),
              "flash_bwd_dq": attn.bwd_design(torch.bfloat16),
              "flash_bwd_dkv": attn.bwd_design(torch.bfloat16)}
    bwd_vs_sdpa = (ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]) / sdpa_bwd_ms
    extra = {name: {"bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
                    "same_bits_twice": same}
             for name, same in same_bits.items()}
    extra["flash_fwd"] = sdpa_error
    library = {"flash_fwd": (sdpa_fwd_ms, "torch SDPA forward"),
               "flash_bwd_dq": (sdpa_bwd_ms, "torch SDPA backward (dq, dk "
                                "and dv together)"),
               "flash_bwd_dkv": (sdpa_bwd_ms, "torch SDPA backward (dq, dk "
                                 "and dv together)")}
    shape = {"bh": bh, "s": s, "d": d, "causal": causal, "dtype": "bfloat16"}
    entries = [_entry(name, launches[name], errs[name],
                      ms[name], plain_ms[name], bounds[name],
                      library[name][0], flops[name], design[name],
                      path=path, tolerance=_tol_fields(torch.bfloat16),
                      err_share_of_limit=shares[name],
                      library=library[name][1], shape=shape,
                      **extra.get(name, {}))
               for name in KERNELS]
    attn_ms = (sum(ms.values()) + delta_ms) * n_layer
    share = {"path": path, "attention_ms_per_step": attn_ms,
             "step_ms": step_ms, "share": attn_ms / step_ms,
             "delta_ms": delta_ms, "bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
             "note": f"estimate: kernel ms at this shape x {n_layer} layers "
                     "/ step ms, not a trace"}
    bad = [name for name, hs in held.items() if not all(h[0] for h in hs)]
    if bad:
        raise AssertionError(f"at the {path} shape {bad} disagree with "
                             f"their plain versions: {errs}, {shares} of "
                             "their limits")
    if not all(same_bits.values()):
        raise AssertionError(f"a second launch gave other bits: {same_bits}")
    return entries, share, profile


def phase_kernels(serve_launches, train_launches, step_ms, llama_serve,
                  llama_train, vit_train, moe_train):
    """Every kernel at the shapes of every path: GPT-2's serving and
    training shapes, Llama-2-7B's prefill and decode shapes (the whole
    cache of 544 rows with the live length the path gives: 512 in the
    prefill, 543 in the last decode step) and its training shape,
    ViT-B/16's training shape (non-causal, S 197) and the MoE LM's (GPT-2's
    training shape, with the MoE path's launches and step)."""
    cache = LLAMA_SERVE["prompt"] + LLAMA_SERVE["new_tokens"]
    entries, profiles, shares = [], [], []
    for launches, path, bh, sq, sk, d, seed, k_len in (
            (serve_launches["flash_fwd"], "serve", 12, 512, 512, 64, 3,
             None),
            (llama_serve["prefill_launches"], "llama_prefill", 128,
             LLAMA_SERVE["prompt"], cache, 128, 6, LLAMA_SERVE["prompt"]),
            (llama_serve["decode_launches"], "llama_decode", 128, 1, cache,
             128, 7, cache - 1)):
        entry, profile = _fwd_shape_entry(launches, path, bh, sq, sk, d, seed,
                                          k_len)
        entries.append(entry)
        profiles.append(lambda e=entry, p=profile: e.update(p()))
    for launches, ms, path, b, h, s, d, n_layer, seed, causal in (
            (train_launches, step_ms, "train", 16, 12, 1024, 64, 12, 5,
             True),
            (llama_train[0], llama_train[1], "llama_train",
             LLAMA_TRAIN["batch"], 32, LLAMA_TRAIN["seq"], 128,
             LLAMA_TRAIN["layers"], 8, True),
            (vit_train[0], vit_train[1], "vit_train", VIT["batch"], 12, 197,
             64, 12, 9, False),
            (moe_train[0], moe_train[1], "moe_train", MOE["batch"], 12,
             MOE["seq"], 64, 12, 10, True)):
        group, share, profile = _train_shape_entries(
            launches, ms, path, b, h, s, d, n_layer, seed, causal)
        entries += group
        shares.append(share)

        def update(group=group, profile=profile):
            fields = profile()
            for e in group:
                e.update(fields[e["name"]])
        profiles.append(update)
    # the profiler runs last: once it has run, every launch costs the host
    # more, which would weigh on the CUDA-event times of many-launch calls
    # such as SDPA's forward + backward
    for update in profiles:
        update()
    for share in shares:
        emit("attention_share", **share)
    print(json.dumps({"kernels": entries}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import ray_tpu_torch.ops.attention  # noqa: F401  (fails outside the repo)

    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    timed("kernel_vs_plain", phase_kernel_vs_plain)
    timed("bwd_kernel_vs_plain", phase_bwd_kernel_vs_plain)
    timed("serve_f32", phase_serve_f32)
    serve_launches = timed("serve_bf16", phase_serve_bf16)
    timed("train_f32", phase_train_f32)
    train_launches, step_ms = timed("train_bf16", phase_train_bf16)
    from ray_tpu_torch.models.llama import LlamaConfig

    timed("llama_f32", phase_llama_f32)
    llama_serve = timed("llama_serve_7b", phase_llama_serve, "llama2_7b",
                        LlamaConfig.llama2_7b(), 20)
    timed("llama_serve_8b", phase_llama_serve, "llama3_8b",
          LlamaConfig.llama3_8b(), 30)
    llama_train = timed("llama_train", phase_llama_train)
    vit_train = timed("vit_train", phase_vit)
    timed("resnet_train", phase_resnet)
    moe_train = timed("moe_train", phase_moe_train)
    timed("kernels", phase_kernels, serve_launches, train_launches, step_ms,
          llama_serve, llama_train, vit_train, moe_train)
    timed("llama_trace", phase_llama_trace, llama_serve)
    timed("moe_trace", phase_moe_trace, moe_train[1])
    emit("seconds", **seconds)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
