"""A/B, on one card, of the two designs of the forward kernel.

    python3 -m ray_tpu_torch.tools.fwd_ab [--rounds 3]

Builds ``ops/csrc/flash_fwd.cu`` as it stands (f16 and bf16 on the
tensor-core kernel) and a copy whose marked design line (``constexpr bool
kTensorCores``) sends f16 and bf16 to the CUDA-core kernel of the first
port, both at once. It holds each build's output and lse against the plain
blockwise forward, at the bf16 tolerance of ``chip_smoke.py`` element by
element and at lse atol 1e-3. Then, on one card, in the order old (CUDA
cores), new, new, old in every round:

1. ``flash_fwd`` of each build at the training shape of GPT-2-124M (B*H 192,
   S 1024, D 64, causal, bf16) and at the serving shape of its 512-token
   prompt (B*H 12, S 512), timed by CUDA events over 20 launches after 5
   warm-ups: the caller's view, host work included;
2. end to end, the training path of ``chip_smoke.py`` phase 8
   (``tools/train_runs.py:train_bf16``) with the old and the new design
   (old, new, new, old): each run's step ms over the 10 timed steps and its
   13 losses. The two designs round P differently, so their loss curves may
   part after a few steps; each repeats its own to the bit;
3. one step's gradients of that model with each design against the same
   step through the plain attention (bf16, batch 4 x 1024 of the same data
   and weights): per design the worst and the median parameter's relative
   error norm, and the designs' gradients against each other. Both designs
   run the same backward kernels, so what parts them is the forward;
4. the launches of 1, timed by the profiler's kernel durations: the card's
   view (at the serving shape the host takes longer per call than the
   tensor-core kernel). This comes last because once the profiler has run,
   each launch costs the host more.

Prints the card's ``nvidia-smi`` name and power limit, each build's ptxas
registers and spills at D 64, and one JSON line with every reading, each
design's median and the speedups of the new over the old. Exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

TENSOR_CORES = "constexpr bool kTensorCores = true;"
CUDA_CORES = "constexpr bool kTensorCores = false;"
# chip_smoke.py's TOLS for bf16: |err| <= atol + rtol * |ref|
BF16_ATOL, BF16_RTOL = 1e-3, 1.6e-2
D = 64
SHAPES = {"train": (192, 1024), "serve": (12, 512)}   # (B*H, S)
DESIGNS = ("cuda_cores", "tensor_cores")
ORDER = ("cuda_cores", "tensor_cores", "tensor_cores", "cuda_cores")
GRAD_BATCH = 4   # sequences of 1024 in the gradient check


def _libraries(attn, _build):
    """{build: bound library}, both built from the checkout's source."""
    text = attn._SOURCE.read_text()
    if TENSOR_CORES not in text:
        raise RuntimeError(f"{attn._SOURCE.name} has no line {TENSOR_CORES!r}")
    variant = _build.BUILD_DIR / "variants" / "flash_fwd_cuda_cores.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(text.replace(TENSOR_CORES, CUDA_CORES))
    sources = {"cuda_cores": variant, "tensor_cores": attn._SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources.values())))
    ptxas = {name: {k: v for k, v in _build.ptxas_summary(path).items()
                    if k.endswith("/64")}
             for name, (path, _) in built.items()}
    libs, source = {}, attn._SOURCE
    try:
        for name, src in sources.items():
            attn._SOURCE, attn._lib = src, None
            libs[name] = attn._load_kernel()
    finally:
        attn._SOURCE = source
    return libs, ptxas


def _share_of_limit(got, ref):
    """Largest |got - ref| / (atol + rtol * |ref|) at the bf16 tolerance;
    at most 1 passes, a NaN fails."""
    err = (got.float() - ref).abs()
    return float((err / (BF16_ATOL + BF16_RTOL * ref.abs())).max())


def _median(xs):
    return None if None in xs else statistics.median(xs)


def _grads_vs_plain(attn, libs, train_runs):
    """One step's gradients with each design and through the plain
    attention, from the same weights and data: {design: relative errors
    against plain}, and the designs against each other."""
    from ray_tpu_torch.models import gpt2

    cfg = train_runs.bf16_config()
    batch = gpt2.synthetic_batch(1, GRAD_BATCH, train_runs.SEQ,
                                 cfg.vocab_size)
    with train_runs.plain_attention():
        plain_loss, plain = train_runs.step_grads(cfg, batch)
    out, grads = {"plain_loss": plain_loss}, {}
    for name in DESIGNS:
        attn._lib = libs[name]
        loss, grads[name] = train_runs.step_grads(cfg, batch)
        out[name] = {"loss": loss,
                     **train_runs.grad_rel_errs(grads[name], plain)}
    out["tensor_vs_cuda_cores"] = train_runs.grad_rel_errs(
        grads["tensor_cores"], grads["cuda_cores"])
    del plain, grads
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import train_runs
    from ray_tpu_torch.tools.timing import device_ms, time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, ptxas = _libraries(attn, _build)
    # what each library runs bf16 on, read back from the library itself
    bf16 = attn._DTYPE_CODES[torch.bfloat16]
    design = {name: "mma.sync" if lib.flash_fwd_tensor_cores(bf16)
              else "cuda-core f32" for name, lib in libs.items()}
    print(json.dumps({"design": design, "ptxas_d64": ptxas}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = {shape: [torch.randn((bh, s, D), generator=gen, device="cuda"
                                  ).to(torch.bfloat16) for _ in range(3)]
              for shape, (bh, s) in SHAPES.items()}
    shares = {name: {} for name in libs}
    for shape, (q, k, v) in inputs.items():
        ref, ref_lse = attn._flash_plain(q.float(), k.float(), v.float(),
                                         causal=True, sm_scale=D ** -0.5)
        for name, lib in libs.items():
            attn._lib = lib
            out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
            shares[name][shape] = {
                "out": _share_of_limit(out, ref),
                "lse_err": float((lse - ref_lse).abs().max())}
    del ref, ref_lse
    agree = all(x["out"] <= 1.0 and x["lse_err"] <= 1e-3
                for sh in shares.values() for x in sh.values())
    expected = {"cuda_cores": "cuda-core f32", "tensor_cores": "mma.sync"}

    readings = {name: {shape: {"ms": [], "device_ms": []} for shape in SHAPES}
                for name in libs}

    def rounds(kind, clock):
        for _ in range(args.rounds):
            for name in ORDER:
                attn._lib = libs[name]
                for shape, (q, k, v) in inputs.items():
                    readings[name][shape][kind].append(clock(
                        lambda: attn.flash_attention_fwd(q, k, v,
                                                         causal=True), 20))

    # every host-clock and CUDA-event reading before the first profiler
    # session: once the profiler has run, each launch costs the host more
    rounds("ms", time_ms)
    train = {name: {"step_ms": [], "losses": []} for name in DESIGNS}
    for name in ORDER:
        attn._lib = libs[name]
        losses, step_ms = train_runs.train_bf16()
        train[name]["step_ms"].append(step_ms)
        train[name]["losses"].append(losses)
    repeats = all(r["losses"][0] == r["losses"][1] for r in train.values())
    grads = _grads_vs_plain(attn, libs, train_runs)
    rounds("device_ms", device_ms)
    median = {name: {shape: {kind: _median(x) for kind, x in r.items()}
                     for shape, r in by_shape.items()}
              for name, by_shape in readings.items()}

    def ratio(shape, kind):
        x = median["cuda_cores"][shape][kind]
        y = median["tensor_cores"][shape][kind]
        return None if x is None or y is None else x / y

    speedup = {shape: {kind: ratio(shape, kind)
                       for kind in ("ms", "device_ms")} for shape in SHAPES}
    print(json.dumps({"shapes": {s: {"bh": bh, "s": n, "d": D,
                                     "causal": True, "dtype": "bfloat16"}
                                 for s, (bh, n) in SHAPES.items()},
                      "design": design, "share_of_limit": shares,
                      "agree_with_plain": agree,
                      "tolerance": {"atol": BF16_ATOL, "rtol": BF16_RTOL,
                                    "lse_atol": 1e-3},
                      "readings": readings, "median": median,
                      "speedup_tensor_over_cuda_cores": speedup,
                      "train_bf16": train,
                      "train_step_speedup": statistics.median(
                          train["cuda_cores"]["step_ms"])
                      / statistics.median(train["tensor_cores"]["step_ms"]),
                      "train_losses_repeat": repeats,
                      "grads_vs_plain": {
                          "step": 1, "batch": [GRAD_BATCH, train_runs.SEQ],
                          "measure": "per parameter ||g - g_plain|| / "
                                     "||g_plain||", **grads},
                      "nvidia_smi": smi}), flush=True)
    return 0 if agree and design == expected and repeats else 1


if __name__ == "__main__":
    sys.exit(main())
