"""A/B, on one card, of the backward kernels' launch bounds.

    python3 -m ray_tpu_torch.tools.launch_bounds_ab [--rounds 3]

Builds ``ops/csrc/flash_bwd.cu`` as it stands (``__launch_bounds__(NT, 1)``:
256 threads, at least 1 CTA per SM) and a copy that gives ptxas the thread
count alone (``__launch_bounds__(NT)``), both at once. Then it times
``flash_bwd_dq`` and ``flash_bwd_dkv`` of each at the training shape of
GPT-2-124M (B*H 192, S 1024, D 64, causal, bf16) with CUDA events, 10
launches after 5 warm-ups, in the order without, with, with, without in
every round, and checks that both builds give the same dq, dk and dv.

Prints the card's ``nvidia-smi`` name and power limit, each build's ptxas
registers and spills, and one JSON line with every reading and each
variant's median. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

WITH_MIN_BLOCKS = "#define BWD_LAUNCH_BOUNDS __launch_bounds__(NT, 1)"
THREADS_ONLY = "#define BWD_LAUNCH_BOUNDS __launch_bounds__(NT)"


def _time_ms(fn, iters=10):
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


def _libraries(attn, _build):
    """{variant: bound library}, both built from the checkout's source."""
    text = attn._BWD_SOURCE.read_text()
    if WITH_MIN_BLOCKS not in text:
        raise RuntimeError(f"{attn._BWD_SOURCE.name} has no line "
                           f"{WITH_MIN_BLOCKS!r}")
    variant = _build.BUILD_DIR / "variants" / "flash_bwd_threads_only.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(text.replace(WITH_MIN_BLOCKS, THREADS_ONLY))
    sources = {"threads_only": variant, "min_blocks_1": attn._BWD_SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources.values())))
    ptxas = {name: {k: v for k, v in _build.ptxas_summary(path).items()
                    if k.endswith("/64")}
             for name, (path, _) in built.items()}
    libs, source = {}, attn._BWD_SOURCE
    try:
        for name, src in sources.items():
            attn._BWD_SOURCE, attn._bwd_lib = src, None
            libs[name] = attn._load_bwd_kernel()
    finally:
        attn._BWD_SOURCE = source
    return libs, ptxas


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_bounds_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, ptxas = _libraries(attn, _build)
    print(json.dumps({"ptxas_d64": ptxas}), flush=True)

    bh, s, d = 192, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    delta = attn._delta(out, do)
    dq = lambda: attn._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dkv = lambda: attn._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)

    grads = {}
    for name, lib in libs.items():
        attn._bwd_lib = lib
        grads[name] = (dq(), *dkv())
    same = all(torch.equal(a, b) for a, b in zip(*grads.values()))

    readings = {name: {"dq": [], "dkv": []} for name in libs}
    for _ in range(args.rounds):
        for name in ("threads_only", "min_blocks_1", "min_blocks_1",
                     "threads_only"):
            attn._bwd_lib = libs[name]
            readings[name]["dq"].append(_time_ms(dq))
            readings[name]["dkv"].append(_time_ms(dkv))
    median = {name: {kernel: statistics.median(ms) for kernel, ms in r.items()}
              for name, r in readings.items()}
    print(json.dumps({"shape": {"bh": bh, "s": s, "d": d, "causal": True,
                                "dtype": "bfloat16"},
                      "outputs_equal": same, "ms": readings,
                      "median_ms": median, "nvidia_smi": smi}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
