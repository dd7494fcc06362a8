"""A/B, on one card, of the two designs of the backward kernels.

    python3 -m ray_tpu_torch.tools.bwd_ab [--rounds 3]

Builds ``ops/csrc/flash_bwd.cu`` as it stands (f16 and bf16 on the
tensor-core kernels) and a copy whose marked design line
(``constexpr bool kTensorCores``) sends them to the CUDA-core kernels, both
at once. Then it times ``flash_bwd_dq`` and ``flash_bwd_dkv`` of each at the
training shape of GPT-2-124M (B*H 192, S 1024, D 64, causal, bf16) with CUDA
events, 10 launches after 5 warm-ups, in the order old (CUDA cores), new,
new, old in every round, and holds both designs' dq, dk and dv against the
plain blockwise backward at the bf16 tolerance of ``chip_smoke.py``, element
by element. The two designs round differently, so they are not expected to
agree bit for bit.

Prints the card's ``nvidia-smi`` name and power limit, each build's ptxas
registers and spills at D 64, and one JSON line with every reading, each
design's median and the speedup of the new over the old. Exits 2 without a
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


def _libraries(attn, _build):
    """{design: bound library}, both built from the checkout's source."""
    text = attn._BWD_SOURCE.read_text()
    if TENSOR_CORES not in text:
        raise RuntimeError(f"{attn._BWD_SOURCE.name} has no line "
                           f"{TENSOR_CORES!r}")
    variant = _build.BUILD_DIR / "variants" / "flash_bwd_cuda_cores.cu"
    variant.parent.mkdir(parents=True, exist_ok=True)
    variant.write_text(text.replace(TENSOR_CORES, CUDA_CORES))
    sources = {"cuda_cores": variant, "tensor_cores": attn._BWD_SOURCE}
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


def _share_of_limit(got, ref):
    """Largest |got - ref| / (atol + rtol * |ref|) at the bf16 tolerance;
    at most 1 passes, a NaN fails."""
    err = (got.float() - ref).abs()
    return float((err / (BF16_ATOL + BF16_RTOL * ref.abs())).max())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools.timing import time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs, ptxas = _libraries(attn, _build)
    # what each library runs bf16 on, read back from the library itself
    bf16 = attn._DTYPE_CODES[torch.bfloat16]
    design = {name: "mma.sync" if lib.flash_bwd_tensor_cores(bf16)
              else "cuda-core f32" for name, lib in libs.items()}
    print(json.dumps({"design": design, "ptxas_d64": ptxas}), flush=True)

    bh, s, d = 192, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, sm_scale=d ** -0.5)
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    delta = attn._delta(out, do)
    dq = lambda: attn._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dkv = lambda: attn._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)

    f32 = [t.float() for t in (q, k, v, do)]
    ref = (attn._bwd_dq_plain(*f32, lse, delta, block_q=64, block_k=64, **kw),
           *attn._bwd_dkv_plain(*f32, lse, delta, block_q=64, block_k=64,
                                **kw))
    del f32
    shares = {}
    for name, lib in libs.items():
        attn._bwd_lib = lib
        got = (dq(), *dkv())
        shares[name] = dict(zip(("dq", "dk", "dv"),
                                (_share_of_limit(g, r)
                                 for g, r in zip(got, ref))))
    del ref, got
    agree = all(x <= 1.0 for sh in shares.values() for x in sh.values())
    flipped = design == {"cuda_cores": "cuda-core f32",
                         "tensor_cores": "mma.sync"}

    readings = {name: {"dq": [], "dkv": []} for name in libs}
    for _ in range(args.rounds):
        for name in ("cuda_cores", "tensor_cores", "tensor_cores",
                     "cuda_cores"):
            attn._bwd_lib = libs[name]
            readings[name]["dq"].append(time_ms(dq, 10))
            readings[name]["dkv"].append(time_ms(dkv, 10))
    median = {name: {kernel: statistics.median(ms) for kernel, ms in r.items()}
              for name, r in readings.items()}
    speedup = {kernel: median["cuda_cores"][kernel]
               / median["tensor_cores"][kernel] for kernel in ("dq", "dkv")}
    print(json.dumps({"shape": {"bh": bh, "s": s, "d": d, "causal": True,
                                "dtype": "bfloat16"},
                      "design": design, "share_of_limit": shares,
                      "agree_with_plain": agree,
                      "tolerance": {"atol": BF16_ATOL, "rtol": BF16_RTOL},
                      "ms": readings, "median_ms": median,
                      "speedup": speedup, "nvidia_smi": smi}), flush=True)
    return 0 if agree and flipped else 1


if __name__ == "__main__":
    sys.exit(main())
