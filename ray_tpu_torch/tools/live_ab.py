"""A/B, on one card, of two ways ``flash_fwd`` reads its live key length.

    python3 -m ray_tpu_torch.tools.live_ab [--rounds 2]

Builds ``ops/csrc/flash_fwd.cu`` as it stands (thread 0 reads ``k_len`` and
the CTA takes it from shared memory after a barrier) and a copy in which
every thread reads it itself, both at once. Then, on one card, in the order
per-thread, shared, shared, per-thread in every round, each build's
``flash_fwd`` (bf16, D 128, causal) at the Llama serving shapes it runs
with a live length, the whole cache of 544 rows: the decode (B*H 128, Sq 1,
k_len 543) and the prefill (B*H 128, Sq 512, k_len 512), and the same work
without a live length on the live rows alone (Sk 543, 512), which runs the
build without ``k_len``: its kernel time from the profiler over 50 launches,
and its largest error against the plain version. Prints the card's
``nvidia-smi`` name and power limit, each build's ptxas registers and
spills at D 128, and one JSON line with every reading. Exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SHARED = ("    __shared__ int live;\n"
          "    if (threadIdx.x == 0) live = __ldg(k_len);\n"
          "    __syncthreads();\n"
          "    return min(max(live, 0), sk);\n")
PER_THREAD = "    return min(max(__ldg(k_len), 0), sk);\n"
BUILDS = ("per_thread", "shared")
ORDER = ("per_thread", "shared", "shared", "per_thread")
# (B*H, Sq, cache rows, k_len, D) of the Llama decode and prefill
SHAPES = {"decode": (128, 1, 544, 543, 128),
          "prefill": (128, 512, 544, 512, 128)}


def _libraries(attn, _build):
    """{build: (library, ptxas at D 128)}, the two built at once."""
    from concurrent.futures import ThreadPoolExecutor

    source = attn._SOURCE.read_text()
    if SHARED not in source:
        raise RuntimeError("flash_fwd.cu no longer reads k_len as this A/B "
                           "expects")
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    per_thread = vdir / "flash_fwd_k_len_per_thread.cu"
    per_thread.write_text(source.replace(SHARED, PER_THREAD))
    paths = {"per_thread": per_thread, "shared": attn._SOURCE}
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(paths, pool.map(_build.build, paths.values())))
    libs = {}
    for name, path in paths.items():
        attn._SOURCE, attn._lib = path, None
        ptxas = {k: v for k, v in _build.ptxas_summary(built[name][0]).items()
                 if k.startswith("flash_fwd_mma_kernel/nv_bfloat16/128")}
        libs[name] = (attn._load_kernel(), ptxas)
    attn._SOURCE = paths["shared"]
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("live_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _libraries(attn, _build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for shape, (bh, sq, sk, k_len, d) in SHAPES.items():
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for s in (sq, sk, sk))
        live = torch.tensor(k_len, dtype=torch.int32, device="cuda")
        ref, _ = attn._flash_plain(q.float(), k.float(), v.float(),
                                   causal=True, sm_scale=d ** -0.5,
                                   k_len=live)
        inputs[shape] = (q, k, v, live, k[:, :k_len].contiguous(),
                         v[:, :k_len].contiguous(), ref)
    readings = {name: {} for name in BUILDS}
    for _ in range(args.rounds):
        for name in ORDER:
            attn._lib = libs[name][0]
            for shape, (q, k, v, live, k_live, v_live, ref) in inputs.items():
                out, _ = attn.flash_attention_fwd(q, k, v, causal=True,
                                                  k_len=live)
                err = float((out.float() - ref).abs().max())
                ms = timing.device_ms(lambda: attn.flash_attention_fwd(
                    q, k, v, causal=True, k_len=live), 50)
                ms_rows = timing.device_ms(lambda: attn.flash_attention_fwd(
                    q, k_live, v_live, causal=True), 50)
                r = readings[name].setdefault(shape, {
                    "k_len_device_ms": [], "live_rows_device_ms": [],
                    "max_abs_err": 0.0})
                r["k_len_device_ms"].append(ms)
                r["live_rows_device_ms"].append(ms_rows)
                r["max_abs_err"] = max(r["max_abs_err"], err)
    print(json.dumps({"live_ab": readings,
                      "ptxas": {n: libs[n][1] for n in BUILDS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
