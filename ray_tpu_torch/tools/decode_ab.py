"""A/B, on one card, of the Llama serving path of two trees of this
repository: the tokens it generates and a decode step's device time.

    python3 -m ray_tpu_torch.tools.decode_ab OTHER_TREE

OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists). In the order other, this, this, other, a fresh process imports the
port from that tree only and, for Llama-2-7B and Llama-3-8B made as
``chip_smoke.py``'s serving phases make them (weights from CUDA generator
seeds 20 and 30, cast for serving; 4 prompts of 512 tokens from numpy seeds
21 and 31; 32 greedy new tokens after one warm-up ``generate``):

1. ``generate``'s tokens, as sha256 of their int64 bytes (the digest those
   phases print as ``tokens_sha256``);
2. under ``torch.profiler``, the card's kernel time of a ``generate`` of 5
   new tokens less that of 1, over 4: one decode step's device ms (steps
   at cache rows 512-515), its ``flash_fwd`` part and its kernels per
   step.

Only ``generate`` and the profiler are called, an interface both trees
share. Prints the card's ``nvidia-smi`` name and power limit, one JSON line
per process and a last JSON line with each tree's readings and whether
every tree generated the same tokens. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

THIS_TREE = Path(__file__).resolve().parents[2]
# (config, weight seed) of chip_smoke.py's serving phases; prompts take
# seed + 1
MODELS = (("llama2_7b", 20), ("llama3_8b", 30))
BATCH, PROMPT, NEW = 4, 512, 32
PROFILED = 5   # new tokens of the profiled generate: 4 decode steps


def _worker() -> dict:
    """One tree's readings; ``ray_tpu_torch`` comes from PYTHONPATH."""
    import hashlib

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import timing

    out = {"tree": str(Path(ray_tpu_torch.__file__).resolve().parents[1])}
    for name, seed in MODELS:
        cfg = getattr(llama.LlamaConfig, name)()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = llama.init_params(cfg, gen, device="cuda")
        llama.cast_for_serving(model, torch.bfloat16)
        ids = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, size=(BATCH, PROMPT))
        prompts = torch.from_numpy(ids).to("cuda")
        llama.generate(model, prompts[:, :16], 2)
        tokens = llama.generate(model, prompts, NEW)
        digest = hashlib.sha256(tokens.to(torch.int64).cpu().numpy()
                                .tobytes()).hexdigest()
        runs = {n: timing.kernel_ms(lambda n=n: llama.generate(
            model, prompts, n)) for n in (1, PROFILED)}
        steps = PROFILED - 1
        total = {n: sum(k.values()) for n, (k, _) in runs.items()}
        flash = {n: sum(ms for kname, ms in k.items() if "flash_fwd" in kname)
                 for n, (k, _) in runs.items()}
        out[name] = {
            "tokens_sha256": digest,
            "decode_step_device_ms": (total[PROFILED] - total[1]) / steps,
            "decode_step_flash_fwd_ms": (flash[PROFILED] - flash[1]) / steps,
            "decode_step_kernels": (runs[PROFILED][1] - runs[1][1]) / steps}
        del model, tokens
        torch.cuda.empty_cache()
    return out


def _run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, __file__, "--worker"], env=env,
                          cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"decode_ab worker for {tree} failed:\n"
                           + proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("other", nargs="?", type=Path)
    parser.add_argument("--worker", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(_worker()), flush=True)
        return 0
    if args.other is None:
        parser.error("give the other tree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {"other": args.other.resolve(), "this": THIS_TREE}
    readings = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        reading = _run(trees[label])
        print(json.dumps({"label": label, **reading}), flush=True)
        readings[label].append(reading)
    same = all(len({r[name]["tokens_sha256"] for rs in readings.values()
                    for r in rs}) == 1 for name, _ in MODELS)
    print(json.dumps({"decode_ab": {
        label: {name: [r[name] for r in rs] for name, _ in MODELS}
        for label, rs in readings.items()},
        "same_tokens": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
