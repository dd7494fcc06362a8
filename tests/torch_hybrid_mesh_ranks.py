"""One rank of the hybrid-mesh checks of ``tests/test_torch_hybrid_mesh.py``.

    python tests/torch_hybrid_mesh_ranks.py RANK WORLD PORT IN.npz OUT_DIR

Imports torch, numpy and ``ray_tpu_torch`` only (the test process runs
JAX). Ranks form one gloo process group at ``tcp://localhost:PORT`` and
run every case of ``IN.npz``'s ``cases`` (JSON), each writing
``OUT_DIR/<case>.rank<r>.npz``. A ``hybrid`` case builds
``create_hybrid_mesh(ici, dcn)`` over the ranks' own nodes (``devices``
"default": one host, so contiguous blocks) or over rank descriptors whose
node is ``rank % nodes`` ("interleaved"), and writes the mesh's axis names,
its rank array, a psum of ones over the dcn axis, and the loss of one
``build_train_step`` step of ``GPT2Config.small_test`` in f32 from the
weights ``w/<name>`` under ``shard_train_state(fsdp=True)`` on the batch
``input_ids``/``labels``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ray_tpu_torch import parallel  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402


def hybrid(case, inputs, weights):
    world = dist.get_world_size()
    devices = None
    if case["devices"] == "interleaved":
        nodes = case["dcn"]["data"]
        devices = [parallel.RankDevice(r, process_index=r % nodes)
                   for r in range(world)]
    mesh = parallel.create_hybrid_mesh(case["ici"], case["dcn"],
                                       devices=devices)
    nodes = torch.ones(2, 4)
    dist.all_reduce(nodes, group=mesh.get_group("data"))
    cfg = gpt2.GPT2Config.small_test(dtype=torch.float32, attention="flash",
                                     loss_chunks=0)
    model, optimizer = gpt2.make_train_state(cfg, device="cpu")
    model.load_state_dict(weights)
    model, optimizer = gpt2.shard_train_state(model, optimizer, mesh,
                                              fsdp=True)
    step = gpt2.build_train_step(model, optimizer, mesh=mesh)
    batch = gpt2.shard_batch({k: torch.from_numpy(inputs[k]) for k in
                              ("input_ids", "labels")}, mesh)
    _, _, loss = step(model, optimizer, batch)
    return {"names": np.asarray(json.dumps(list(mesh.mesh_dim_names))),
            "ranks": mesh.mesh.numpy(), "dcn_psum": nodes.numpy(),
            "loss": np.asarray(float(loss))}


def main(rank, world, port, src, out_dir) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(src))
        weights = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                   if k.startswith("w/")}
        for case in json.loads(str(inputs["cases"])):
            result = hybrid(case, inputs, weights)
            result["jax_imported"] = np.asarray("jax" in sys.modules)
            np.savez(Path(out_dir) / f"{case['name']}.rank{rank}.npz",
                     **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, port, src, out_dir = sys.argv[1:]
    main(int(rank), int(world), int(port), src, out_dir)
