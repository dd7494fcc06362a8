"""One rank of the data-parallel checks of ``tests/test_torch_parallel.py``.

    python tests/torch_train_dp_ranks.py RANK WORLD PORT IN.npz OUT_DIR

Imports torch, numpy and ``ray_tpu_torch`` only (the test process runs
JAX). Ranks form one gloo process group at ``tcp://localhost:PORT`` and run
every case of ``IN.npz``'s ``cases`` (JSON) in order, each writing
``OUT_DIR/<case>.rank<r>.npz``:

- ``collectives``: ``psum``, ``pmean``, ``all_gather``, ``reduce_scatter``,
  ``chunked_psum``, ``quantized_psum`` and ``compiled_allreduce`` over the
  default group, rank r contributing ``x[r]`` (``xs[r]`` for
  reduce_scatter); ``quantized_psum`` of the flat ``bucket[r]`` (leaves of
  ``bucket_sizes``) with a scale per leaf (``segments=``) and with one
  scale; and, for each axes dict of ``auto_mesh`` (JSON), the mesh's axis
  names, sizes and this rank's coordinate.
- ``train``: ``GPT2Config.small_test(**model)`` in f32 (``model``: JSON)
  from the weights ``w/<name>``,
  ``shard_train_state`` on a mesh of ``axes`` (``fsdp`` for FSDP2), then
  ``steps`` of ``build_train_step(mesh=..., batch_axis=...,
  ingraph_psum=mode)`` on each rank's ``shard_batch`` block of the global
  batch; writes the losses, the reduced gradients of the first step
  (``grad/<name>``, full tensors) and the full parameters after the
  steps.
- ``resume``: the same state, 1 step, ``save_pytree`` of the model and the
  optimizer, a fresh wrapped state from other weights, ``load_pytree``, and
  ``steps - 1`` more steps; writes those losses and the parameters.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.checkpoint.state_dict import (  # noqa: E402
    StateDictOptions, get_model_state_dict)
from torch.distributed.tensor import DTensor  # noqa: E402

from ray_tpu_torch import parallel  # noqa: E402
from ray_tpu_torch.air import load_pytree, save_pytree  # noqa: E402
from ray_tpu_torch.models import gpt2  # noqa: E402


def collectives(inputs, rank):
    x = torch.from_numpy(inputs["x"][rank])
    xs = torch.from_numpy(inputs["xs"][rank])
    bucket = torch.from_numpy(inputs["bucket"][rank])
    sizes = inputs["bucket_sizes"].tolist()
    world = parallel.create_mesh({"data": dist.get_world_size()})
    out = {"psum": parallel.psum(x), "pmean": parallel.pmean(x),
           "all_gather": parallel.all_gather(x),
           "all_gather_stacked": parallel.all_gather(x, axis_index=1,
                                                     tiled=False),
           "reduce_scatter": parallel.reduce_scatter(xs),
           "chunked_psum": parallel.chunked_psum(x, chunks=3),
           "quantized_psum": parallel.quantized_psum(x),
           "quantized_pmean": parallel.quantized_psum(x, mean=True),
           "bucket_psum": parallel.quantized_psum(bucket, segments=sizes),
           "bucket_pmean": parallel.quantized_psum(bucket, mean=True,
                                                   segments=sizes),
           "bucket_one_scale": parallel.quantized_psum(bucket),
           "compiled_allreduce": parallel.compiled_allreduce(world)(x),
           "x_after": x, "bucket_after": bucket}
    out = {k: v.numpy() for k, v in out.items()}
    for j, axes in enumerate(json.loads(str(inputs["auto_mesh"]))):
        mesh = parallel.auto_mesh(**axes)
        out[f"auto_mesh_{j}"] = np.asarray(json.dumps(
            [list(mesh.mesh_dim_names), list(mesh.mesh.shape),
             mesh.get_coordinate()]))
    return out


def _bare(name):
    """``name`` in the bare GPT2, without DDP's and LossModel's prefixes."""
    for prefix in ("module.", "model."):
        name = name[len(prefix):] if name.startswith(prefix) else name
    return name


def full_params(model):
    """{name in the bare GPT2: full f32 tensor}, on every rank."""
    sd = get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True))
    return {_bare(n): t.detach().float().cpu().numpy() for n, t in sd.items()}


def full_grads(model):
    """{"grad/<name in the bare GPT2>": the reduced gradient, full}, on
    every rank (FSDP2's sharded gradients are gathered)."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad
        out[f"grad/{_bare(name)}"] = g.detach().float().cpu().numpy()
    return out


def state(case, weights, mesh):
    cfg = gpt2.GPT2Config.small_test(dtype=torch.float32, attention="flash",
                                     loss_chunks=case["loss_chunks"],
                                     **case["model"])
    model, optimizer = gpt2.make_train_state(cfg, device="cpu")
    model.load_state_dict(weights)
    return gpt2.shard_train_state(model, optimizer, mesh, fsdp=case["fsdp"])


def train(case, inputs, weights, out_dir):
    mesh = parallel.create_mesh(case["axes"])
    model, optimizer = state(case, weights, mesh)
    step = gpt2.build_train_step(model, optimizer, mesh=mesh,
                                 batch_axis=case["batch_axis"],
                                 ingraph_psum=case["mode"],
                                 psum_chunks=case["chunks"])
    batch = gpt2.shard_batch({k: torch.from_numpy(inputs[k]) for k in
                              ("input_ids", "labels")}, mesh)
    losses, grads = [], {}
    for i in range(case["steps"]):
        if case["kind"] == "resume" and i == 1:
            # checkpoint, then carry on from a fresh state loaded from it
            ckpt = str(Path(out_dir) / f"ckpt_{case['name']}")  # shared
            save_pytree(model, ckpt, "model")
            save_pytree(optimizer, ckpt, "optimizer", model=model)
            dist.barrier()
            other = {k: v + 1.0 for k, v in weights.items()}
            model, optimizer = state(case, other, mesh)
            step = gpt2.build_train_step(model, optimizer, mesh=mesh)
            load_pytree(ckpt, model, "model")
            load_pytree(ckpt, optimizer, "optimizer", model=model)
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(float(loss))
        if i == 0:
            grads = full_grads(model)
    return {"losses": np.asarray(losses), **grads, **full_params(model)}


def main(rank, world, port, src, out_dir) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(src))
        weights = {k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                   if k.startswith("w/")}
        for case in json.loads(str(inputs["cases"])):
            if case["kind"] == "collectives":
                result = collectives(inputs, rank)
            else:
                result = train(case, inputs, weights, out_dir)
            result["jax_imported"] = np.asarray("jax" in sys.modules)
            np.savez(Path(out_dir) / f"{case['name']}.rank{rank}.npz",
                     **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, port, src, out_dir = sys.argv[1:]
    main(int(rank), int(world), int(port), src, out_dir)
