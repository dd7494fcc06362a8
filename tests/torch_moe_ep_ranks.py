"""One rank of the expert-parallel checks of ``tests/test_torch_moe.py``.

    python tests/torch_moe_ep_ranks.py CASE RANK WORLD N_EP PORT IN.npz OUT.npz

Imports torch, numpy and ``ray_tpu_torch`` only (the test process runs
JAX). Ranks form a (data, ep) grid, rank = data index * N_EP + ep index,
over gloo at ``tcp://localhost:PORT``; rank r holds experts [e*E_local,
(e+1)*E_local) of ``IN.npz``'s ``wi``/``wo`` (e its ep index) and the
replicated router. Cases:

- ``ffn``: ``moe_ffn_ep`` on this rank's data shard of ``x`` (tokens split
  over the data groups, the same on every rank of an EP group); writes out
  and aux.
- ``grads``: ``ep_loss_and_grads`` of mean(out^2) (+ ``aux_coeff`` * aux)
  on this rank's shard of ``x`` split over both groups; writes the loss and
  the gradients.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ray_tpu_torch.ops import moe  # noqa: E402


def groups(world: int, n_ep: int):
    """(data group, ep group) of this rank; every rank creates every group,
    in the same order."""
    rank, n_data = dist.get_rank(), world // n_ep
    data = ep = None
    for e in range(n_ep):
        g = dist.new_group([d * n_ep + e for d in range(n_data)])
        if rank % n_ep == e:
            data = g
    for d in range(n_data):
        g = dist.new_group([d * n_ep + e for e in range(n_ep)])
        if rank // n_ep == d:
            ep = g
    return data, ep


def main(case, rank, world, n_ep, port, src, dst) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(src))
        data_group, ep_group = groups(world, n_ep)
        e = rank % n_ep
        E_local = inputs["wi"].shape[0] // n_ep
        shard = slice(e * E_local, (e + 1) * E_local)
        params = {"router": torch.from_numpy(inputs["router"]),
                  "wi": torch.from_numpy(inputs["wi"][shard].copy()),
                  "wo": torch.from_numpy(inputs["wo"][shard].copy())}
        cf = float(inputs["capacity_factor"])
        x = torch.from_numpy(inputs["x"])
        if case == "ffn":
            x = x.chunk(world // n_ep)[rank // n_ep]
            out, aux = moe.moe_ffn_ep(params, x, ep_group, cf)
            result = {"out": out.numpy(), "aux": aux.numpy()}
        else:
            x = x.chunk(world)[rank]
            coeff = float(inputs["aux_coeff"])
            params = {k: v.requires_grad_() for k, v in params.items()}

            def local_loss(p):
                out, aux = moe.moe_ffn_ep(p, x, ep_group, cf)
                return (out ** 2).mean() + coeff * aux

            loss, grads = moe.ep_loss_and_grads(local_loss, params,
                                                data_group, ep_group)
            result = {"loss": loss.numpy(),
                      **{k: g.numpy() for k, g in grads.items()}}
        result["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(dst, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, rank, world, n_ep, port, src, dst = sys.argv[1:]
    main(case, int(rank), int(world), int(n_ep), int(port), src, dst)
