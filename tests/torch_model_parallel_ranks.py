"""One rank of the model-parallel checks of
``tests/test_torch_ring_attention.py``, ``test_torch_pipeline.py``,
``test_torch_tp.py`` and ``test_torch_moe_lm_ep.py``.

    python tests/torch_model_parallel_ranks.py RANK WORLD PORT IN.npz OUT_DIR

Imports torch, numpy and ``ray_tpu_torch`` only (the test process runs
JAX). Ranks form one gloo process group at ``tcp://localhost:PORT`` and run
every case of ``IN.npz``'s ``cases`` (JSON) in order, each reading its
arrays as ``<case>/<key>`` and writing ``OUT_DIR/<case>.rank<r>.npz``. Each
case builds its mesh from its ``axes``:

- ``ring``: ``ring_self_attention`` of the global q, k, v over ``sp`` and
  the backward of sum(out * w): the output and this rank's chunk of each
  gradient (and the largest gradient outside it, which must be 0).
- ``pipeline``: ``build_pipeline_fn`` of tanh(x @ w + b) stages over
  ``pipeline`` on the microbatches ``mb``, and the backward of sum(y *
  wt): the output and this rank's stage's gradients. With
  ``sum_backward``, the outputs are replicated by an all-reduce whose
  backward sums the cotangent (``torch.distributed.nn``'s) in place of
  ``psum_replicated``.
- ``gpt2_sp``, ``gpt2_tp``, ``gpt2_pp``: GPT-2 ``small_test`` in f32 from
  the bridged weights, ``steps`` steps of ``build_train_step_sp``,
  ``shard_train_state_tp`` + ``build_train_step(mesh=)`` or
  ``build_train_step_pp`` on the global batch: the losses and this rank's
  parameters after the steps.
- ``llama_tp``: Llama ``small_test`` in f32 placed by ``shard_params_tp``
  and ``apply_tp_plan``: the logits of ``ids`` and ``generate``'s greedy
  tokens; and whether the plan refuses ``n_kv_head`` 1 over the axis.
- ``moe_ep``: the MoE LM through ``shard_train_state_ep`` and
  ``build_train_step``: each step's (loss, lm, aux) and the parameters.
- ``moe_ep_axis``: ``MoELMConfig(ep_axis="ep")`` with ``shard_experts``,
  forward on this rank's block of ``ids`` over (data, ep): the logits and
  each MoE block's aux.
- ``moe_rows``: ``ops.moe.moe_ffn_ep_global`` of this rank's block of
  ``x`` over (data, ep), routed over (data, ep), its experts' slice of the
  ``params`` over ep: the output, aux and the rows each expert FFN ran.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ray_tpu_torch import parallel  # noqa: E402
from ray_tpu_torch.models import gpt2, llama, moe_lm  # noqa: E402
from ray_tpu_torch.ops import ring_self_attention  # noqa: E402


def _np(t):
    """A copy: a CPU f32 tensor's ``.numpy()`` shares its memory."""
    return np.array(t.detach().float().cpu().numpy())


def ring(case, arr, mesh):
    q, k, v = (torch.from_numpy(arr(x)).requires_grad_() for x in "qkv")
    out = ring_self_attention(q, k, v, mesh, causal=case["causal"])
    (out * torch.from_numpy(arr("w"))).sum().backward()
    n, me = mesh.size(0), mesh.get_local_rank("sp")
    s = q.shape[-2] // n
    res = {"out": _np(out)}
    for name, t in (("dq", q), ("dk", k), ("dv", v)):
        g = t.grad.clone()
        res[name] = _np(g[..., me * s:(me + 1) * s, :])
        g[..., me * s:(me + 1) * s, :] = 0
        res[f"{name}_outside"] = np.asarray(float(g.abs().max()))
    return res


def pipeline(case, arr, mesh):
    stacked = {k: torch.from_numpy(arr(k)).requires_grad_()
               for k in ("w", "b")}
    fn = parallel.build_pipeline_fn(
        lambda p, x: torch.tanh(x @ p["w"] + p["b"]), mesh)
    replicate = parallel.collectives.psum_replicated
    if case.get("sum_backward"):
        # the mistake the trouble spot names: an all-reduce whose backward
        # sums the cotangent over the ranks
        from torch.distributed.nn.functional import all_reduce

        parallel.collectives.psum_replicated = \
            lambda x, group: all_reduce(x, group=group)
    try:
        y = fn(stacked, torch.from_numpy(arr("mb")))
        (y * torch.from_numpy(arr("wt"))).sum().backward()
    finally:
        parallel.collectives.psum_replicated = replicate
    me = mesh.get_local_rank("pipeline")
    return {"y": _np(y), "gw": _np(stacked["w"].grad[me]),
            "gb": _np(stacked["b"].grad[me])}


def _weights(arr, case, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(v)
            for k, v in arr.all(prefix).items()}


def _batch(arr):
    return {k[len("batch/"):]: torch.from_numpy(v)
            for k, v in arr.all("batch").items()}


def _gpt2_cfg(case, **kw):
    return gpt2.GPT2Config.small_test(dtype=torch.float32, **case["model"],
                                      **kw)


def _train(step, model, optimizer, batch, steps):
    losses = []
    for _ in range(steps):
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(float(loss))
    return np.asarray(losses)


def _params(model, strip=("module.", "model.")):
    out = {}
    for name, p in model.named_parameters():
        for prefix in strip:
            name = name[len(prefix):] if name.startswith(prefix) else name
        out[f"p/{name}"] = _np(p)
    return out


def gpt2_sp(case, arr, mesh):
    model, optimizer = gpt2.make_train_state(
        _gpt2_cfg(case, attention="ring"), device="cpu")
    model.load_state_dict(_weights(arr, case, "w"))
    step = gpt2.build_train_step_sp(model, optimizer, mesh)
    losses = _train(step, model, optimizer, _batch(arr), case["steps"])
    return {"losses": losses, **_params(model)}


def gpt2_tp(case, arr, mesh):
    model, optimizer = gpt2.make_train_state(
        _gpt2_cfg(case, attention="flash"), device="cpu")
    model.load_state_dict(_weights(arr, case, "w"))
    wrapped, optimizer = gpt2.shard_train_state_tp(model, optimizer, mesh)
    step = gpt2.build_train_step(wrapped, optimizer, mesh=mesh)
    losses = _train(step, wrapped, optimizer,
                    gpt2.shard_batch(_batch(arr), mesh), case["steps"])
    return {"losses": losses, **_params(model)}


def gpt2_pp(case, arr, mesh):
    cfg = _gpt2_cfg(case, attention="flash")
    n = mesh.size(mesh.mesh_dim_names.index("pipeline"))
    model, optimizer = gpt2.make_pipeline_train_state(cfg, n_stages=n,
                                                      device="cpu")
    model.load_state_dict(_weights(arr, case, "pp"))
    model, optimizer = gpt2.shard_pipeline_state(model, optimizer, mesh)
    step = gpt2.build_train_step_pp(model, optimizer, mesh,
                                    n_microbatches=case["microbatches"])
    losses = _train(step, model, optimizer, _batch(arr), case["steps"])
    return {"losses": losses, **_params(model)}


def llama_tp(case, arr, mesh):
    cfg = llama.LlamaConfig.small_test(dtype=torch.float32)
    model = llama.init_params(cfg, device="cpu")
    model.load_state_dict(_weights(arr, case, "lw"))
    plan = llama.shard_params_tp(model, mesh)
    parallel.apply_tp_plan(model, plan, mesh)
    ids = torch.from_numpy(arr("ids"))
    with torch.no_grad():
        logits, _ = model(ids)
    tokens = llama.generate(model, ids, case["new_tokens"])
    gqa = llama.init_params(dataclasses.replace(cfg, n_kv_head=1),
                            device="cpu")
    try:
        llama.shard_params_tp(gqa, mesh)
        refused = False
    except ValueError:
        refused = True
    return {"logits": _np(logits), "tokens": tokens.numpy(),
            "gqa_refused": np.asarray(refused),
            "k_proj_rows": np.asarray(model.h[0].attn.k_proj.weight.shape[0])}


def _moe_cfg(**kw):
    return moe_lm.MoELMConfig.small_test(**kw)


def moe_ep(case, arr, mesh):
    model, optimizer = moe_lm.make_train_state(_moe_cfg(), device="cpu")
    model.load_state_dict(_weights(arr, case, "mw"))
    model, optimizer, place = moe_lm.shard_train_state_ep(model, optimizer,
                                                          mesh)
    step = moe_lm.build_train_step(model, optimizer)
    batch = place(_batch(arr))
    rows = []
    for _ in range(case["steps"]):
        model, optimizer, loss, lm, aux = step(model, optimizer, batch)
        rows.append([float(loss), float(lm), float(aux)])
    return {"metrics": np.asarray(rows), **_params(model)}


def moe_ep_axis(case, arr, mesh):
    model = moe_lm.init_params(_moe_cfg(ep_axis="ep"), device="cpu")
    model.load_state_dict(_weights(arr, case, "mw"))
    moe_lm.shard_experts(model, mesh)
    ids = torch.from_numpy(arr("ids"))
    i, n = parallel.shard_index(mesh, ("data", "ep"))
    b = ids.shape[0] // n
    with torch.no_grad():
        logits, aux = model(ids[i * b:(i + 1) * b])
    return {"logits": _np(logits), "aux": np.asarray([float(a) for a in aux])}


def moe_rows(case, arr, mesh):
    from ray_tpu_torch.ops import moe

    ffn, rows = moe.expert_ffn, []

    def counted(wi, wo, x):
        rows.append(x.shape[0] * x.shape[1])
        return ffn(wi, wo, x)

    e, n_ep = parallel.shard_index(mesh, ("ep",))
    params = {k: torch.from_numpy(v) for k, v in arr.all("params").items()}
    part = params["params/wi"].shape[0] // n_ep
    params = {k[len("params/"):]: v[e * part:(e + 1) * part]
              if k != "params/router" else v for k, v in params.items()}
    x = torch.from_numpy(arr("x"))
    i, n = parallel.shard_index(mesh, ("data", "ep"))
    b = x.shape[0] // n
    moe.expert_ffn = counted
    try:
        out, aux = moe.moe_ffn_ep_global(
            params, x[i * b:(i + 1) * b], mesh.get_group("ep"),
            parallel.mesh_utils.flat_group(mesh, ("data", "ep")),
            case["capacity_factor"])
    finally:
        moe.expert_ffn = ffn
    return {"out": _np(out), "aux": np.asarray(float(aux)),
            "rows": np.asarray(rows)}


CASES = {f.__name__: f for f in (ring, pipeline, gpt2_sp, gpt2_tp, gpt2_pp,
                                 llama_tp, moe_ep, moe_ep_axis, moe_rows)}


class _Arrays:
    """The case's arrays: ``arr(key)`` is ``<case>/<key>``; ``all(prefix)``
    every ``<case>/<prefix>/...`` by its key after the case's name."""

    def __init__(self, inputs, name):
        self.inputs, self.name = inputs, name

    def __call__(self, key):
        return self.inputs[f"{self.name}/{key}"]

    def all(self, prefix):
        head = f"{self.name}/{prefix}/"
        return {k[len(self.name) + 1:]: v for k, v in self.inputs.items()
                if k.startswith(head)}


def main(rank, world, port, src, out_dir) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        inputs = dict(np.load(src))
        for case in json.loads(str(inputs["cases"])):
            mesh = parallel.create_mesh(case["axes"])
            result = CASES[case["kind"]](case, _Arrays(inputs, case["name"]),
                                         mesh)
            result["jax_imported"] = np.asarray("jax" in sys.modules)
            np.savez(Path(out_dir) / f"{case['name']}.rank{rank}.npz",
                     **result)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, port, src, out_dir = sys.argv[1:]
    main(int(rank), int(world), int(port), src, out_dir)
