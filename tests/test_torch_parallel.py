"""The port's data parallelism against ``ray_tpu``'s, over gloo on the CPU.

``tests/torch_train_dp_ranks.py`` runs as 4 and as 2 gloo processes (torch
only; inputs and outputs as ``.npz`` under a temporary directory, a free
localhost port each, both worlds at once and in the background while the
test process computes the JAX side on the 8 virtual CPU devices of
``tests/conftest.py``, on a mesh of the same axes and size).

- ``parallel.psum``/``pmean``/``all_gather``/``reduce_scatter``/
  ``chunked_psum``/``quantized_psum``/``compiled_allreduce`` against
  ``ray_tpu.parallel.collectives`` under ``shard_map``, from the same numpy
  inputs: exact collectives at rtol 1e-6; the int8 sum within one quantum
  (the largest rank's scale) of the reference's. A flat bucket of leaves
  whose magnitudes differ by orders, reduced with ``segments=`` (a scale
  per leaf, what the DDP hook does), gives each leaf within its own
  quantum of the reference's per-leaf ``quantized_psum``; with one scale
  for the bucket it does not. ``auto_mesh`` lays out the reference's axes,
  sizes and rank positions.
- ``gpt2.build_train_step`` on ``GPT2Config.small_test(n_embd=128)`` in f32
  (wide enough that the MLP's Dense layers reach FSDP's 2^16-element
  threshold and get units of their own), from the JAX weights
  (``params_from_jax``), against ``ray_tpu.models.gpt2.
  build_train_step`` over the same mesh and global batch, 3 AdamW steps,
  ``loss_chunks`` 0 and 4: DP at 4 ranks with modes "", "chunked"
  (``psum_chunks=2``) and "quantized"; HSDP at {"data": 2, "fsdp": 2};
  FSDP2 alone at 2. The port runs the flash attention's plain version, JAX
  its plain attention (the same math). The first step's reduced gradients
  against the reference's (its ``loss_fn`` gradients reduced by its own
  collective under ``shard_map``): within rtol 1e-4 for the exact modes,
  and within one quantum of each leaf (the largest rank's max|g|/127) for
  "quantized". Losses and parameters after the steps within 1e-4 in every
  mode, a ninth of the lr * steps that the steps move a parameter by,
  except the key part of each ``c_attn`` bias: its true gradient is 0,
  both sides reduce rounding noise there and Adam turns the noise's sign
  into +-lr a step, so that slice is held within 2 lr per step (as in
  ``tests/test_torch_train.py``). ``batch_axis`` picks the reduction's
  axis: DDP over a mesh of one ``fsdp`` axis with ``batch_axis="fsdp"``
  against the reference's same step.
- In the test's own process, at a world of one (gloo): ``shard_train_state``
  keeps every param group of the optimizer, with its hyperparameters and
  its state, under DDP and FSDP2, and trains on exactly as the unwrapped
  model does; ``build_train_step`` refuses a ``batch_axis`` that is not
  the one axis the batch is split over, and a mode on an FSDP2 model.
- A 2-rank DP step equals a 1-process step on the whole batch, and a state
  saved with ``save_pytree`` after one step and loaded into a fresh DDP or
  FSDP2 state (``load_pytree``) continues exactly as the uninterrupted run.
"""

import functools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.collectives import shard_map_norep
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_jax

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_train_dp_ranks.py"
TIMEOUT_S = 240
LR, STEPS, GB, T = 3e-4, 3, 8, 32
MODES = ["", "chunked", "quantized"]
LOSS_CHUNKS = [0, 4]
MODEL = {"n_embd": 128}
# a DDP bucket's worth of leaves, magnitudes orders apart (one all zero)
BUCKET = {"sizes": [7, 13, 5, 20, 3], "scales": [1e-4, 1.0, 3e2, 1e-2, 0.0]}
AUTO_MESH = {4: [{"model": 2}, {"data": 1, "fsdp": -1}],
             2: [{}, {"data": 1, "seq": -1}]}


def _train(name, axes, fsdp=False, mode="", loss_chunks=4, kind="train",
           batch_axis="data"):
    return {"kind": kind, "name": name, "axes": axes, "fsdp": fsdp,
            "mode": mode, "chunks": 2, "loss_chunks": loss_chunks,
            "steps": STEPS, "model": MODEL, "batch_axis": batch_axis}


CASES = {
    4: [{"kind": "collectives", "name": "collectives"}]
    + [_train(f"dp_{m or 'default'}_{lc}", {"data": 4}, mode=m,
              loss_chunks=lc) for m in MODES for lc in LOSS_CHUNKS]
    + [_train(f"hsdp_{lc}", {"data": 2, "fsdp": 2}, fsdp=True,
              loss_chunks=lc) for lc in LOSS_CHUNKS],
    2: [{"kind": "collectives", "name": "collectives"}]
    + [_train(f"fsdp_{lc}", {"fsdp": 2}, fsdp=True, loss_chunks=lc)
       for lc in LOSS_CHUNKS]
    + [_train("dp2", {"data": 2}),
       _train("dp_fsdp_axis", {"fsdp": 2}, mode="quantized",
              batch_axis="fsdp"),
       _train("resume_ddp", {"data": 2}, kind="resume"),
       _train("resume_fsdp", {"fsdp": 2}, fsdp=True, kind="resume")],
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_weights():
    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32, **MODEL)
    return jgpt2.init_params(cfg, jax.random.PRNGKey(0))[1]


def _global_batch():
    ids = np.random.default_rng(3).integers(0, 512, size=(GB, T + 1),
                                            dtype=np.int64)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _collective_inputs(world):
    rng = np.random.default_rng(world)
    # each rank's leaf i ~ scales[i], times a factor of its own
    bucket = np.concatenate(
        [rng.normal(size=(world, n)) * sc * rng.uniform(0.5, 2, (world, 1))
         for n, sc in zip(BUCKET["sizes"], BUCKET["scales"])], axis=1)
    return {"x": rng.normal(size=(world, 6, 5)).astype(np.float32),
            "xs": rng.normal(size=(world, 8, 5)).astype(np.float32),
            "bucket": bucket.astype(np.float32),
            "bucket_sizes": np.asarray(BUCKET["sizes"])}


class _Ranks:
    """Both worlds' rank processes, started at once; outputs on demand."""

    def __init__(self, tmp):
        weights = params_from_jax(jax.tree.map(np.asarray, _jax_weights()))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs, self.dirs = {}, {}
        for world, cases in CASES.items():
            d = Path(tmp) / f"w{world}"
            d.mkdir()
            src = d / "inputs.npz"
            np.savez(src, cases=json.dumps(cases), **_global_batch(),
                     auto_mesh=json.dumps(AUTO_MESH[world]),
                     **_collective_inputs(world),
                     **{f"w/{k}": v.numpy() for k, v in weights.items()})
            port = _free_port()
            self.dirs[world] = d
            self.procs[world] = [subprocess.Popen(
                [sys.executable, str(RANKS), str(r), str(world), str(port),
                 str(src), str(d)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(world)]

    def result(self, world, name):
        logs = []
        for p in self.procs[world]:
            try:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0].decode())
            except ValueError:  # already collected
                pass
        for p, log in zip(self.procs[world], logs):
            assert p.returncode == 0, log[-4000:]
        outs = []
        for r in range(world):
            res = dict(np.load(self.dirs[world] / f"{name}.rank{r}.npz"))
            assert not res.pop("jax_imported")
            outs.append(res)
        return outs

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        r = _Ranks(tmp)
        try:
            yield r
        finally:
            r.close()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_collectives(world):
    inputs = _collective_inputs(world)
    mesh = jpar.create_mesh({"data": world},
                            devices=jax.devices()[:world])

    def run(body, x, out_spec):
        fn = shard_map_norep(body, mesh=mesh, in_specs=(P("data"),),
                             out_specs=out_spec)
        glob = jax.device_put(jnp.asarray(x.reshape(-1, *x.shape[2:])),
                              NamedSharding(mesh, P("data")))
        return np.asarray(jax.jit(fn)(glob))

    x, xs = inputs["x"], inputs["xs"]
    per_rank = lambda out: np.split(out, world)  # rank r's block
    leaves = np.split(inputs["bucket"],
                      np.cumsum(BUCKET["sizes"])[:-1], axis=1)
    bucket = {
        name: [np.concatenate(parts) for parts in zip(*[
            per_rank(run(lambda v: jpar.quantized_psum(v, "data", mean=m),
                         leaf, P("data"))) for leaf in leaves])]
        for name, m in (("bucket_psum", False), ("bucket_pmean", True))}
    compiled = jpar.compiled_allreduce(mesh, "data")
    return {**bucket,
        "compiled_allreduce": per_rank(np.asarray(compiled(jax.device_put(
            jnp.asarray(x.reshape(-1, *x.shape[2:])),
            NamedSharding(mesh, P("data")))))),
        "psum": per_rank(run(lambda v: jpar.psum(v, "data"), x, P("data"))),
        "pmean": per_rank(run(lambda v: jpar.pmean(v, "data"), x,
                              P("data"))),
        "all_gather": [run(lambda v: jpar.all_gather(v, "data"), x, P())]
        * world,
        "all_gather_stacked": [run(lambda v: jpar.all_gather(
            v, "data", axis_index=1, tiled=False), x, P())] * world,
        "reduce_scatter": per_rank(run(
            lambda v: jpar.reduce_scatter(v, "data"), xs, P("data"))),
        "chunked_psum": per_rank(run(
            lambda v: jpar.chunked_psum(v, "data", chunks=3), x, P("data"))),
        "quantized_psum": per_rank(run(
            lambda v: jpar.quantized_psum(v, "data"), x, P("data"))),
        "quantized_pmean": per_rank(run(
            lambda v: jpar.quantized_psum(v, "data", mean=True), x,
            P("data"))),
    }


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(ranks, world):
    want = _jax_collectives(world)
    got = ranks.result(world, "collectives")
    x = _collective_inputs(world)["x"]
    quantum = max(np.abs(x[r]).max() / 127.0 for r in range(world))
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["x_after"], x[r])  # out of place
        for name in ("psum", "pmean", "all_gather", "all_gather_stacked",
                     "reduce_scatter", "chunked_psum"):
            np.testing.assert_allclose(res[name], want[name][r], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        for name in ("quantized_psum", "quantized_pmean"):
            assert res[name].dtype == np.float32
            np.testing.assert_allclose(res[name], want[name][r], rtol=0,
                                       atol=quantum, err_msg=name)
        # and the int8 sum really is quantized: not the exact psum
        assert not np.allclose(res["quantized_psum"], res["psum"],
                               rtol=0, atol=1e-6)
        np.testing.assert_allclose(res["compiled_allreduce"],
                                   want["compiled_allreduce"][r], rtol=1e-6,
                                   atol=1e-6)


def _leaf_slices():
    ends = np.cumsum(BUCKET["sizes"])
    return [slice(e - n, e) for n, e in zip(BUCKET["sizes"], ends)]


@pytest.mark.parametrize("world", [2, 4])
def test_bucket_quantized_with_a_scale_per_leaf_matches_jax(ranks, world):
    bucket = _collective_inputs(world)["bucket"]
    want = _jax_collectives(world)
    # one quantum of leaf i: the largest rank's scale of it
    quanta = [np.abs(bucket[:, sl]).max() / 127.0 for sl in _leaf_slices()]
    for r, res in enumerate(ranks.result(world, "collectives")):
        np.testing.assert_array_equal(res["bucket_after"], bucket[r])
        one_scale_misses = 0
        for sl, q in zip(_leaf_slices(), quanta):
            for name in ("bucket_psum", "bucket_pmean"):
                assert res[name].dtype == np.float32
                np.testing.assert_allclose(res[name][sl], want[name][r][sl],
                                           rtol=0, atol=q, err_msg=name)
            # the bucket's one scale is the loud leaf's: a quiet leaf
            # rounds to nothing, far outside its own quantum
            err = np.abs(res["bucket_one_scale"][sl]
                         - want["bucket_psum"][r][sl]).max()
            one_scale_misses += bool(err > world * q)
        assert one_scale_misses >= 2


@pytest.mark.parametrize("world", [2, 4])
def test_auto_mesh_lays_out_the_reference_mesh(ranks, world):
    for r, res in enumerate(ranks.result(world, "collectives")):
        for j, axes in enumerate(AUTO_MESH[world]):
            mesh = jpar.auto_mesh(n_devices=world, **axes)
            ids = np.vectorize(lambda d: d.id)(mesh.devices)
            names, shape, coord = json.loads(str(res[f"auto_mesh_{j}"]))
            assert names == list(mesh.axis_names)
            assert shape == list(ids.shape)
            assert coord == np.argwhere(ids == jax.devices()[r].id)[0] \
                .tolist()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _to_torch(tree):
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _jax_first_grads(model, params, mesh, mode, batch_axis):
    """(the first step's reduced gradients, one quantum of each leaf) as
    the reference's step makes them: ``loss_fn``'s gradients on each shard
    of the batch, reduced by its collective of ``mode`` under shard_map;
    a leaf's quantum is the largest shard's max|g| / 127."""
    split = jpar.data_sharding(mesh).spec[0]
    split = split if isinstance(split, tuple) else (split,)
    n = math.prod(mesh.shape[a] for a in split)
    reduce = {
        "": lambda g: jax.lax.pmean(g, split),
        "chunked": lambda g: jpar.chunked_psum(g, batch_axis, chunks=2) / n,
        "quantized": lambda g: jpar.quantized_psum(g, batch_axis, mean=True),
    }[mode]

    def local(params, batch):
        grads = jax.grad(jgpt2.loss_fn)(params, model, batch)
        amax = jax.tree.map(lambda g: jnp.max(jnp.abs(g))[None], grads)
        return jax.tree.map(reduce, grads), amax

    bspec = P(split)
    fn = shard_map_norep(local, mesh=mesh,
                         in_specs=(P(), {"input_ids": bspec,
                                         "labels": bspec}),
                         out_specs=(P(), P(split)))
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in _global_batch().items()}
    grads, amax = jax.jit(fn)(params, batch)
    quanta = jax.tree.map(lambda g, a: np.full(g.shape, np.max(a) / 127.0,
                                               np.float32), grads, amax)
    return _to_torch(grads), {k: v.max() for k, v in
                              _to_torch(quanta).items()}


def _jax_run(axes, fsdp=False, mode="", loss_chunks=4, batch_axis="data"):
    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32,
                                      loss_chunks=loss_chunks, **MODEL)
    model, params, tx, opt_state = jgpt2.make_train_state(
        cfg, jax.random.PRNGKey(0))
    n = math.prod(axes.values())
    mesh = jpar.create_mesh(axes, devices=jax.devices()[:n])
    grads, quanta = _jax_first_grads(model, params, mesh, mode, batch_axis)
    params, opt_state = jgpt2.shard_train_state(params, opt_state, mesh,
                                                fsdp=fsdp)
    step = jgpt2.build_train_step(model, tx, donate=False, mesh=mesh,
                                  batch_axis=batch_axis, ingraph_psum=mode,
                                  psum_chunks=2)
    batch = jgpt2.shard_batch({k: jnp.asarray(v.astype(np.int32))
                               for k, v in _global_batch().items()}, mesh)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return {"losses": np.asarray(losses), "params": _to_torch(params),
            "grads": grads, "quanta": quanta if mode == "quantized" else None}


def _assert_params(got, want, atol, steps=STEPS):
    assert set(want) <= set(got)
    for name, w in want.items():
        g = got[name]
        if name.endswith("attn.c_attn.bias"):
            c = w.shape[0] // 3
            # the key slice: zero true gradient, +-lr a step from noise
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], rtol=0,
                                       atol=2 * LR * steps, err_msg=name)
            g = np.concatenate([g[:c], g[2 * c:]])
            w = np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def _assert_grads(got, want, quanta):
    """Each reduced gradient against the reference's: within rtol 1e-4
    (exact modes), or within one quantum of its leaf (int8)."""
    assert len(want) == len(got)
    for name, w in want.items():
        g = got[f"grad/{name}"]
        if quanta is None:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=quanta[name],
                                       err_msg=name)


def _check_against_jax(outs, want):
    start = _to_torch(_jax_weights())
    for res in outs:  # every rank reports the global mean loss
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=0,
                                   atol=1e-4)
        _assert_grads({k: v for k, v in res.items()
                       if k.startswith("grad/")}, want["grads"],
                      want["quanta"])
        _assert_params(res, want["params"], 1e-4)
        # the steps moved the parameters by far more than that
        moved = max(np.abs(res[k] - v).max() for k, v in start.items())
        assert moved > STEPS * LR / 2


@pytest.mark.parametrize("loss_chunks", LOSS_CHUNKS)
@pytest.mark.parametrize("mode", MODES)
def test_dp_step_matches_jax_at_4_ranks(ranks, mode, loss_chunks):
    want = _jax_run({"data": 4}, mode=mode, loss_chunks=loss_chunks)
    outs = ranks.result(4, f"dp_{mode or 'default'}_{loss_chunks}")
    _check_against_jax(outs, want)


def test_dp_step_reduces_over_batch_axis_like_jax(ranks):
    want = _jax_run({"fsdp": 2}, mode="quantized", batch_axis="fsdp")
    _check_against_jax(ranks.result(2, "dp_fsdp_axis"), want)


@pytest.mark.parametrize("loss_chunks", LOSS_CHUNKS)
def test_hsdp_step_matches_jax_at_data_2_fsdp_2(ranks, loss_chunks):
    want = _jax_run({"data": 2, "fsdp": 2}, fsdp=True,
                    loss_chunks=loss_chunks)
    _check_against_jax(ranks.result(4, f"hsdp_{loss_chunks}"), want)


@pytest.mark.parametrize("loss_chunks", LOSS_CHUNKS)
def test_fsdp_step_matches_jax_at_2(ranks, loss_chunks):
    want = _jax_run({"fsdp": 2}, fsdp=True, loss_chunks=loss_chunks)
    _check_against_jax(ranks.result(2, f"fsdp_{loss_chunks}"), want)


def test_two_rank_dp_equals_one_process_on_the_whole_batch(ranks):
    model, optimizer = tgpt2.make_train_state(
        tgpt2.GPT2Config.small_test(dtype=torch.float32, attention="flash",
                                    loss_chunks=4, **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       _jax_weights())))
    step = tgpt2.build_train_step(model, optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    losses = []
    for _ in range(STEPS):
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(float(loss))
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for res in ranks.result(2, "dp2"):
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-5)
        _assert_params(res, want, 1e-5)


@pytest.mark.parametrize("kind,plain", [("ddp", "dp2"), ("fsdp", "fsdp_4")])
def test_saved_state_resumes_like_the_uninterrupted_run(ranks, kind, plain):
    uninterrupted = ranks.result(2, plain)
    for res, want in zip(ranks.result(2, f"resume_{kind}"), uninterrupted):
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=0,
                                   atol=1e-6)
        _assert_params(res, {k: v for k, v in want.items()
                             if k != "losses"}, 1e-6)


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _small_state():
    model, optimizer = tgpt2.make_train_state(
        tgpt2.GPT2Config.small_test(dtype=torch.float32, attention="flash",
                                    loss_chunks=4, **MODEL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       _jax_weights())))
    return model, optimizer


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


@pytest.mark.parametrize("fsdp", [False, True])
def test_shard_train_state_keeps_every_param_group(world_of_one, fsdp):
    batch = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    trained = []
    for wrap in (False, True):
        model, _ = _small_state()
        # the usual split: no decay on biases and LayerNorm, own lr there
        flat = [n for n, p in model.named_parameters()
                if p.ndim == 1 or "ln_" in n]
        groups = [
            {"params": [p for n, p in model.named_parameters()
                        if n not in flat]},
            {"params": [p for n, p in model.named_parameters() if n in flat],
             "lr": 1e-3, "weight_decay": 0.0, "amsgrad": True}]
        opt = torch.optim.AdamW(groups, lr=LR, betas=(0.9, 0.95),
                                weight_decay=0.1)
        model, opt, _ = tgpt2.build_train_step(model, opt)(model, opt, batch)
        step_model, step = model, tgpt2.build_train_step(model, opt)
        if wrap:
            name_of = {p: n for n, p in model.named_parameters()}
            before = [({k: v for k, v in g.items() if k != "params"},
                       [name_of[p] for p in g["params"]])
                      for g in opt.param_groups]
            moments = {name_of[p]: st["exp_avg"].clone()
                       for p, st in opt.state.items()}
            mesh = tpar.create_mesh({"fsdp": 1} if fsdp else {"data": 1})
            step_model, opt = tgpt2.shard_train_state(model, opt, mesh,
                                                      fsdp=fsdp)
            name_of = {p: n for n, p in model.named_parameters()}
            after = [({k: v for k, v in g.items() if k != "params"},
                      [name_of[p] for p in g["params"]])
                     for g in opt.param_groups]
            assert after == before
            for p, st in opt.state.items():
                torch.testing.assert_close(_full(st["exp_avg"]),
                                           moments[name_of[p]], rtol=0,
                                           atol=0)
                assert "max_exp_avg_sq" in st or name_of[p] not in flat
            step = tgpt2.build_train_step(step_model, opt, mesh=mesh)
        for _ in range(2):
            step_model, opt, _ = step(step_model, opt, batch)
        trained.append({n: _full(p) for n, p in model.named_parameters()})
    for name, want in trained[0].items():
        torch.testing.assert_close(trained[1][name], want, rtol=0,
                                   atol=1e-6, msg=name)


def test_data_parallel_step_refuses_what_it_cannot_honour(world_of_one):
    model, opt = _small_state()
    with pytest.raises(ValueError, match="not a parameter of the model"):
        tgpt2.shard_train_state(
            model, torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))]),
            tpar.create_mesh({"data": 1}))
    cases = [({"data": 1}, False, "fsdp", "batch_axis 'fsdp'"),
             ({"data": 1, "fsdp": 1}, False, "data", "batch_axis 'data'"),
             ({"fsdp": 1}, True, "fsdp", "DDP communication hook")]
    for axes, fsdp, batch_axis, match in cases:
        model, opt = _small_state()
        mesh = tpar.create_mesh(axes)
        model, opt = tgpt2.shard_train_state(model, opt, mesh, fsdp=fsdp)
        with pytest.raises(ValueError, match=match):
            tgpt2.build_train_step(model, opt, mesh=mesh,
                                   batch_axis=batch_axis,
                                   ingraph_psum="chunked")
    # the axis the batch is split over is taken
    model, opt = _small_state()
    mesh = tpar.create_mesh({"fsdp": 1})
    model, opt = tgpt2.shard_train_state(model, opt, mesh)
    tgpt2.build_train_step(model, opt, mesh=mesh, batch_axis="fsdp",
                           ingraph_psum="quantized")
