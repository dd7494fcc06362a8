"""The port's Switch MoE (``ray_tpu_torch.ops.moe``) against
``ray_tpu.ops.moe`` on the same numpy inputs, in f32.

Gating: the same first maximum and queue positions from an integer
cumulative sum, so ``dispatch`` is equal element by element; ``combine``
(dispatch times the router's probability) within rtol 1e-6, atol 0 (a few
ulps: the softmax takes XLA's exp on one side, PyTorch's on the other) and
aux within 1e-6. ``moe_ffn`` (index
dispatch) against ``jax.value_and_grad`` of the reference's ``moe_ffn``:
rtol 1e-5, atol 1e-6 (the expert products sum in another order). The index
form against the one-hot form (``moe_ffn_dense``, the reference's einsums in
torch): outputs, aux and the expert gradients equal to the bit; the router's
and the input's gradients within rtol 1e-5, atol 1e-7, since the gate's
gradient is a d-long dot product summed inside a GEMM in one form and as a
row sum in the other.

Expert parallelism runs over gloo at 4 processes (data 2 x ep 2), spawned
from ``tests/torch_moe_ep_ranks.py`` with numpy inputs (the ranks import
torch only), each test with its own time limit and a free port; they are
held against the reference's dense ``moe_ffn`` (at rtol 2e-4, atol 2e-5
and, for ``ep_loss_and_grads``, rtol 5e-4, atol 1e-6, as
``tests/test_moe.py`` holds the reference's EP) and, with the aux loss in
the objective, against the reference's own EP on a (2, 2) mesh.
"""

import functools
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel.collectives import shard_map_norep
from ray_tpu_torch.ops import moe as tmoe

REPO = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().parent / "torch_moe_ep_ranks.py"
EP_TIMEOUT_S = 180


def _params(seed, d, h, E):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((d, E)) * d ** -0.5
                       ).astype(np.float32),
            "wi": (rng.standard_normal((E, d, h)) * d ** -0.5
                   ).astype(np.float32),
            "wo": (rng.standard_normal((E, h, d)) * h ** -0.5
                   ).astype(np.float32)}


def _x(seed, T, d):
    return np.random.default_rng(seed).standard_normal(
        (T, d)).astype(np.float32)


def _logits(T, E, skew):
    logits = np.random.default_rng(T + E).standard_normal(
        (T, E)).astype(np.float32)
    logits[:, 0] += skew
    return logits


# (T, E, skew of expert 0): the last sends > 256 tokens to one expert, past
# its capacity of 640, so queue positions beyond a bf16 cumsum's reach
@pytest.mark.parametrize("T,E,skew", [(32, 4, 0.0), (64, 8, 0.0),
                                      (1024, 2, 2.0)])
def test_switch_gating_matches_jax(T, E, skew):
    logits = _logits(T, E, skew)
    C = tmoe.expert_capacity(T, E, 1.25)
    jd, jc, ja = jmoe.switch_gating(jnp.asarray(logits), C)
    td, tc, ta = tmoe.switch_gating(torch.from_numpy(logits), C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    if skew:
        routed = int((logits.argmax(-1) == 0).sum())
        assert routed > C > 256
        assert float(td[:, 0].sum()) == C


def test_queue_positions_hold_past_256_tokens_in_bf16():
    """bf16 logits, 1024 tokens, one expert taking most: every (expert,
    slot) is used at most once and the kept slots of an expert are 0..n-1
    (a bf16 cumulative sum would collide them past 256)."""
    logits = torch.from_numpy(_logits(1024, 2, 3.0)).to(torch.bfloat16)
    dispatch, _, _ = tmoe.switch_gating(logits, 1024)
    assert dispatch.dtype == torch.bfloat16
    per_slot = dispatch.float().sum(0)
    assert float(per_slot.max()) == 1.0
    used = int(per_slot[0].sum())
    assert used > 900 and torch.equal(per_slot[0, :used],
                                      torch.ones(used))


def _jax_capacity(T, E, cf):
    """The capacity the reference's ``moe_ffn`` builds: C of its (E, C, d)
    expert inputs in the traced program (d 5, a width nothing else has)."""
    params = jax.tree.map(jnp.asarray, _params(0, 5, 7, E))
    jaxpr = jax.make_jaxpr(functools.partial(jmoe.moe_ffn,
                                             capacity_factor=cf))(
        params, jnp.zeros((T, 5), jnp.float32))
    shapes = {tuple(v.aval.shape) for eqn in jaxpr.eqns
              for v in eqn.outvars if len(v.aval.shape) == 3}
    caps = {s[1] for s in shapes if s[0] == E and s[2] == 5}
    assert len(caps) == 1, shapes
    return caps.pop()


@pytest.mark.parametrize("cf", [0.05, 0.5, 1.0, 1.25, 1.5, 2.0, 8.0])
def test_capacity_matches_jax(cf):
    # (3, 4) at cf 1.5: int(4.5) = 4 truncates before the ceiling, 1 slot
    # where ceil(4.5 / 4) would give 2
    for T, E in ((1, 1), (3, 4), (7, 3), (64, 8), (100, 8), (1000, 3)):
        assert tmoe.expert_capacity(T, E, cf) == _jax_capacity(T, E, cf), \
            (T, E, cf)
    assert tmoe.expert_capacity(3, 4, 1.5) == 1


def _run(fn, params, x, cf, seed=3):
    """(out, aux, {name: grad}) of sum(out * g) + 0.01 aux."""
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = fn(p, xt, cf)
    g = torch.from_numpy(_x(seed, *x.shape))
    ((out * g).sum() + 0.01 * aux).backward()
    return out.detach(), aux.detach(), {"x": xt.grad,
                                        **{k: v.grad for k, v in p.items()}}


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
def test_index_dispatch_equals_one_hot_dispatch(cf):
    params, x = _params(1, 16, 32, 4), _x(2, 64, 16)
    out, aux, grads = _run(tmoe.moe_ffn, params, x, cf)
    dout, daux, dgrads = _run(tmoe.moe_ffn_dense, params, x, cf)
    assert torch.equal(out, dout) and torch.equal(aux, daux)
    for k in ("wi", "wo"):
        assert torch.equal(grads[k], dgrads[k]), k
    for k in ("x", "router"):
        torch.testing.assert_close(grads[k], dgrads[k], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_moe_ffn_matches_jax_value_and_grad(cf):
    params, x = _params(4, 16, 32, 4), _x(5, 64, 16)
    g = _x(3, 64, 16)

    def objective(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, capacity_factor=cf)
        return (out * g).sum() + 0.01 * aux, out

    (_, jout), jgrads = jax.value_and_grad(objective, argnums=(0, 1),
                                           has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    out, _, grads = _run(tmoe.moe_ffn, params, x, cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    want = {"x": jgrads[1], **jgrads[0]}
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    E = params["router"].shape[1]
    capacity = tmoe.expert_capacity(64, E, cf)
    keep = tmoe.route(torch.from_numpy(x @ params["router"]), capacity)[2]
    if cf < 1:
        assert not keep.all()
    assert float(out[~keep].abs().sum()) == 0.0


def test_switch_gating_invariants():
    """``tests/test_moe.py::test_switch_gating_invariants`` on the port."""
    logits = torch.from_numpy(_x(0, 32, 4))
    dispatch, combine, aux = tmoe.switch_gating(logits, capacity=8)
    assert float(dispatch.sum(dim=(1, 2)).max()) <= 1.0
    assert float(dispatch.sum(dim=(0, 2)).max()) <= 8.0
    assert float(dispatch.sum(dim=0).max()) <= 1.0
    assert np.isfinite(float(aux))
    assert torch.equal(combine, dispatch * combine.amax(dim=(1, 2),
                                                        keepdim=True))
    dispatch_full, _, _ = tmoe.switch_gating(logits, capacity=32)
    assert float(dispatch_full.sum()) == 32.0


def test_moe_dense_forward_and_dropping():
    """``tests/test_moe.py::test_moe_dense_forward_and_dropping`` on the
    port, both dispatches, plus init's scales and device."""
    params = tmoe.init_moe_params(torch.Generator().manual_seed(1),
                                  d_model=16, d_hidden=32, num_experts=4,
                                  device="cpu")
    assert params["wi"].shape == (4, 16, 32)
    assert params["wo"].shape == (4, 32, 16)
    assert params["router"].dtype == torch.float32
    assert abs(float(params["wo"].std()) - 32 ** -0.5) < 0.02
    x = torch.from_numpy(_x(2, 64, 16))
    for fn in (tmoe.moe_ffn, tmoe.moe_ffn_dense):
        out, aux = fn(params, x, capacity_factor=2.0)
        assert out.shape == x.shape
        assert torch.isfinite(out).all() and np.isfinite(float(aux))


def test_init_moe_params_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.init_moe_params(None, 8, 16, 2)


# ------------------------------------------------------ expert parallelism

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ep_ranks(case, inputs, tmp_path, world=4, n_ep=2):
    """Run ``case`` on ``world`` gloo ranks; each rank's outputs."""
    src = tmp_path / "inputs.npz"
    np.savez(src, **inputs)
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), case, str(r), str(world), str(n_ep),
         str(port), str(src), str(outs[r])],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=EP_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = [dict(np.load(o)) for o in outs]
    assert not any(bool(r["jax_imported"]) for r in results)
    return results


def test_moe_ffn_ep_matches_dense_over_gloo(tmp_path):
    """``tests/test_moe.py::test_moe_ep_matches_dense`` over process groups:
    tokens split over the data groups, experts over the EP groups; with a
    capacity factor at which nothing drops, each data shard's output is the
    dense output of its tokens."""
    params, x = _params(3, 16, 32, 8), _x(4, 128, 16)
    dense, _ = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), capacity_factor=8.0)
    ranks = _ep_ranks("ffn", {**params, "x": x, "capacity_factor": 8.0},
                      tmp_path)
    n_ep = 2
    for r, res in enumerate(ranks):
        shard = np.asarray(dense)[(r // n_ep) * 64:(r // n_ep + 1) * 64]
        np.testing.assert_allclose(res["out"], shard, rtol=2e-4, atol=2e-5)
        assert np.isfinite(res["aux"])


def test_ep_loss_and_grads_match_dense_over_gloo(tmp_path):
    """``tests/test_moe.py::test_moe_ep_gradients_match_dense``: tokens
    split over both groups; the summed loss and reduced gradients equal the
    dense gradients of the global mean."""
    params, x = _params(7, 8, 16, 8), _x(8, 64, 8)

    def dense_loss(p):
        out, _ = jmoe.moe_ffn(p, jnp.asarray(x), capacity_factor=8.0)
        return (out ** 2).mean()

    loss, grads = jax.value_and_grad(dense_loss)(
        jax.tree.map(jnp.asarray, params))
    ranks = _ep_ranks("grads", {**params, "x": x, "capacity_factor": 8.0,
                                "aux_coeff": 0.0}, tmp_path)
    for r, res in enumerate(ranks):
        e = r % 2
        np.testing.assert_allclose(res["loss"], float(loss), rtol=5e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(res["router"], np.asarray(grads["router"]),
                                   rtol=5e-4, atol=1e-6)
        for k in ("wi", "wo"):
            np.testing.assert_allclose(
                res[k], np.asarray(grads[k])[e * 4:(e + 1) * 4], rtol=5e-4,
                atol=1e-6, err_msg=k)


def test_ep_gradients_flow_with_aux_as_the_reference_ep(tmp_path):
    """``tests/test_moe.py::test_moe_ep_gradients_flow`` (mean(out^2) + 0.01
    aux at capacity factor 4, tokens split over both groups), held against
    the reference's EP on a (data 2, ep 2) mesh: the same loss and
    gradients, the expert and router gradients nonzero."""
    params, x = _params(5, 8, 16, 8), _x(6, 64, 8)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "ep"))
    specs = {"router": P(), "wi": P("ep"), "wo": P("ep")}

    def body(p, xs):
        def local(pp):
            out, aux = jmoe.moe_ffn_ep(pp, xs, axis="ep", capacity_factor=4.0)
            return (out ** 2).mean() + 0.01 * aux

        return jmoe.ep_loss_and_grads(local, p, "data", "ep")

    fn = jax.jit(shard_map_norep(body, mesh=mesh,
                                 in_specs=(specs, P(("data", "ep"))),
                                 out_specs=(P(), specs)))
    jloss, jgrads = fn(
        {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
         for k, v in params.items()},
        jax.device_put(x, NamedSharding(mesh, P(("data", "ep")))))
    ranks = _ep_ranks("grads", {**params, "x": x, "capacity_factor": 4.0,
                                "aux_coeff": 0.01}, tmp_path)
    for r, res in enumerate(ranks):
        e = r % 2
        np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["router"],
                                   np.asarray(jgrads["router"]), rtol=1e-4,
                                   atol=1e-6)
        for k in ("wi", "wo"):
            np.testing.assert_allclose(
                res[k], np.asarray(jgrads[k])[e * 4:(e + 1) * 4], rtol=1e-4,
                atol=1e-6, err_msg=k)
        assert np.abs(res["wi"]).sum() > 0 and np.abs(res["router"]).sum() > 0
