"""The port's predictors (``ray_tpu_torch.train.predictor``) beside the
reference's, on the CPU.

The cases of ``tests/test_predictor.py`` run through both packages on the
same inputs, with ``TorchPredictor`` over an ``nn.Module`` where the
reference has ``JaxPredictor`` over an ``apply_fn``; xgboost is absent
here, so its case runs both packages' ``XGBoostPredictor`` over a stub
module. Then what the port adds: ViT ``small_test`` scored by
``BatchPredictor(TorchPredictor, device="cpu")`` over a Dataset against
``BatchPredictor(JaxPredictor)`` over the JAX ViT with the weights carried
by ``vision_params_from_jax`` (f32; every id once; logits within rtol
1e-4: sums in another order), and
``TorchPredictor`` raising without CUDA. Classes and models are defined
inside the tests so they travel to the actors by value.
"""

import sys
import types

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.train import predictor as jpred
from ray_tpu_torch.train import predictor as tpred


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _linear(w):
    lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    return lin


def test_torch_predictor_roundtrip():
    w = np.array([[2.0], [3.0]], np.float32)
    x = np.array([[1.0, 1.0], [2.0, 0.0]], np.float32)
    cols = {"a": np.array([1.0, 2.0], np.float32),
            "b": np.array([1.0, 0.0], np.float32)}

    ref = jpred.JaxPredictor.from_checkpoint(
        jpred.JaxPredictor.pack(lambda p, x: x @ p["w"], {"w": w}))
    pred = tpred.TorchPredictor.from_checkpoint(
        tpred.TorchPredictor.pack(_linear(w)), device="cpu")
    for batch in (x, cols):
        got = pred.predict(batch)["predictions"]
        want = ref.predict(batch)["predictions"]
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got[:, 0], [5.0, 4.0])
        np.testing.assert_allclose(got, want)


def test_sklearn_predictor_roundtrip():
    from sklearn.linear_model import LinearRegression

    X = np.array([[0.0], [1.0], [2.0]], np.float64)
    y = np.array([1.0, 3.0, 5.0])
    outs = []
    for mod in (jpred, tpred):
        ck = mod.SklearnPredictor.pack(LinearRegression().fit(X, y))
        pred = mod.SklearnPredictor.from_checkpoint(ck)
        outs.append(pred.predict(np.array([[3.0]]))["predictions"])
    assert outs[1][0] == pytest.approx(7.0)
    np.testing.assert_array_equal(outs[0], outs[1])


def _stub_xgboost():
    """xgboost is absent here: a module with the three names the
    predictor uses. The "booster" is a linear model whose raw form is its
    weights' bytes."""
    mod = types.ModuleType("xgboost")

    class DMatrix:
        def __init__(self, x):
            self.x = np.asarray(x, np.float64)

    class Booster:
        def __init__(self, w=None):
            self.w = w

        def save_raw(self):
            return bytearray(self.w.astype(np.float64).tobytes())

        def load_model(self, raw):
            self.w = np.frombuffer(bytes(raw), np.float64).copy()

        def predict(self, dm):
            return 1.0 / (1.0 + np.exp(-(dm.x @ self.w)))

    mod.DMatrix, mod.Booster = DMatrix, Booster
    return mod


def test_xgboost_predictor_roundtrip(monkeypatch):
    xgboost = _stub_xgboost()
    monkeypatch.setitem(sys.modules, "xgboost", xgboost)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    booster = xgboost.Booster(np.array([4.0, 0.1, -0.1]))
    outs = []
    for mod in (jpred, tpred):
        pred = mod.XGBoostPredictor.from_checkpoint(
            mod.XGBoostPredictor.pack(booster))
        outs.append(pred.predict(X[:8])["predictions"])
    acc = ((outs[1] > 0.5) == y[:8]).mean()
    assert acc >= 0.75
    np.testing.assert_array_equal(outs[0], outs[1])


def test_batch_predictor_over_dataset(clusters):
    from ray_tpu_torch import data

    class Scale(torch.nn.Module):
        def __init__(self, s):
            super().__init__()
            self.s = torch.nn.Parameter(torch.tensor(s))

        def forward(self, x):
            return x * self.s

    ck = tpred.TorchPredictor.pack(Scale(10.0))
    bp = tpred.BatchPredictor.from_checkpoint(ck, tpred.TorchPredictor,
                                              device="cpu")
    rows = bp.predict(data.range(64), batch_size=16,
                      concurrency=2).take_all()
    got = sorted(float(np.ravel(r["predictions"])[0]) for r in rows)
    assert got == [float(i * 10) for i in range(64)]

    jck = jpred.JaxPredictor.pack(lambda p, x: x * p["scale"],
                                  {"scale": np.float32(10.0)})
    want = jpred.BatchPredictor.from_checkpoint(
        jck, jpred.JaxPredictor).predict(
            ray_tpu.data.range(64), batch_size=16, concurrency=2).take_all()
    assert [float(r["predictions"]) for r in rows] == \
        [float(r["predictions"]) for r in want]


def test_vit_batch_prediction_matches_the_jax_predictor(clusters):
    import jax
    import jax.numpy as jnp
    import pyarrow as pa

    from ray_tpu.models import vision as jvision
    from ray_tpu_torch import data
    from ray_tpu_torch.models import vision as tvision
    from ray_tpu_torch.models.convert import vision_params_from_jax
    from ray_tpu_torch.tools import data_runs

    jcfg = jvision.ViTConfig.small_test(dtype=jnp.float32)
    jmodel = jvision.ViT(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    net = tvision.build_model(tvision.ViTConfig.small_test(
        dtype=torch.float32))
    net.load_state_dict(vision_params_from_jax(jparams))
    cols = data_runs.vit_image_columns(3, 24, 32)

    class IdTorch(tpred.TorchPredictor):
        def predict(self, batch):
            ids = batch.pop("id")
            return dict(super().predict(batch), id=ids)

    class IdJax(jpred.JaxPredictor):
        def predict(self, batch):
            ids = batch.pop("id")
            return dict(super().predict(batch), id=ids)

    got = tpred.BatchPredictor.from_checkpoint(
        tpred.TorchPredictor.pack(net), IdTorch, device="cpu").predict(
            data.from_blocks(data_runs.image_blocks(cols, 8)),
            batch_size=8).take_batch(100)

    nhwc = cols["image"].transpose(0, 2, 3, 1)
    blocks = [pa.table({
        "image": pa.FixedShapeTensorArray.from_numpy_ndarray(
            np.ascontiguousarray(nhwc[i:i + 8])),
        "id": pa.array(cols["id"][i:i + 8])}) for i in range(0, 24, 8)]
    want = jpred.BatchPredictor.from_checkpoint(
        jpred.JaxPredictor.pack(
            lambda p, x: jmodel.apply({"params": p}, x), jparams),
        IdJax).predict(ray_tpu.data.from_arrow(blocks),
                       batch_size=8).take_batch(100)

    assert sorted(got["id"].tolist()) == list(range(24))
    order = np.argsort(got["id"])
    worder = np.argsort(np.asarray(want["id"]))
    logits = got["predictions"][order]
    ref = np.asarray(want["predictions"])[worder]
    assert logits.shape == (24, 10) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref, rtol=1e-4)


def test_torch_predictor_raises_without_cuda():
    assert not torch.cuda.is_available()
    model = torch.nn.Linear(2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpred.TorchPredictor(model)
    ck = tpred.TorchPredictor.pack(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpred.TorchPredictor.from_checkpoint(ck)
    assert tpred.TorchPredictor.from_checkpoint(
        ck, device="cpu").predict(np.ones((1, 2), np.float32))[
            "predictions"].shape == (1, 1)
