"""ResNet trained through ``datasets=`` on the CPU: the port's
``TorchTrainer`` over ``data_runs.resnet_data_loop`` against the
reference's ``JaxTrainer`` over the JAX ResNet, each fed by its own
package's Data.

``ResNetConfig.small_test`` (CIFAR stem, width 16, stages (1, 1)) in f32,
Flax parameters from ``init(PRNGKey(0))`` crossing through
``vision_params_from_jax``; 64 images and labels from a numpy seed (NCHW
for the port, NHWC for Flax) in 4 blocks of 16 rows, 2 epochs at batch 16
with ``drop_last``: 8 AdamW steps at lr 1e-3 (``optax.adamw``), one
worker each. Per-step losses within rtol 1e-4 (f32 sums in another order,
through 8 Adam steps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import vision as jvision
from ray_tpu_torch.models import vision as tvision
from ray_tpu_torch.models.convert import vision_params_from_jax
from ray_tpu_torch.tools import data_runs

ROWS, BLOCK, BATCH, EPOCHS, LR = 64, 16, 16, 2, 1e-3


@pytest.fixture(scope="module")
def clusters():
    ray_tpu_torch.init(num_cpus=4)
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def _jax_losses(jparams, images, labels):
    from ray_tpu import data as jdata
    from ray_tpu import train as jtrain

    def loop(config):
        import jax
        import numpy as np
        import optax

        from ray_tpu import train
        from ray_tpu.models import vision

        model = vision.ResNet(vision.ResNetConfig.small_test(
            dtype=jax.numpy.float32))
        tx = optax.adamw(config["lr"])
        params = config["params"]
        opt_state = tx.init(params)
        step = vision.build_train_step(model, tx, donate=False)
        shard = train.get_dataset_shard("train")
        losses = []
        for _ in range(config["epochs"]):
            for batch in shard.iter_batches(batch_size=config["batch"],
                                            drop_last=True):
                params, opt_state, loss = step(
                    params, opt_state,
                    {"image": batch["image"],
                     "label": batch["label"].astype(np.int32)})
                losses.append(float(loss))
        train.report({"losses": losses})

    nhwc = images.transpose(0, 2, 3, 1)
    ds = jdata.from_arrow([_arrow_block(nhwc[i:i + BLOCK],
                                        labels[i:i + BLOCK])
                           for i in range(0, ROWS, BLOCK)])
    result = jtrain.JaxTrainer(
        loop, train_loop_config={"params": jparams, "lr": LR,
                                 "batch": BATCH, "epochs": EPOCHS},
        scaling_config=jtrain.ScalingConfig(num_workers=1),
        datasets={"train": ds}).fit()
    assert result.error is None, result.error
    return result.metrics["losses"]


def _arrow_block(images, labels):
    import pyarrow as pa

    return pa.table({
        "image": pa.FixedShapeTensorArray.from_numpy_ndarray(
            np.ascontiguousarray(images)),
        "label": pa.array(labels)})


def test_resnet_losses_through_datasets_match_the_reference(clusters,
                                                            tmp_path):
    from ray_tpu_torch import train

    jcfg = jvision.ResNetConfig.small_test(dtype=jnp.float32)
    jparams = jvision.ResNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    jparams = jax.tree.map(np.asarray, jparams)
    init = tmp_path / "init.pt"
    torch.save(vision_params_from_jax(jparams), init)
    images, labels = data_runs.image_arrays(7, ROWS, 32, 10)

    config = dict(data_runs.LOOP, model="small_test", dtype="float32",
                  lr=LR, batch=BATCH, device="cpu", init=str(init),
                  epochs=(("train", EPOCHS),))
    result = train.TorchTrainer(
        data_runs.resnet_data_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
        datasets={"train": data_runs.image_dataset(
            {"image": images, "label": labels}, BLOCK)}).fit()
    assert result.error is None, result.error
    got = result.metrics["datasets"]["train"]
    assert got["rows"] == EPOCHS * ROWS
    assert len(got["epoch_s"]) == EPOCHS
    assert result.metrics["launches"] == dict.fromkeys(data_runs.KERNELS, 0)

    want = _jax_losses(jparams, images, labels)
    assert len(want) == EPOCHS * ROWS // BATCH == len(got["losses"])
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


def test_image_arrays_are_synthetic_image_batch_on_the_host():
    images, labels = data_runs.image_arrays(50, 8, 32, 10)
    want = tvision.synthetic_image_batch(50, 8, 32, 10, device="cpu")
    assert images.dtype == np.float32 and labels.dtype == np.int64
    np.testing.assert_array_equal(images, want["image"].numpy())
    np.testing.assert_array_equal(labels, want["label"].numpy())


def test_image_blocks_cut_rows_into_views():
    cols = {"image": np.zeros((10, 3, 2, 2), np.float32),
            "id": np.arange(10)}
    blocks = data_runs.image_blocks(cols, 4)
    assert [len(b["id"]) for b in blocks] == [4, 4, 2]
    assert all(np.shares_memory(b["image"], cols["image"]) for b in blocks)
    assert blocks[2]["id"].tolist() == [8, 9]
