"""ResNet training over a Dataset shard and the image datasets, for
``chip_smoke.py`` (phases 22 and 23) and the CPU tests.

``resnet_data_loop`` is the loop a ``TorchTrainer`` worker runs over
``train.get_dataset_shard(name).iter_torch_batches(...)``: the same code
trains ResNet-50 (CIFAR stem) at full width on the card and
``ResNetConfig.small_test`` on the CPU (``tests/test_torch_data_train.py``).
The builders make the datasets from a numpy seed, as blocks put in the
object store by the driver (``data.from_blocks``: no task runs to make
them).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import vision

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
MODELS = {"resnet50_cifar": vision.ResNetConfig.resnet50_cifar,
          "small_test": vision.ResNetConfig.small_test}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# chip_smoke.py phase 14's run: ResNet-50 (CIFAR stem) bf16 over f32
# weights of seed 0, AdamW at lr 1e-4, batch 256; phase 22 first takes 5
# epochs of phase 14's batch ("parity"), then one epoch of the CIFAR-sized
# set ("train")
LOOP = {"model": "resnet50_cifar", "dtype": "bfloat16", "weight_seed": 0,
        "lr": 1e-4, "batch": 256, "device": "cuda",
        "epochs": (("parity", 5), ("train", 1))}


def image_arrays(seed: int, n: int, image_size: int, num_classes: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Standard-normal images (n, 3, H, W) f32 and int64 labels from numpy
    ``seed``: the draws of ``vision.synthetic_image_batch``, on the host."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 3, image_size, image_size),
                                 dtype=np.float32)
    labels = rng.integers(0, num_classes, size=(n,))
    return images, labels


def image_blocks(columns: Dict[str, np.ndarray], rows_per_block: int
                 ) -> List[Dict[str, np.ndarray]]:
    """The columns cut into blocks of ``rows_per_block`` rows (views)."""
    n = len(next(iter(columns.values())))
    return [{k: v[i:i + rows_per_block] for k, v in columns.items()}
            for i in range(0, n, rows_per_block)]


def image_dataset(columns: Dict[str, np.ndarray], rows_per_block: int):
    """A Dataset of ``columns`` in blocks of ``rows_per_block`` rows, put
    in the object store from this process."""
    from ray_tpu_torch import data

    return data.from_blocks(image_blocks(columns, rows_per_block))


def resnet_data_loop(config: Dict) -> None:
    """One ``TorchTrainer`` worker: ``make_train_state``'s AdamW at
    ``config["lr"]`` on the weights of ``config["weight_seed"]`` (or the
    state dict saved at ``config["init"]``), then for each ``(name,
    epochs)`` of ``config["epochs"]`` that many epochs over the worker's
    shard of the dataset ``name``, in batches of ``config["batch"]`` from
    ``iter_torch_batches(device=..., drop_last=True)``, one step a batch.
    One report at the end: per dataset its losses, rows, each epoch's wall
    s and images/s, the wait for its first batch, and per step the ms
    spent waiting for the batch on the device (the shard's iterator: the
    block fetch, the host copy, the copy to the card) and the ms of the
    step to its ``float(loss)``; the launch counts of the three kernels
    (zeroed before the first step), the calls of their plain versions, and
    the worker's peak card memory."""
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools.train_runs import counting_plain_calls

    device = torch.device(config["device"])
    if device.type == "cuda":
        device = torch.device("cuda", train.get_context().get_local_rank())
        torch.cuda.reset_peak_memory_stats(device)
    cfg = MODELS[config["model"]](dtype=DTYPES[config["dtype"]])
    net, optimizer = vision.make_train_state(
        cfg, torch.Generator().manual_seed(config["weight_seed"]),
        config["lr"], device=device)
    if config.get("init"):
        net.load_state_dict(torch.load(config["init"], map_location=device))
    step = vision.build_train_step(net, optimizer)
    for name in KERNELS:
        setattr(attn, f"{name}_launches", 0)
    out = {}
    with counting_plain_calls() as plain_calls:
        for name, epochs in config["epochs"]:
            shard = train.get_dataset_shard(name)
            runs = {"losses": [], "rows": 0, "epoch_s": [],
                    "images_per_s": [], "first_batch_wait_s": [],
                    "wait_ms": [], "step_ms": []}
            for _ in range(epochs):
                _sync(device)
                t0 = t_prev = time.perf_counter()
                rows, waits = 0, []
                for batch in shard.iter_torch_batches(
                        batch_size=config["batch"], device=device,
                        drop_last=True):
                    t_batch = time.perf_counter()
                    waits.append((t_batch - t_prev) * 1e3)
                    net, optimizer, loss = step(
                        net, optimizer, {"image": batch["image"],
                                         "label": batch["label"]})
                    runs["losses"].append(float(loss))
                    rows += len(batch["label"])
                    t_prev = time.perf_counter()
                    runs["step_ms"].append((t_prev - t_batch) * 1e3)
                wall = time.perf_counter() - t0
                runs["rows"] += rows
                runs["wait_ms"] += waits
                runs["epoch_s"].append(wall)
                runs["images_per_s"].append(rows / wall)
                runs["first_batch_wait_s"].append(
                    waits[0] / 1e3 if waits else None)
            out[name] = runs
    train.report({
        "datasets": out,
        "launches": {n: getattr(attn, f"{n}_launches") for n in KERNELS},
        "plain_calls": plain_calls[0],
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    })


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def vit_image_columns(seed: int, n: int, image_size: int
                      ) -> Dict[str, np.ndarray]:
    """Phase 23's scoring set: standard-normal images (n, 3, H, W) f32 from
    numpy ``seed`` and an int64 ``id`` a row."""
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 3, image_size, image_size),
                                         dtype=np.float32),
            "id": np.arange(n, dtype=np.int64)}


def batched_logits(net: torch.nn.Module, images: np.ndarray,
                   batch: int, device) -> np.ndarray:
    """The model's outputs on ``images`` in batches of ``batch`` rows, in
    order, under ``torch.inference_mode()`` (what a ``TorchPredictor``
    computes a batch), as f32 numpy."""
    outs = []
    with torch.inference_mode():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(images[i:i + batch]).to(device)
            outs.append(net(x).float().cpu().numpy())
    return np.concatenate(outs)
