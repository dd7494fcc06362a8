"""Node resource autodetection.

Analog of ray: python/ray/_private/resource_spec.py. The reference
(``ray_tpu``) advertises TPU chips as a first-class "TPU" resource; the port
advertises CUDA cards as "GPU" instead. Detection is env-driven: the count
of ``CUDA_VISIBLE_DEVICES`` when it is set. Probing is opt-in (config flag
gpu_autodetect, the reference's tpu_autodetect) and runs ``nvidia-smi -L``
in a short subprocess: the raylet must neither create a CUDA context nor
pay torch's import. A probed node is labelled ``gpu-device-kind`` with the
first card's name.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Tuple

from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg


def _nvidia_smi_cards() -> List[str]:
    """Card names from ``nvidia-smi -L`` ("GPU 0: NVIDIA H100 80GB HBM3
    (UUID: ...)"), [] when there is no driver or no card."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    names = []
    for line in out.splitlines():
        head, sep, rest = line.partition(": ")
        if sep and head.startswith("GPU "):
            names.append(rest.split(" (UUID")[0].strip())
    return names


def detect_resources() -> Tuple[Dict[str, float], Dict[str, str]]:
    resources: Dict[str, float] = {}
    labels: Dict[str, str] = {}
    resources["CPU"] = float(os.cpu_count() or 1)
    try:
        import psutil

        mem = psutil.virtual_memory().total
    except Exception:
        mem = 8 * 1024**3
    resources["memory"] = float(int(mem * 0.7))
    resources["object_store_memory"] = float(cfg.object_store_memory)

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    gpus = None
    if visible is not None:
        gpus = len([d for d in visible.split(",") if d.strip()
                    and d.strip() != "-1"])
    if cfg.gpu_autodetect:
        cards = _nvidia_smi_cards()
        if cards:
            labels["gpu-device-kind"] = cards[0]
            if gpus is None:
                gpus = len(cards)
    if gpus:
        resources["GPU"] = float(gpus)
    return resources, labels
