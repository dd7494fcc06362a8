"""``python -m ray_tpu_torch`` CLI entrypoint (ray parity: the `ray` console
script, python/ray/scripts/scripts.py)."""

from ray_tpu_torch.scripts.cli import main

main()
