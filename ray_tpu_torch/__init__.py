"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

A package of its own beside ``ray_tpu``: it imports torch and numpy, never
JAX and never ``ray_tpu``. Each Pallas TPU kernel on a ported path becomes a
hand-written sm_90a kernel under ``ops/csrc/``, built by nvcc at first
launch. Entry points run on the CUDA card and raise when there is none,
unless the caller passes ``device="cpu"``.
"""
