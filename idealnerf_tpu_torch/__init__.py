"""PyTorch/CUDA port of idealnerf_tpu for NVIDIA Hopper (H100).

Module paths and public function names follow the JAX package
(``idealnerf_tpu``), which stays the numerical reference. This package
imports torch and numpy, and Pillow for JPEG files (``data/jpeg.py``);
the hot path of the full-fidelity frame render runs through hand-written
CUDA kernels (``kernels/csrc``).
"""
