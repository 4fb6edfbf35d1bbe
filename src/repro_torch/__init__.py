"""repro_torch — the PyTorch/CUDA port of ``repro`` (Shifted Randomized
SVD) for NVIDIA Hopper.

It mirrors ``src/repro/`` module for module; every shifted contact with
a dense X goes through the hand-written sm_90a kernel
``csrc/shifted_matmul.cu``.  Entry points run on ``device="cuda"``
unless the caller asks for the CPU.  The package imports ``torch`` and
numpy, never ``jax`` or ``repro``.
"""
