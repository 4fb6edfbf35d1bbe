"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers and
their plain PyTorch versions (``ref.py``)."""
