"""Hand-written CUDA kernels of the port (``*/csrc/*.cu``, built by
``build.py``) with their wrappers and plain PyTorch versions."""
