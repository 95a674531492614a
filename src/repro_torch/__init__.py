"""PyTorch + CUDA port of the calibrated prefill/decode control loop.

Mirrors the layout of the JAX package ``repro`` and is held against it
by ``tests/test_torch_*.py``.  Imports ``torch`` and ``numpy`` only.
"""
