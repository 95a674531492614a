"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel.

Each ``<kernel>/ops.py`` holds the public wrapper, with the reference's
signature, and the plain PyTorch version of the same function.  The
wrapper launches the CUDA kernel (``csrc/<kernel>.cu``, built at first use
by :mod:`.build`) for CUDA tensors, raises for what the kernel does not
take, and runs the plain version only for CPU tensors.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
