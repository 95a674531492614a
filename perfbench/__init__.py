"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one H100
serving an open-loop request stream through the port's engine and gate.
See README.md. Nothing here imports JAX or the JAX package."""
