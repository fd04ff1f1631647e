"""The benchmark suite of the PyTorch / CUDA port (``benchmarks/`` of the
JAX package, ported script by script)."""
