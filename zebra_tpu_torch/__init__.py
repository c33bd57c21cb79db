"""zebra-tpu on PyTorch + CUDA: the port of the ``zebra_tpu`` package.

Imports ``torch`` and never ``jax``; the CUDA kernels under ``csrc/`` are
built by ``nvcc`` at first use (``ops/_kernels.py``). Reads and writes the
JAX package's database format.
"""

from zebra_tpu_torch.config import DatabaseConfig, IndexOptions
from zebra_tpu_torch.db import Database

__all__ = ["Database", "DatabaseConfig", "IndexOptions"]
