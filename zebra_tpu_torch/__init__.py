"""zebra-tpu on PyTorch + CUDA: the port of the ``zebra_tpu`` package.

Imports ``torch`` and never ``jax``; the CUDA kernels under ``csrc/`` are
built by ``nvcc`` at first use (``ops/_kernels.py``), the host C++ sources
under ``native/`` by ``g++``. Reads and writes the JAX package's database
format.
"""

from zebra_tpu_torch import defaults
from zebra_tpu_torch.config import DatabaseConfig, IndexOptions
from zebra_tpu_torch.db import Database
from zebra_tpu_torch.defaults import (
    DefaultAudioDatabase,
    DefaultImageDatabase,
    DefaultTextDatabase,
    audio_db,
    image_db,
    text_db,
)

__all__ = [
    "Database",
    "DatabaseConfig",
    "IndexOptions",
    "defaults",
    "DefaultTextDatabase",
    "DefaultImageDatabase",
    "DefaultAudioDatabase",
    "text_db",
    "image_db",
    "audio_db",
]
