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
from zebra_tpu_torch.index import load_index, make_index
from zebra_tpu_torch.index.ivf_host import IVFIndex
from zebra_tpu_torch.index.lsh import LSHIndex

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as in the JAX package: the sharded index is loaded on first use
    if name == "ShardedLSHIndex":
        from zebra_tpu_torch.parallel.sharded import ShardedLSHIndex

        return ShardedLSHIndex
    raise AttributeError(name)


__all__ = [
    "IndexOptions",
    "DatabaseConfig",
    "Database",
    "LSHIndex",
    "IVFIndex",
    "make_index",
    "load_index",
    "ShardedLSHIndex",
    "DefaultTextDatabase",
    "DefaultImageDatabase",
    "DefaultAudioDatabase",
    "text_db",
    "image_db",
    "audio_db",
    "__version__",
]
