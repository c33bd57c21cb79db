"""ANN index backends of the torch port: "ivf" (learned partitions), "lsh"
(bucket tables) and "flat" (an ``LSHIndex`` whose every query is the exact
scan, as in the JAX package)."""

from __future__ import annotations

import json
import os

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index.ivf_host import IVFIndex
from zebra_tpu_torch.index.lsh import LSHIndex

_BACKENDS = {"ivf": IVFIndex, "lsh": LSHIndex, "flat": LSHIndex}


def _backend(index_type: str):
    if index_type not in _BACKENDS:
        raise ValueError(f"unknown index_type {index_type!r}; choose from {sorted(_BACKENDS)}")
    return _BACKENDS[index_type]


def make_index(dim: int, metric: str = "cosine", options=None, metric_power: float = 3.0,
               device=None):
    """Construct the backend for ``options.index_type``."""
    options = options or IndexOptions()
    return _backend(options.index_type)(dim=dim, metric=metric, options=options,
                                        metric_power=metric_power, device=device)


def load_index(directory: str, device=None):
    """Open a saved index (either package's snapshot)."""
    with open(os.path.join(directory, "index.json"), "rb") as f:
        meta = json.loads(f.read())
    return _backend(meta.get("options", {}).get("index_type", "lsh")).load(directory, device=device)


__all__ = ["IVFIndex", "LSHIndex", "make_index", "load_index"]
