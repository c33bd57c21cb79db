"""ANN index backends of the torch port: IVF only so far. The flat and LSH
index types are not ported yet (ROADMAP.md queue 1)."""

from __future__ import annotations

import json
import os

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index.ivf_host import IVFIndex


def _check_type(index_type: str) -> None:
    if index_type != "ivf":
        raise NotImplementedError(
            f"index_type={index_type!r} is not ported yet: the torch port has "
            "'ivf' (ROADMAP.md queue 1: the flat tier, then LSH)"
        )


def make_index(dim: int, metric: str = "cosine", options=None, metric_power: float = 3.0,
               device=None):
    """Construct the backend for ``options.index_type``."""
    options = options or IndexOptions()
    _check_type(options.index_type)
    return IVFIndex(dim=dim, metric=metric, options=options, metric_power=metric_power,
                    device=device)


def load_index(directory: str, device=None):
    """Open a saved index (either package's snapshot)."""
    with open(os.path.join(directory, "index.json"), "rb") as f:
        meta = json.loads(f.read())
    _check_type(meta.get("options", {}).get("index_type", "lsh"))
    return IVFIndex.load(directory, device=device)


__all__ = ["IVFIndex", "make_index", "load_index"]
