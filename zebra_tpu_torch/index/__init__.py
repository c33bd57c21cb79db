"""ANN index backends of the torch port: "ivf" (learned partitions), "lsh"
(bucket tables) and "flat" (an ``LSHIndex`` whose every query is the exact
scan, as in the JAX package)."""

from __future__ import annotations

import json
import os

import torch

from zebra_tpu_torch.config import IndexOptions
from zebra_tpu_torch.index import buckets as _buckets
from zebra_tpu_torch.index.buckets import OOB, IndexState, empty_state
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


# -- the functional LSH state API, with the JAX package's signatures ----------
# (``zebra_tpu/index/buckets.py``): each takes and returns a state, where the
# port's ``buckets`` functions update theirs in place


def insert(state: IndexState, x: torch.Tensor, n_valid):
    """Insert the first ``n_valid`` rows of ``x`` ``[n, D]`` (the rest are
    padding). Returns ``(state, slots [n])``: the slab slot of each row,
    ``OOB`` for a pad row."""
    n_valid = int(n_valid)
    slots = torch.full((x.shape[0],), OOB, dtype=torch.int32, device=state.device)
    if n_valid:
        slots[:n_valid] = _buckets.insert(state, x[:n_valid]).int()
    return state, slots


def delete_slots(state: IndexState, slots: torch.Tensor) -> IndexState:
    """Tombstone slab slots (negative entries are ignored); returns the state."""
    _buckets.delete_slots(state, slots)
    return state


#: the JAX package's re-rank words and the port's
_RERANK = {"xla": "eager", "pallas": "cuda"}


def query(state: IndexState, q: torch.Tensor, k: int, metric: str = "cosine",
          num_probes: int = 8, power: float = 3.0, chunk: int = 2048, rerank: str = "xla",
          max_candidates: int = 0):
    """Approximate top-k: ``(dists [B, k], slots [B, k], valid [B, k])``.
    ``rerank``: "xla" (the eager re-rank) or "pallas" (kernel 4 on the
    card, its plain version on the CPU); ``chunk`` is accepted for the
    signature (the port sizes its own chunks)."""
    return _buckets.query(state, q, k, metric=metric, num_probes=num_probes,
                          rerank=_RERANK.get(rerank, rerank), max_candidates=max_candidates,
                          power=power)


def brute_force(state: IndexState, q: torch.Tensor, k: int, metric: str = "cosine",
                power: float = 3.0, chunk: int = 8192, precision: str = "highest",
                approx: bool = False):
    """Exact top-k over the whole slab. ``approx`` is accepted, as the
    port's ``exact_scan`` accepts it: the selection stays exact."""
    return _buckets.brute_force(state, q, k, metric=metric, power=power, chunk=chunk,
                                precision=precision)


__all__ = [
    "IndexState",
    "empty_state",
    "insert",
    "delete_slots",
    "query",
    "brute_force",
    "LSHIndex",
    "IVFIndex",
    "make_index",
    "load_index",
]
