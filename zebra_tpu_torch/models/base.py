"""Embedding-model protocol and registry (the port of ``zebra_tpu/models/base.py``).

A model is any object with ``name``, ``dim`` and
``embed_documents(list[bytes]) -> np.ndarray [n, dim]``; the manifest stores
the registry name, so a database reopens with the same model. Lookups are
cached by (name, device): a CPU database and a card database never share a
tower.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

DIM_BGESMALL_EN_1_5 = 384
DIM_VIT_BASE_PATCH16_224 = 768


@runtime_checkable
class EmbeddingModel(Protocol):
    name: str
    dim: int

    def embed_documents(self, documents: list[bytes]) -> np.ndarray:  # [n, dim]
        ...

    def embed(self, document: bytes) -> np.ndarray:  # [dim]
        ...


class BaseModel:
    name = "base"
    dim = 0

    def embed(self, document: bytes) -> np.ndarray:
        return self.embed_documents([document])[0]

    def embed_documents(self, documents: list[bytes]) -> np.ndarray:
        raise NotImplementedError

    def status(self) -> dict:
        """Runtime health of the embedding path: ``{"semantic": bool,
        "degradations": [str, ...]}``. ``semantic`` is False when embeddings
        carry no meaning (hash fixture, random-init weights);
        ``degradations`` lists the unintended fallbacks a user should see."""
        return {"semantic": True, "degradations": []}


class HashEmbeddingModel(BaseModel):
    """Deterministic hash-of-bytes embedding, the test fixture: sha256 of the
    document seeds a numpy generator whose Gaussian draw is scaled to unit
    norm. Equal documents get equal embeddings, bitwise those of the JAX
    package (host numpy in both)."""

    def __init__(self, dim: int = 64):
        self.dim = int(dim)
        self.name = f"hash-{dim}"

    def embed_documents(self, documents: list[bytes]) -> np.ndarray:
        out = np.empty((len(documents), self.dim), dtype=np.float32)
        for i, doc in enumerate(documents):
            seed = int.from_bytes(hashlib.sha256(doc).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
            out[i] = v / max(float(np.linalg.norm(v)), 1e-12)
        return out

    def status(self) -> dict:
        # non-semantic by choice (exact-match only), so not a degradation
        return {"semantic": False, "degradations": []}


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A tower's host batch on ``device``: through pinned memory, without
    waiting, on the card (the caching host allocator keeps the pinned copy
    alive until the transfer ends)."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


_REGISTRY: dict[str, Callable[[], EmbeddingModel]] = {}
_CACHE: dict[tuple[str, str | None], EmbeddingModel] = {}


def register_model(name: str, factory: Callable[[], EmbeddingModel]) -> None:
    """Register ``factory`` (called with no arguments) under ``name``."""
    _REGISTRY[name] = factory


def get_model(name: str, device=None) -> EmbeddingModel:
    """Resolve a model by name, cached by (name, device). ``device`` is where
    a tower runs (None: the card; ``index.base.default_device``); host models
    ignore it."""
    key = (name, None if device is None else str(device))
    if key in _CACHE:
        return _CACHE[key]
    if name.startswith("hash-"):
        model: EmbeddingModel = HashEmbeddingModel(int(name.split("-", 1)[1]))
    elif name in _REGISTRY:
        model = _REGISTRY[name]()
    else:
        model = _lazy_builtin(name, device)
    _CACHE[key] = model
    return model


def _lazy_builtin(name: str, device) -> EmbeddingModel:
    if name == "bge-small-en-v1.5":
        from zebra_tpu_torch.models.text import BGESmallEn15

        return BGESmallEn15(device=device)
    if name == "vit-base-patch16-224":
        from zebra_tpu_torch.models.image import VitImageModel

        return VitImageModel(device=device)
    if name == "vit-audio":
        from zebra_tpu_torch.models.audio import VitAudioModel

        return VitAudioModel(device=device)
    raise KeyError(f"unknown embedding model {name!r}")
