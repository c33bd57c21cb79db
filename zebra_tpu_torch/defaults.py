"""Default database configurations (the port of ``zebra_tpu/defaults.py``).

  text : 384-d, L2-squared, BGE-small-en-v1.5
  image: 768-d, cosine,     ViT-base-patch16-224
  audio: 768-d, cosine,     audio ViT (spectrogram)

Every factory takes ``device`` (None: the card) for the index and the model.
"""

from __future__ import annotations

from zebra_tpu_torch.config import DatabaseConfig, IndexOptions
from zebra_tpu_torch.db import Database
from zebra_tpu_torch.models.base import DIM_BGESMALL_EN_1_5, DIM_VIT_BASE_PATCH16_224


def text_config(options: IndexOptions | None = None, shards: int = 1) -> DatabaseConfig:
    return DatabaseConfig(dim=DIM_BGESMALL_EN_1_5, metric="sql2", model="bge-small-en-v1.5",
                          index=options or IndexOptions(), shards=shards)


def image_config(options: IndexOptions | None = None, shards: int = 1) -> DatabaseConfig:
    return DatabaseConfig(dim=DIM_VIT_BASE_PATCH16_224, metric="cosine",
                          model="vit-base-patch16-224", index=options or IndexOptions(),
                          shards=shards)


def audio_config(options: IndexOptions | None = None, shards: int = 1) -> DatabaseConfig:
    return DatabaseConfig(dim=DIM_VIT_BASE_PATCH16_224, metric="cosine", model="vit-audio",
                          index=options or IndexOptions(), shards=shards)


def text_db(path: str, options: IndexOptions | None = None, shards: int = 1,
            device=None) -> Database:
    return Database.open_or_create(path, text_config(options, shards), device=device)


def image_db(path: str, options: IndexOptions | None = None, shards: int = 1,
             device=None) -> Database:
    return Database.open_or_create(path, image_config(options, shards), device=device)


def audio_db(path: str, options: IndexOptions | None = None, shards: int = 1,
             device=None) -> Database:
    return Database.open_or_create(path, audio_config(options, shards), device=device)


class DefaultTextDatabase:
    """Alias of the reference's ``DefaultTextDatabase``."""

    @staticmethod
    def open_or_create(path: str, options: IndexOptions | None = None,
                       device=None) -> Database:
        return text_db(path, options, device=device)


class DefaultImageDatabase:
    @staticmethod
    def open_or_create(path: str, options: IndexOptions | None = None,
                       device=None) -> Database:
        return image_db(path, options, device=device)


class DefaultAudioDatabase:
    @staticmethod
    def open_or_create(path: str, options: IndexOptions | None = None,
                       device=None) -> Database:
        return audio_db(path, options, device=device)
