"""Embedding models of the torch port: protocol, registry and the text tower."""

from zebra_tpu_torch.models.base import EmbeddingModel, HashEmbeddingModel, get_model, register_model

__all__ = ["EmbeddingModel", "HashEmbeddingModel", "get_model", "register_model"]
