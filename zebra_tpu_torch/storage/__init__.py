"""Persistence of the torch port (the JAX package's formats)."""

from zebra_tpu_torch.storage.blobs import DocumentStore

__all__ = ["DocumentStore"]
