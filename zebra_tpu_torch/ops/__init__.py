"""Tensor ops of the torch port (distances, top-k, scans, k-means, kernels)."""

from zebra_tpu_torch.ops.distances import METRICS, pairwise, rowwise
from zebra_tpu_torch.ops.hashing import (
    hash_activations,
    hash_codes,
    multiprobe,
    pack_signs,
    sample_planes_data,
    sample_planes_random,
)
from zebra_tpu_torch.ops.topk import masked_topk, merge_topk

__all__ = [
    "METRICS",
    "pairwise",
    "rowwise",
    "sample_planes_random",
    "sample_planes_data",
    "hash_activations",
    "pack_signs",
    "hash_codes",
    "multiprobe",
    "masked_topk",
    "merge_topk",
]
