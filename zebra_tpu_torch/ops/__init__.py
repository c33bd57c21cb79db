"""Tensor ops of the torch port (distances, top-k, scans, k-means, kernels)."""
