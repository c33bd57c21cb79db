"""Device meshes of the port (port of ``zebra_tpu/parallel/mesh.py``).

The JAX package names a grid of chips with ``jax.sharding.Mesh``; the port's
stand-in is :class:`Mesh`, a grid of ``torch.device``s with the same
``.shape`` mapping (axis name -> size), so code that reads
``mesh.shape[SHARD_AXIS]`` reads as in the JAX package. One process drives
every device of a mesh: the sharded index keeps one state per device and
merges the partial results on the first, and the tensor-parallel towers keep
one slice of the weights per device and sum the partial products on the
first device of each row (``torch.distributed``'s ``DeviceMesh`` needs one
process per device).

A mesh may name one device more than once: ``make_mesh(4, [cuda:0] * 4)``
holds four shards on one card and ``make_mesh(8, [cpu] * 8)`` eight on the
CPU (how the tests run the JAX package's shard counts). Without
``devices`` a mesh takes every visible CUDA card, one shard each.
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_AXIS = "shard"


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a bare ``"cuda"``
    names the current card, so equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA card; raises, as the port's entry points do, when
    there is none."""
    from zebra_tpu_torch.index.base import default_device

    default_device()  # raises without a card, naming device='cpu'
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of devices: ``devices`` a numpy object array of
    ``torch.device`` (one axis per name), ``shape`` ``{axis name: size}``.
    Hashable by value, so a cache keyed on a mesh finds an equal one."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        flat = [normalize_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(np.shape(np.asarray(devices, dtype=object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D device grid for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """1-D mesh with axis ``"shard"`` over the first ``n_shards`` of
    ``devices`` (default: every visible CUDA card; ``n_shards`` defaults to
    all of them). A device may repeat: S shards on one card is
    ``devices=[torch.device("cuda")] * S``."""
    devices = list(devices) if devices is not None else cuda_devices()
    if n_shards is None:
        n_shards = len(devices)
    if n_shards > len(devices):
        raise ValueError(f"requested {n_shards} shards but only {len(devices)} devices")
    return Mesh(devices[:n_shards], (SHARD_AXIS,))


def shard_axis_size(mesh: Mesh) -> int:
    return mesh.shape[SHARD_AXIS]
