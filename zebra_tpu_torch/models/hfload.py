"""Mapping local HF-style checkpoints onto a module's parameters (the port of
``zebra_tpu/models/hfload.py``).

The mapping is fully accounted: every assignment and every checkpoint tensor
is tracked, so a loader can warn, and a test can assert, when anything is
left at random init. The target is a ``{name: ndarray}`` copy of a module's
``state_dict`` (the JAX package maps onto a Flax tree)."""

from __future__ import annotations

import numpy as np


def read_checkpoint(path: str) -> dict | None:
    """Load a ``.safetensors`` or ``.npz`` checkpoint as {name: ndarray}."""
    try:
        import safetensors.numpy as st

        return st.load_file(path)
    except Exception:
        try:
            return dict(np.load(path))
        except Exception:
            return None


class Mapper:
    """Tracked assignment of checkpoint tensors into ``params``
    (``{state_dict name: ndarray}``, mutated in place)."""

    def __init__(self, raw: dict, params: dict):
        self.raw = raw
        self.params = params
        self.consumed: set[str] = set()
        self.problems: list[str] = []
        self.mapped = 0

    def put(self, dst: str, name: str, transform=None) -> None:
        if name not in self.raw:
            self.problems.append(f"missing {name}")
            return
        v = np.asarray(self.raw[name])
        if transform is not None:
            v = transform(v)
        want = self.params[dst]
        if want.shape != v.shape:
            self.problems.append(f"shape {name}: got {v.shape}, want {want.shape}")
            return
        self.params[dst] = v.astype(want.dtype)
        self.consumed.add(name)
        self.mapped += 1

    def report(self, ignored_prefixes: tuple[str, ...] = ()) -> dict:
        unused = [k for k in self.raw
                  if k not in self.consumed and not k.startswith(ignored_prefixes)]
        return {"mapped": self.mapped, "problems": self.problems, "unused": unused}
