"""Tensor-parallel embedding towers (port of ``zebra_tpu/parallel/towers.py``).

The JAX package annotates the tower's parameters with ``PartitionSpec``s
over a 2-D ``("data", "model")`` mesh and lets XLA's SPMD partitioner insert
the all-reduces. The port splits the weights itself, with the same
Megatron layout (``_leaf_spec``, ``zebra_tpu/parallel/towers.py:57-81``):

  - attention query / key / value split on their output heads, the output
    projection on its input heads, so each model rank attends over its own
    heads and holds a partial output;
  - the MLP's ``fc1`` split on its output (FFN) axis, ``fc2`` on its input;
  - everything else (embeddings, LayerNorms, the output projection's and
    ``fc2``'s biases) replicated.

:class:`TensorParallelTower` holds one copy of the split weights per mesh
device. For each block the model ranks compute their partial products on
their own devices; the partials are summed, in rank order, on the row's
first device (the stand-in for the all-reduce), the replicated biases are
added once after that sum, and the replicated work (LayerNorms, residuals)
runs there before the next block's input goes back to each rank. The batch
splits over ``"data"`` (padded by repeating the last row when it does not
divide, the output trimmed back), as ``shard_tower`` does. A mesh may repeat
a device: ``make_tower_mesh(4, 2, [cuda:0] * 8)`` runs the whole layout on
one card.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from zebra_tpu_torch.parallel.mesh import Mesh, cuda_devices

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_tower_mesh(n_model: int, n_data: int = 0, devices=None) -> Mesh:
    """2-D ``("data", "model")`` mesh: tensor parallelism within a row, data
    parallelism across rows. ``n_data=0`` uses every remaining device
    (``len(devices) // n_model``); ``devices`` defaults to every CUDA card."""
    devices = list(devices) if devices is not None else cuda_devices()
    if n_model < 1 or n_model > len(devices):
        raise ValueError(f"n_model={n_model} with {len(devices)} devices")
    if not n_data:
        n_data = len(devices) // n_model
    need = n_data * n_model
    if need > len(devices):
        raise ValueError(f"{n_data}x{n_model} mesh needs {need} devices, have {len(devices)}")
    grid = [devices[d * n_model : (d + 1) * n_model] for d in range(n_data)]
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def leaf_split(name: str) -> int | None:
    """The axis of ``state_dict`` entry ``name`` split over ``"model"``
    (``torch.nn.Linear`` weights are ``[out, in]``), or None (replicated)."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    layer, leaf = parts[-2], parts[-1]
    if layer in ("query", "key", "value", "fc1"):
        return 0  # weight rows and bias: the output heads / FFN lanes
    if layer in ("out", "fc2") and leaf == "weight":
        return 1  # the input heads / FFN lanes; the bias stays replicated
    return None


def tower_param_splits(module: nn.Module) -> dict[str, int | None]:
    """Every parameter of ``module`` and the axis it splits on (the
    counterpart of ``tower_param_shardings``)."""
    return {name: leaf_split(name) for name in module.state_dict()}


def tower_param_shardings(module: nn.Module, mesh: Mesh) -> dict[str, int | None]:
    """Every parameter of ``module`` and the axis :func:`shard_tower` splits
    it on over ``mesh``'s ``"model"`` ranks (None: replicated). Raises when a
    split axis does not divide over the ranks."""
    m = mesh.shape[MODEL_AXIS]
    splits = tower_param_splits(module)
    for name, t in module.state_dict().items():
        axis = splits[name]
        if axis is not None and t.shape[axis] % m:
            raise ValueError(f"{name} {tuple(t.shape)} does not split over {m} model ranks")
    return splits


def _reduce(parts, device) -> torch.Tensor:
    """Sum of the model ranks' partials on ``device``, in rank order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


class TensorParallelTower(nn.Module):
    """A tower (``models.text.BertEncoder`` or ``models.vit.VitTower``) run
    tensor-parallel over a ``("data", "model")`` mesh; called like the tower,
    it returns the embeddings on the mesh's first device. Do not ``.to()``
    it: each copy already sits on its device."""

    def __init__(self, tower: nn.Module, mesh: Mesh):
        super().__init__()
        from zebra_tpu_torch.models.text import BertEncoder
        from zebra_tpu_torch.models.vit import VitTower

        if not isinstance(tower, (BertEncoder, VitTower)):
            raise TypeError(f"no tensor-parallel layout for {type(tower).__name__}")
        self.mesh = mesh
        self.n_data, self.n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        blocks = tower.layers if isinstance(tower, BertEncoder) else getattr(tower, "blocks", [])
        heads = blocks[0].heads if len(blocks) else self.n_model
        ffn = blocks[0].fc1.out_features if len(blocks) else self.n_model
        if heads % self.n_model or ffn % self.n_model:
            raise ValueError(f"{heads} heads and FFN {ffn} do not split over "
                             f"{self.n_model} model ranks")
        self.kind = "bert" if isinstance(tower, BertEncoder) else "vit"
        self.rows = nn.ModuleList(
            nn.ModuleList(self._shard(tower, m, dev) for m, dev in enumerate(row))
            for row in mesh.devices)
        # the replicated biases of the reduced projections, added after the sum
        self.biases = [[(b.out.bias.detach().to(row[0]), b.fc2.bias.detach().to(row[0]))
                        for b in blocks] for row in mesh.devices]

    def _shard(self, tower: nn.Module, m: int, device) -> nn.Module:
        """Model rank ``m``'s copy of ``tower`` on ``device``: split leaves
        narrowed to the rank's slice, the reduced projections without bias."""
        shard = copy.deepcopy(tower).cpu()
        with torch.no_grad():
            for name, p in shard.named_parameters():
                axis = leaf_split(name)
                if axis is not None:
                    w = p.shape[axis] // self.n_model
                    p.data = p.data.narrow(axis, m * w, w).contiguous()
        for mod in shard.modules():
            if hasattr(mod, "fc2") and hasattr(mod, "out"):  # a block
                mod.heads //= self.n_model
                for lin in (mod.query, mod.key, mod.value, mod.fc1):
                    lin.out_features = lin.weight.shape[0]
                for lin in (mod.out, mod.fc2):
                    lin.in_features = lin.weight.shape[1]
                    lin.bias = None
        return shard.to(device).eval().requires_grad_(False)

    def shard_shapes(self) -> dict[str, tuple]:
        """Each parameter's shape on the first device (a replicated bias of a
        reduced projection: its full shape)."""
        out = {name: tuple(p.shape) for name, p in self.rows[0][0].named_parameters()}
        for i, (ob, fb) in enumerate(self.biases[0]):
            prefix = "layers" if self.kind == "bert" else "blocks"
            out[f"{prefix}.{i}.out.bias"] = tuple(ob.shape)
            out[f"{prefix}.{i}.fc2.bias"] = tuple(fb.shape)
        return out

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        b = inputs[0].shape[0]
        pad = (-b) % self.n_data
        if pad:
            inputs = tuple(torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) for a in inputs)
        per = inputs[0].shape[0] // self.n_data
        first = self.mesh.devices.flat[0]
        outs = []
        for d, (row, devs) in enumerate(zip(self.rows, self.mesh.devices)):
            chunk = tuple(a[d * per : (d + 1) * per].to(devs[0]) for a in inputs)
            run = self._bert if self.kind == "bert" else self._vit
            outs.append(run(row, list(devs), self.biases[d], *chunk).to(first))
        out = torch.cat(outs)
        return out[:b] if pad else out

    @staticmethod
    def _bert(row, devs, biases, ids, attn):
        root = row[0]
        x = root.embed(ids)
        mask = attn[:, None, None, :]
        masks = [mask.to(dv) for dv in devs]
        for i, (ob, fb) in enumerate(biases):
            layers = [sh.layers[i] for sh in row]
            a = _reduce([lay.attend(x.to(dv), mk) for lay, dv, mk in zip(layers, devs, masks)],
                        devs[0]) + ob
            x = layers[0].ln1(x + a)
            h = _reduce([lay.mlp(x.to(dv)) for lay, dv in zip(layers, devs)], devs[0]) + fb
            x = layers[0].ln2(x + h)
        return root.pool(x)

    @staticmethod
    def _vit(row, devs, biases, pixels):
        root = row[0]
        x = root.embeddings(pixels)
        if root.mode == "embeddings_mean":
            return x.mean(1)
        for i, (ob, fb) in enumerate(biases):
            blocks = [sh.blocks[i] for sh in row]
            h = blocks[0].ln1(x)
            x = x + (_reduce([blk.attend(h.to(dv)) for blk, dv in zip(blocks, devs)],
                             devs[0]) + ob)
            h = blocks[0].ln2(x)
            x = x + (_reduce([blk.mlp(h.to(dv)) for blk, dv in zip(blocks, devs)],
                             devs[0]) + fb)
        return root.pool(root.ln_final(x))


def shard_tower(tower: nn.Module, mesh: Mesh) -> TensorParallelTower:
    """``tower`` tensor-parallel over ``mesh`` (the JAX package's
    ``shard_tower`` returns the jitted apply function and its placed
    parameters; here one module holds both)."""
    return TensorParallelTower(tower, mesh)
