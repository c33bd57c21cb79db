"""ViT-base-patch16-224 in PyTorch: the image and audio embedding tower (the
port of ``zebra_tpu/models/vit.py``).

The published widths: 224 px images, 16 px patches (196 patches and a CLS
token: 197 tokens), hidden 768, 12 pre-LN blocks of 12 heads, MLP 3072,
exact-erf GELU, LayerNorm eps 1e-12. Three pooling modes, as in the JAX
package:

  ``embeddings_mean``: the mean of the 197 embedding tokens (patch
      projection, CLS and position embeddings; no encoder)
  ``encoder_cls``: the full encoder, the final LayerNorm's CLS token
  ``encoder_mean``: the full encoder, the mean of its tokens

The 16x16/16 patch projection is a reshape and one matmul (a convolution
would run on cuDNN, whose TF32 default the port never takes). The layers
compute what the Flax modules compute, in their order (``models.text``'s
``LayerNorm`` and ``self_attention``), in f32 with TF32 off.

Weights: ``ZEBRA_TPU_VIT_WEIGHTS`` names a local HF ``model.safetensors``
(else the ``fetch-weights`` cache); :func:`load_vit_weights` maps every
tensor and reports any left at random init. Without one the tower runs at
random init drawn from a seeded ``torch.Generator`` with the Flax
initialisers' distributions (not JAX's stream: the packages' random towers
differ), and :func:`weight_status` says so.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from zebra_tpu_torch.index.base import default_device
from zebra_tpu_torch.models.text import LayerNorm, init_dense_, normal_, self_attention
from zebra_tpu_torch.profiling import logger

IMAGE_SIZE = 224
PATCH = 16
HIDDEN = 768
LAYERS = 12
HEADS = 12
MLP = 3072
TOKENS = (IMAGE_SIZE // PATCH) ** 2 + 1  # 197
LN_EPS = 1e-12  # HF ViTConfig.layer_norm_eps
MODES = ("embeddings_mean", "encoder_cls", "encoder_mean")


class VitEmbeddings(nn.Module):
    """Patch projection + CLS token + learned position embeddings:
    ``[n, 224, 224, 3]`` NHWC pixels -> ``[n, 197, 768]``."""

    def __init__(self):
        super().__init__()
        # a patch's pixels in (row, column, channel) order: Flax's HWIO kernel
        self.proj = nn.Linear(PATCH * PATCH * 3, HIDDEN)
        self.cls = nn.Parameter(torch.zeros(1, 1, HIDDEN))
        self.pos = nn.Parameter(torch.zeros(1, TOKENS, HIDDEN))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        n, g = pixels.shape[0], IMAGE_SIZE // PATCH
        patches = (pixels.reshape(n, g, PATCH, g, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
                   .reshape(n, g * g, PATCH * PATCH * 3))
        x = torch.cat([self.cls.expand(n, 1, HIDDEN), self.proj(patches)], dim=1)
        return x + self.pos


class VitBlock(nn.Module):
    """Pre-LN encoder block: attention, then the GELU MLP, each added back."""

    def __init__(self):
        super().__init__()
        self.ln1 = LayerNorm(HIDDEN, LN_EPS)
        self.query = nn.Linear(HIDDEN, HIDDEN)
        self.key = nn.Linear(HIDDEN, HIDDEN)
        self.value = nn.Linear(HIDDEN, HIDDEN)
        self.out = nn.Linear(HIDDEN, HIDDEN)
        self.ln2 = LayerNorm(HIDDEN, LN_EPS)
        self.fc1 = nn.Linear(HIDDEN, MLP)
        self.fc2 = nn.Linear(MLP, HIDDEN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        x = x + self_attention(h, self.query, self.key, self.value, self.out, HEADS)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class VitTower(nn.Module):
    """``[n, 224, 224, 3]`` ImageNet-normalised pixels -> ``[n, 768]``.
    ``embeddings_mean`` holds the embeddings alone (what it runs); the
    encoder modes hold ``layers`` blocks (12 at the published depth)."""

    def __init__(self, mode: str = "embeddings_mean", layers: int = LAYERS):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown ViT mode {mode!r}; choose from {MODES}")
        self.mode = mode
        self.embeddings = VitEmbeddings()
        if mode != "embeddings_mean":
            self.blocks = nn.ModuleList(VitBlock() for _ in range(layers))
            self.ln_final = LayerNorm(HIDDEN, LN_EPS)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(pixels)
        if self.mode == "embeddings_mean":
            return x.mean(1)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        return x[:, 0] if self.mode == "encoder_cls" else x.mean(1)

    @torch.no_grad()
    def random_init(self, seed: int) -> "VitTower":
        """Fill the parameters from ``torch.Generator(seed)`` with the Flax
        initialisers' distributions: CLS and position embeddings normal with
        std 0.02, the patch projection and every dense layer lecun-normal
        (fan_in 768 for the projection: 16 x 16 x 3), zero biases, unit
        LayerNorm scales."""
        g = torch.Generator().manual_seed(seed)
        normal_(self.embeddings.cls, 0.02, g)
        normal_(self.embeddings.pos, 0.02, g)
        init_dense_(self, g)
        return self

    def flops(self, n: int) -> float:
        """Operations of ``n`` images through the tower: the patch projection
        and, per block and token, the q/k/v/out and MLP products (2 * in *
        out each) and the attention's two products over 197 keys."""
        proj = 2.0 * (TOKENS - 1) * PATCH * PATCH * 3 * HIDDEN
        blocks = len(getattr(self, "blocks", ()))
        per_token = 8 * HIDDEN * HIDDEN + 4 * HIDDEN * MLP + 4 * TOKENS * HIDDEN
        return float(n) * (proj + blocks * TOKENS * per_token)


def params_from_jax(flax_params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX package's Flax parameter tree
    (numpy arrays): the Conv kernel HWIO ``[16, 16, 3, 768]`` flattened to
    ``[768, 768]`` and transposed, the attention's query / key / value
    kernels ``[768, 12, 64]`` and out kernel ``[12, 64, 768]`` flattened and
    transposed, Dense kernels transposed, LayerNorm ``scale`` as ``weight``."""
    p = flax_params
    emb = p["embeddings"]
    out = {"embeddings.proj.weight": np.asarray(emb["patch_embed"]["kernel"]).reshape(-1, HIDDEN).T,
           "embeddings.proj.bias": emb["patch_embed"]["bias"],
           "embeddings.cls": emb["cls"], "embeddings.pos": emb["pos"]}
    i = 0
    while f"block{i}" in p:
        src, dst = p[f"block{i}"], f"blocks.{i}"
        for proj in ("query", "key", "value", "out"):
            kernel = np.asarray(src["attn"][proj]["kernel"])
            flat = (kernel.reshape(-1, kernel.shape[-1]) if proj == "out"
                    else kernel.reshape(kernel.shape[0], -1))
            out[f"{dst}.{proj}.weight"] = flat.T
            out[f"{dst}.{proj}.bias"] = np.asarray(src["attn"][proj]["bias"]).reshape(-1)
        for dense in ("fc1", "fc2"):
            out[f"{dst}.{dense}.weight"] = np.asarray(src[dense]["kernel"]).T
            out[f"{dst}.{dense}.bias"] = src[dense]["bias"]
        for ln in ("ln1", "ln2"):
            out[f"{dst}.{ln}.weight"] = src[ln]["scale"]
            out[f"{dst}.{ln}.bias"] = src[ln]["bias"]
        i += 1
    if "ln_final" in p:
        out["ln_final.weight"] = p["ln_final"]["scale"]
        out["ln_final.bias"] = p["ln_final"]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


#: checkpoint tensors legitimately unused by the pooling modes
_VIT_IGNORED_PREFIXES = ("pooler.", "classifier.")


def load_vit_weights(path: str, module: VitTower):
    """Map the full ``google/vit-base-patch16-224`` parameter set onto
    ``module`` in place. Returns ``(module, report)``: the tensors mapped,
    every mapping problem and every checkpoint tensor left unused, as the
    JAX package's loader reports them. ``embeddings_mean`` holds no encoder,
    so the encoder's tensors are ignored rather than problems."""
    from zebra_tpu_torch.models.hfload import Mapper, read_checkpoint

    raw = read_checkpoint(path)
    if raw is None:
        return module, {"mapped": 0, "problems": [f"unreadable checkpoint {path}"],
                        "unused": []}
    raw = {(k[4:] if k.startswith("vit.") else k): np.asarray(v) for k, v in raw.items()}
    params = {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}
    m = Mapper(raw, params)
    put = m.put
    put("embeddings.cls", "embeddings.cls_token")
    put("embeddings.pos", "embeddings.position_embeddings")
    # HF's conv weight is OIHW; the projection takes (row, column, channel)
    put("embeddings.proj.weight", "embeddings.patch_embeddings.projection.weight",
        lambda v: np.transpose(v, (0, 2, 3, 1)).reshape(v.shape[0], -1))
    put("embeddings.proj.bias", "embeddings.patch_embeddings.projection.bias")
    ignored = _VIT_IGNORED_PREFIXES
    if module.mode == "embeddings_mean":
        ignored = ignored + ("encoder.", "layernorm.")
    else:
        for i in range(len(module.blocks)):
            hf, ours = f"encoder.layer.{i}", f"blocks.{i}"
            for proj in ("query", "key", "value"):
                put(f"{ours}.{proj}.weight", f"{hf}.attention.attention.{proj}.weight")
                put(f"{ours}.{proj}.bias", f"{hf}.attention.attention.{proj}.bias")
            put(f"{ours}.out.weight", f"{hf}.attention.output.dense.weight")
            put(f"{ours}.out.bias", f"{hf}.attention.output.dense.bias")
            put(f"{ours}.ln1.weight", f"{hf}.layernorm_before.weight")
            put(f"{ours}.ln1.bias", f"{hf}.layernorm_before.bias")
            put(f"{ours}.ln2.weight", f"{hf}.layernorm_after.weight")
            put(f"{ours}.ln2.bias", f"{hf}.layernorm_after.bias")
            put(f"{ours}.fc1.weight", f"{hf}.intermediate.dense.weight")
            put(f"{ours}.fc1.bias", f"{hf}.intermediate.dense.bias")
            put(f"{ours}.fc2.weight", f"{hf}.output.dense.weight")
            put(f"{ours}.fc2.bias", f"{hf}.output.dense.bias")
        put("ln_final.weight", "layernorm.weight")
        put("ln_final.bias", "layernorm.bias")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return module, m.report(ignored)


#: per-mode weight-load health ("loaded" / "partial" / "random"), surfaced by
#: the image and audio models' ``status()`` -> ``Database.model_status()``
WEIGHT_STATUS: dict[str, str] = {}


def _resolve_weights_path() -> str:
    """``ZEBRA_TPU_VIT_WEIGHTS`` when set, else the ``fetch-weights`` cache."""
    env = os.environ.get("ZEBRA_TPU_VIT_WEIGHTS", "")
    if env:
        return env
    from zebra_tpu_torch.models.fetch import cached_weights

    return cached_weights("vit") or ""


@functools.lru_cache(maxsize=None)
def tower(mode: str, seed: int, device: str) -> VitTower:
    """The ``mode`` tower on ``device``: random init from ``seed``, then the
    checkpoint where one resolves."""
    model = VitTower(mode).random_init(seed)
    weights = _resolve_weights_path()
    if weights and os.path.exists(weights):
        model, report = load_vit_weights(weights, model)
        if report["problems"]:
            logger.warning("vit checkpoint %s: %d tensors NOT mapped (random init remains!): %s",
                           weights, len(report["problems"]), report["problems"][:8])
            WEIGHT_STATUS[mode] = "partial"
        else:
            logger.info("vit: loaded %d tensors from %s", report["mapped"], weights)
            WEIGHT_STATUS[mode] = "loaded"
    else:
        if weights:
            logger.warning("ZEBRA_TPU_VIT_WEIGHTS=%s does not exist — random init", weights)
        WEIGHT_STATUS[mode] = "random"
    return model.to(device).eval().requires_grad_(False)


def weight_status(mode: str, seed: int = 0, device=None) -> list[str]:
    """Degradation strings of a tower mode (builds the cached tower)."""
    tower(mode, seed, str(torch.device(device or default_device())))
    st = WEIGHT_STATUS.get(mode, "random")
    if st == "random":
        return [
            "random-init ViT weights (run `zebra-tpu fetch-weights vit` on "
            "a connected machine, or set ZEBRA_TPU_VIT_WEIGHTS to a "
            "model.safetensors checkpoint)"
        ]
    if st == "partial":
        return ["ViT checkpoint only partially mapped (see log)"]
    return []


def embed_pixels(pixels, mode: str = "embeddings_mean", seed: int = 0, device=None,
                 mesh=None) -> np.ndarray:
    """``[n, 224, 224, 3]`` float32 ImageNet-normalised pixels (numpy or a
    tensor) -> ``[n, 768]`` numpy, on ``device`` (None: the card)."""
    if mesh is not None:
        raise NotImplementedError(
            "a tensor-parallel tower (mesh=) is not ported to the torch package yet "
            "(ROADMAP.md queue 1, sharding)")
    dev = torch.device(device or default_device())
    enc = tower(mode, seed, str(dev))
    x = torch.as_tensor(pixels, dtype=torch.float32).to(dev)
    with torch.inference_mode():
        return enc(x).cpu().numpy()
