"""Image embedding: decode -> resize-to-fill 224² -> normalise -> ViT tower
(the port of ``zebra_tpu/models/image.py``).

``load_image224`` is the JAX package's host preprocessing, bitwise: any
Pillow-readable format, the short side scaled to 224 (bilinear), a centre
crop of 224 x 224, RGB, ImageNet mean / std normalisation, NHWC.
``VitImageModel`` embeds padded batches of one shape (``batch_size`` images),
so a document embeds to bitwise the same vector alone, at another row or in
another call (``Database.deduplicate`` relies on it).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from zebra_tpu_torch.index.base import default_device
from zebra_tpu_torch.models.base import DIM_VIT_BASE_PATCH16_224, BaseModel, upload
from zebra_tpu_torch.models.vit import IMAGE_SIZE, tower, weight_status

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image224(data: bytes) -> np.ndarray:
    """Decode bytes -> ``[224, 224, 3]`` float32, ImageNet-normalised."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    scale = IMAGE_SIZE / min(w, h)  # fill: short side -> 224, crop the rest
    nw, nh = max(IMAGE_SIZE, round(w * scale)), max(IMAGE_SIZE, round(h * scale))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - IMAGE_SIZE) // 2
    top = (nh - IMAGE_SIZE) // 2
    img = img.crop((left, top, left + IMAGE_SIZE, top + IMAGE_SIZE))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class VitTowerModel(BaseModel):
    """768-d embeddings of documents that preprocess to 224 x 224 x 3 images,
    through the ViT tower on ``device`` (None: the card), in padded batches of
    ``batch_size``. Subclasses turn one document into its image
    (:meth:`pixels`); the tower runs on the batch on the device."""

    dim = DIM_VIT_BASE_PATCH16_224

    def __init__(self, mode: str = "embeddings_mean", batch_size: int = 32, seed: int = 0,
                 device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel tower (mesh=) is not ported to the torch package yet "
                "(ROADMAP.md queue 1, sharding)")
        self.mode = mode
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device or default_device())

    def tower(self):
        """The cached tower module on this model's device."""
        return tower(self.mode, self.seed, str(self.device))

    def pixels(self, documents: list[bytes]) -> torch.Tensor:
        """``[batch_size, 224, 224, 3]`` on the device: the documents' images,
        zero rows after them."""
        host = np.zeros((self.batch_size, IMAGE_SIZE, IMAGE_SIZE, 3), np.float32)
        for i, d in enumerate(documents):
            host[i] = load_image224(d)
        return upload(host, self.device)

    def embed_documents(self, documents: list[bytes]) -> np.ndarray:
        enc = self.tower()
        out = torch.empty((len(documents), self.dim), dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            for start in range(0, len(documents), self.batch_size):
                batch = documents[start : start + self.batch_size]
                out[start : start + len(batch)] = enc(self.pixels(batch))[: len(batch)]
        return out.cpu().numpy()

    def status(self) -> dict:
        degr = weight_status(self.mode, self.seed, self.device)
        return {"semantic": not degr, "degradations": degr}


class VitImageModel(VitTowerModel):
    """768-d image embeddings through the ViT tower (the reference's
    ``VitBasePatch16_224``, with its zero-vector flatten fixed to a pooled
    embedding, as in the JAX package)."""

    name = "vit-base-patch16-224"
