"""The port's tensor-parallel towers (``zebra_tpu_torch.parallel.towers``;
the twin of ``tests/test_towers.py``) on the CPU.

The tensor-parallel tower must compute the single-device tower's function:
only where the products run changes. A ``(data=2, model=4)`` grid of
``torch.device("cpu")``: 12 heads / 4 = 3 heads a rank, BGE-small's FFN
1536 / 4 = 384 lanes, ViT's 3072 / 4 = 768. The encoders run at 2 layers
(full widths; the full depth runs on the card in ``chip_smoke.py``), within
the JAX test's 2e-5.
"""

import functools
import io
import wave

import numpy as np
import pytest
import torch
from torch import nn

from zebra_tpu_torch.models import audio as TA
from zebra_tpu_torch.models import image as TI
from zebra_tpu_torch.models import text as TT
from zebra_tpu_torch.models import vit as TV
from zebra_tpu_torch.parallel.towers import (MODEL_AXIS, TensorParallelTower, leaf_split,
                                             make_tower_mesh, shard_tower, tower_param_shardings,
                                             tower_param_splits)

CPU = torch.device("cpu")
ATOL = 2e-5


@pytest.fixture(scope="module")
def mesh():
    return make_tower_mesh(n_model=4, n_data=2, devices=[CPU] * 8)


@pytest.fixture
def short_text_tower(monkeypatch):
    """``models.text``'s encoder at 2 layers (the model classes build it),
    and the hashing tokenizer (importing ``transformers`` costs ~11 s)."""

    @functools.lru_cache(maxsize=None)
    def encoder(seed, device):
        return TT.BertEncoder(layers=2).random_init(seed).to(device).eval().requires_grad_(False)

    monkeypatch.setattr(TT, "_encoder", encoder)
    monkeypatch.setattr(TT, "_tokenizer", TT._HashTokenizer)


def test_mesh_shape(mesh):
    assert mesh.shape == {"data": 2, "model": 4}
    assert make_tower_mesh(4, devices=[CPU] * 8) == mesh
    with pytest.raises(ValueError):
        make_tower_mesh(n_model=16, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        make_tower_mesh(n_model=4, n_data=4, devices=[CPU] * 8)


def test_text_tower_tp_matches_single_device(mesh, short_text_tower):
    texts = [f"document number {i} about zebras".encode() for i in range(10)]
    base = TT.BGESmallEn15(batch_size=8, device="cpu")
    tp = TT.BGESmallEn15(batch_size=8, mesh=mesh)
    assert tp.device == CPU and isinstance(tp.encoder(), TensorParallelTower)
    ref, got = base.embed_documents(texts), tp.embed_documents(texts)
    assert got.shape == ref.shape == (10, 384)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    # a batch the data axis does not divide: padded by its last row, trimmed
    enc = base.encoder()
    ids = torch.from_numpy(np.random.default_rng(0).integers(1000, 30000, (5, 16)))
    attn = torch.arange(16)[None, :] < torch.tensor([16, 9, 4, 12, 1])[:, None]
    with torch.inference_mode():
        np.testing.assert_allclose(tp.encoder()(ids, attn).numpy(), enc(ids, attn).numpy(),
                                   atol=ATOL, rtol=ATOL)


def test_text_params_actually_split(mesh, short_text_tower):
    tp = TT.BGESmallEn15(batch_size=8, mesh=mesh).encoder()
    shapes = tp.shard_shapes()
    # the MLP's in and out weights split on the FFN axis
    assert shapes["layers.0.fc1.weight"] == (1536 // 4, 384)
    assert shapes["layers.0.fc1.bias"] == (1536 // 4,)
    assert shapes["layers.0.fc2.weight"] == (384, 1536 // 4)
    # attention q/k/v split on heads (3 of 12, 32 wide); the output
    # projection on its input heads
    for proj in ("query", "key", "value"):
        assert shapes[f"layers.1.{proj}.weight"] == (12 // 4 * 32, 384)
        assert shapes[f"layers.1.{proj}.bias"] == (12 // 4 * 32,)
    assert shapes["layers.0.out.weight"] == (384, 12 // 4 * 32)
    # replicated leaves stay whole: embeddings, LayerNorms, reduced biases
    assert shapes["ln_embed.weight"] == (384,) and shapes["tok_embed.weight"] == (30522, 384)
    assert shapes["layers.0.out.bias"] == shapes["layers.0.fc2.bias"] == (384,)
    assert tp.rows[1][3].layers[0].heads == 3
    splits = tower_param_splits(TT.BertEncoder(layers=2))
    assert {k for k, v in splits.items() if v is not None} == {
        f"layers.{i}.{p}.{leaf}" for i in range(2)
        for p in ("query", "key", "value", "fc1") for leaf in ("weight", "bias")
    } | {f"layers.{i}.{p}.weight" for i in range(2) for p in ("out", "fc2")}
    assert leaf_split("layers.0.out.weight") == 1 and leaf_split("pos_embed") is None
    assert MODEL_AXIS in mesh.shape


@pytest.mark.parametrize("mode", ["embeddings_mean", "encoder_cls", "encoder_mean"])
def test_vit_tower_tp_matches_single_device(mesh, mode):
    """3 images on 2 data rows (one padded); ``embeddings_mean`` runs the
    replicated patch projection, the encoder modes the split blocks."""
    pixels = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 224, 224, 3))
                              .astype(np.float32))
    single = TV.VitTower(mode, layers=2).random_init(0).eval()
    tp = shard_tower(single, mesh)
    with torch.inference_mode():
        ref, got = single(pixels).numpy(), tp(pixels).numpy()
    assert got.shape == ref.shape == (3, 768)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    if mode != "embeddings_mean":
        assert tp.shard_shapes()["blocks.1.fc1.weight"] == (3072 // 4, 768)


def test_embed_pixels_caches_by_mesh_value(mesh):
    pixels = np.random.default_rng(2).standard_normal((4, 224, 224, 3)).astype(np.float32)
    TV._TP_CACHE.clear()
    ref = TV.embed_pixels(pixels, device="cpu")
    got = TV.embed_pixels(pixels, mesh=mesh)
    again = TV.embed_pixels(pixels, mesh=make_tower_mesh(4, 2, [CPU] * 8))
    assert len(TV._TP_CACHE) == 1 and np.array_equal(got, again)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_image_model_with_mesh(mesh):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (64, 80, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    data = buf.getvalue()
    ref = TI.VitImageModel(batch_size=4, device="cpu").embed_documents([data, data])
    model = TI.VitImageModel(batch_size=4, mesh=mesh)
    got = model.embed_documents([data, data])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got[0], got[1], atol=1e-6)
    assert model.status() == TI.VitImageModel(device="cpu").status()


def test_audio_model_with_mesh(mesh):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        t = np.arange(16000)
        w.writeframes((np.sin(2 * np.pi * 440 * t / 16000) * 20000).astype(np.int16).tobytes())
    data = buf.getvalue()
    ref = TA.VitAudioModel(batch_size=2, device="cpu").embed_documents([data])
    got = TA.VitAudioModel(batch_size=2, mesh=mesh).embed_documents([data])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_layouts_that_do_not_split_are_refused():
    with pytest.raises(ValueError, match="do not split"):
        shard_tower(TT.BertEncoder(layers=1), make_tower_mesh(5, 1, [CPU] * 5))
    with pytest.raises(TypeError, match="no tensor-parallel layout"):
        TensorParallelTower(nn.Linear(4, 4), make_tower_mesh(1, 1, [CPU]))


def test_tower_param_shardings_name_each_split(mesh):
    """``tower_param_shardings``: each parameter's split axis over the mesh's
    model ranks, the layout ``shard_tower`` gives it; a mesh the split axes
    do not divide over is refused."""
    enc = TT.BertEncoder(layers=1)
    assert tower_param_shardings(enc, mesh) == tower_param_splits(enc)
    with pytest.raises(ValueError, match="does not split over 5"):
        tower_param_shardings(enc, make_tower_mesh(5, 1, [CPU] * 5))
