"""The port's ViT-base/16 tower against the JAX package's Flax ``VitTower``,
on the CPU: the same pixels and parameters (``params_from_jax``) in all
three pooling modes, at 2 layers and at the published 12, batch 2, to atol
1e-5 (the text tower's ``TOWER_ATOL``); the random initialisers'
distributions; the HF checkpoint loader on a checkpoint the test writes
(every tensor consumed, both packages' reports and towers alike); and the
``weight_status`` strings."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zebra_tpu.models import vit as JV
from zebra_tpu_torch.models import vit as TV

TOWER_ATOL = 1e-5


def _flax(mode, layers, monkeypatch, seed=0):
    monkeypatch.setattr(JV, "LAYERS", layers)
    model = JV.VitTower(mode=mode)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, JV.IMAGE_SIZE, JV.IMAGE_SIZE, 3), jnp.float32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _pixels(seed, n=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, TV.IMAGE_SIZE, TV.IMAGE_SIZE, 3)).astype(np.float32)


def _run(tower, pixels):
    with torch.inference_mode():
        return tower(torch.from_numpy(pixels)).numpy()


def test_widths_are_the_jax_packages():
    assert (TV.IMAGE_SIZE, TV.PATCH, TV.HIDDEN, TV.LAYERS, TV.HEADS, TV.MLP, TV.TOKENS,
            TV.LN_EPS) == (JV.IMAGE_SIZE, JV.PATCH, JV.HIDDEN, JV.LAYERS, JV.HEADS, JV.MLP,
                           JV.TOKENS, JV.LN_EPS) == (224, 16, 768, 12, 12, 3072, 197, 1e-12)
    with pytest.raises(ValueError, match="unknown ViT mode"):
        TV.VitTower("cls")


@pytest.mark.parametrize("mode,layers", [("embeddings_mean", 0), ("encoder_cls", 2),
                                         ("encoder_mean", 2), ("encoder_cls", 12),
                                         ("encoder_mean", 12)])
def test_tower_matches_flax(monkeypatch, mode, layers):
    model, params = _flax(mode, layers, monkeypatch)
    pixels = _pixels(layers)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(pixels)))
    tower = TV.VitTower(mode, layers=layers)
    tower.load_state_dict(TV.params_from_jax(params))
    got = _run(tower, pixels)
    assert got.shape == (2, 768) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


def test_random_init_has_the_flax_distributions(monkeypatch):
    tower = TV.VitTower("encoder_cls", layers=2).random_init(0)
    sd = {k: v.numpy() for k, v in tower.state_dict().items()}
    _, flax = _flax("encoder_cls", 2, monkeypatch)
    ported = {k: v.numpy() for k, v in TV.params_from_jax(flax).items()}
    assert sorted(ported) == sorted(sd)
    for k in ("embeddings.cls", "embeddings.pos"):
        assert abs(sd[k].std() - 0.02) < 2e-3 and abs(ported[k].std() - 0.02) < 2e-3
    for k, fan_in in (("embeddings.proj.weight", 768), ("blocks.0.query.weight", 768),
                      ("blocks.1.out.weight", 768), ("blocks.0.fc1.weight", 768),
                      ("blocks.1.fc2.weight", 3072)):
        std = 1 / np.sqrt(fan_in)
        for w in (sd[k], ported[k]):  # the port's draw, and Flax's own
            assert abs(w.std() - std) < 0.02 * std
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    for params in (sd, ported):
        assert all((params[k] == 0).all() for k in params if k.endswith(".bias"))
        scales = [k for k in params if k.endswith(".weight") and "ln" in k.split(".")[-2]]
        assert len(scales) == 5 and all((params[k] == 1).all() for k in scales)
    again = TV.VitTower("encoder_cls", layers=2).random_init(0).state_dict()
    assert all(torch.equal(again[k], v) for k, v in tower.state_dict().items())
    assert set(TV.VitTower("embeddings_mean").state_dict()) == {
        "embeddings.proj.weight", "embeddings.proj.bias", "embeddings.cls", "embeddings.pos"}


def _hf_checkpoint(seed, layers, scale=0.02):
    """HF ``google/vit-base-patch16-224`` names and shapes (``vit.`` prefixed,
    with the pooler and classifier the modes leave unused), small random
    values (LayerNorm scales near 1)."""
    rng = np.random.default_rng(seed)
    h, f = TV.HIDDEN, TV.MLP

    def w(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    t = {"embeddings.cls_token": w(1, 1, h), "embeddings.position_embeddings": w(1, TV.TOKENS, h),
         "embeddings.patch_embeddings.projection.weight": w(h, 3, TV.PATCH, TV.PATCH),
         "embeddings.patch_embeddings.projection.bias": w(h),
         "layernorm.weight": 1 + w(h), "layernorm.bias": w(h)}
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            t[f"{p}.attention.attention.{proj}.weight"] = w(h, h)
            t[f"{p}.attention.attention.{proj}.bias"] = w(h)
        t[f"{p}.attention.output.dense.weight"] = w(h, h)
        t[f"{p}.attention.output.dense.bias"] = w(h)
        t[f"{p}.layernorm_before.weight"] = 1 + w(h)
        t[f"{p}.layernorm_before.bias"] = w(h)
        t[f"{p}.layernorm_after.weight"] = 1 + w(h)
        t[f"{p}.layernorm_after.bias"] = w(h)
        t[f"{p}.intermediate.dense.weight"] = w(f, h)
        t[f"{p}.intermediate.dense.bias"] = w(f)
        t[f"{p}.output.dense.weight"] = w(h, f)
        t[f"{p}.output.dense.bias"] = w(h)
    out = {f"vit.{k}": v for k, v in t.items()}
    out["classifier.weight"] = w(10, h)
    return out


@pytest.mark.parametrize("mode", ["embeddings_mean", "encoder_cls"])
def test_checkpoint_loads_alike_in_both_packages(tmp_path, monkeypatch, mode):
    """One synthetic ``.npz`` (2 encoder layers): every tensor consumed or
    ignored by name in both loaders, the same reports, and the towers built
    from the two loads answer alike."""
    layers = 2
    path = str(tmp_path / "vit.npz")
    np.savez(path, **_hf_checkpoint(3, layers))
    model, params = _flax(mode, layers, monkeypatch)
    jparams, jreport = JV.load_vit_weights(path, params, mode=mode)
    tower, treport = TV.load_vit_weights(path, TV.VitTower(mode, layers=layers).random_init(0))
    assert treport == jreport and treport["problems"] == [] and treport["unused"] == []
    assert treport["mapped"] == (4 if mode == "embeddings_mean" else 4 + 16 * layers + 2)
    ported = TV.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert all(torch.equal(ported[k], v) for k, v in tower.state_dict().items())
    pixels = _pixels(5)
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(pixels)))
    np.testing.assert_allclose(_run(tower, pixels), want, atol=TOWER_ATOL, rtol=0)


def test_a_damaged_checkpoint_is_reported_alike(tmp_path, monkeypatch):
    ckpt = _hf_checkpoint(4, 1)
    del ckpt["vit.encoder.layer.0.output.dense.bias"]
    ckpt["vit.layernorm.bias"] = np.zeros(5, np.float32)
    ckpt["vit.stray.tensor"] = np.zeros(3, np.float32)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **ckpt)
    _, params = _flax("encoder_mean", 1, monkeypatch)
    _, jreport = JV.load_vit_weights(path, params, mode="encoder_mean")
    _, treport = TV.load_vit_weights(path, TV.VitTower("encoder_mean", layers=1))
    assert treport == jreport and len(treport["problems"]) == 2
    assert treport["unused"] == ["layernorm.bias", "stray.tensor"]
    assert TV.load_vit_weights(str(tmp_path / "none.npz"), TV.VitTower())[1]["problems"] == [
        f"unreadable checkpoint {tmp_path / 'none.npz'}"]


@pytest.fixture
def fresh_towers(monkeypatch, tmp_path):
    """No checkpoint anywhere, and both packages' tower caches empty before
    and after (a test may load one)."""
    monkeypatch.delenv("ZEBRA_TPU_VIT_WEIGHTS", raising=False)
    monkeypatch.setenv("ZEBRA_TPU_WEIGHTS_CACHE", str(tmp_path / "cache"))
    for clear in (JV._tower_and_params.cache_clear, TV.tower.cache_clear):
        clear()
    yield
    for clear in (JV._tower_and_params.cache_clear, TV.tower.cache_clear):
        clear()
    JV.WEIGHT_STATUS.clear()
    TV.WEIGHT_STATUS.clear()


def test_status_strings_are_the_jax_packages(fresh_towers, monkeypatch, tmp_path):
    """Random init, a full checkpoint, a partial one: the same degradations in
    both packages; ``embed_pixels`` on a loaded checkpoint answers as Flax."""
    for mode in ("embeddings_mean", "encoder_cls"):
        assert TV.weight_status(mode, device="cpu") == JV.weight_status(mode)
        assert len(TV.weight_status(mode, device="cpu")) == 1
    path = str(tmp_path / "emb.npz")
    ckpt = _hf_checkpoint(6, 0)
    np.savez(path, **ckpt)
    monkeypatch.setenv("ZEBRA_TPU_VIT_WEIGHTS", path)
    for clear in (JV._tower_and_params.cache_clear, TV.tower.cache_clear):
        clear()
    assert TV.weight_status("embeddings_mean", device="cpu") == JV.weight_status(
        "embeddings_mean") == []
    pixels = _pixels(8, n=3)
    np.testing.assert_allclose(TV.embed_pixels(pixels, device="cpu"), JV.embed_pixels(pixels),
                               atol=TOWER_ATOL, rtol=0)
    partial = TV.weight_status("encoder_cls", device="cpu")  # the checkpoint has no encoder
    assert partial == JV.weight_status("encoder_cls") == [
        "ViT checkpoint only partially mapped (see log)"]
    with pytest.raises(NotImplementedError, match="sharding"):
        TV.embed_pixels(pixels, device="cpu", mesh=object())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        TV.embed_pixels(pixels)
