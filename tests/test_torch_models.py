"""The port's embedding models against the JAX package's: the hash model and
WordPiece bitwise, the BGE-small tower against the Flax ``BertEncoder`` on
the same token ids, masks and parameters (``params_from_jax``), the HF
checkpoint loader's report and embeddings, and ``status()``'s strings."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zebra_tpu.models import base as JBASE
from zebra_tpu.models import text as JT
from zebra_tpu.models import wordpiece as JW
from zebra_tpu_torch.models import base as TBASE
from zebra_tpu_torch.models import text as TT
from zebra_tpu_torch.models import wordpiece as TW

#: unit CLS vectors of the two towers on the same inputs and parameters
TOWER_ATOL = 1e-5


def _inputs(seed, n, lengths):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, JT.VOCAB, (n, JT.SEQ_LEN)).astype(np.int32)
    attn = np.zeros((n, JT.SEQ_LEN), bool)
    for i, length in enumerate(lengths):
        attn[i, :length] = True
    return ids, attn


def _flax(layers, monkeypatch, seed=0):
    monkeypatch.setattr(JT, "LAYERS", layers)
    model = JT.BertEncoder()
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, JT.SEQ_LEN), jnp.int32),
                        jnp.ones((1, JT.SEQ_LEN), jnp.bool_))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(state, layers):
    enc = TT.BertEncoder(layers=layers)
    enc.load_state_dict(state)
    return enc


def _run_port(enc, ids, attn):
    with torch.inference_mode():
        return enc(torch.from_numpy(ids), torch.from_numpy(attn)).numpy()


def test_hash_model_is_bitwise_jax():
    rng = np.random.default_rng(0)
    docs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(50)] + [b"", b"alpha", b"alpha"]
    for dim in (8, 64, 384):
        got = TBASE.HashEmbeddingModel(dim).embed_documents(docs)
        want = JBASE.HashEmbeddingModel(dim).embed_documents(docs)
        assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                          want.view(np.uint32))
    m = TBASE.HashEmbeddingModel(16)
    assert m.name == "hash-16" and m.status() == {"semantic": False, "degradations": []}
    assert np.array_equal(m.embed(b"alpha"), m.embed_documents([b"alpha"])[0])


def test_registry_caches_by_name_and_device():
    a = TBASE.get_model("hash-12", device="cpu")
    assert TBASE.get_model("hash-12", device="cpu") is a and a.dim == 12
    assert TBASE.get_model("hash-12") is not a
    TBASE.register_model("fixture-3", lambda: TBASE.HashEmbeddingModel(3))
    assert TBASE.get_model("fixture-3", device="cpu").dim == 3
    with pytest.raises(KeyError):
        TBASE.get_model("no-such-model", device="cpu")
    assert (TBASE.DIM_BGESMALL_EN_1_5, TBASE.DIM_VIT_BASE_PATCH16_224) == (
        JBASE.DIM_BGESMALL_EN_1_5, JBASE.DIM_VIT_BASE_PATCH16_224)


def test_text_tower_needs_a_device_without_cuda():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.BGESmallEn15()
    from zebra_tpu_torch.parallel.towers import make_tower_mesh

    # a mesh names the devices: tensor-parallel over two CPU ranks
    tp = TT.BGESmallEn15(batch_size=2, mesh=make_tower_mesh(2, 1, [torch.device("cpu")] * 2))
    assert tp.device == torch.device("cpu")
    single = TT.BGESmallEn15(batch_size=2, device="cpu")
    np.testing.assert_allclose(tp.embed_documents([b"a zebra"]),
                               single.embed_documents([b"a zebra"]), atol=2e-5, rtol=2e-5)


def test_wordpiece_ids_are_the_jax_packages(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox", "jump",
             "##s", "##ed", "over", "lazy", "dog", ",", ".", "!", "$", "cafe", "un", "##able",
             "中", "文", "##ing", "run", "naive"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    texts = ["The quick brown fox jumps over the lazy dog.", "Café! naïve $5 unable",
             "中文 running jumped\tover\x00 the  dog", "", "xyzzy " * 200,
             "a" * 150 + " fox"]
    t, j = TW.BertTokenizer(str(path)), JW.BertTokenizer(str(path))
    for text in texts:
        assert t.tokenize(text) == j.tokenize(text)
    for length in (8, 128):
        ti, ta = t(texts, max_length=length)
        ji, ja = j(texts, max_length=length)
        assert np.array_equal(ti, ji) and np.array_equal(ta, ja) and ti.dtype == ji.dtype


def test_hash_tokenizer_is_the_jax_packages():
    texts = ["Hello world", "", "word " * 300, "Ünïcode and punctuation, too!"]
    got, want = TT._HashTokenizer()(texts), JT._HashTokenizer()(texts)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_tower_matches_flax_at_two_layers(monkeypatch):
    model, params = _flax(2, monkeypatch)
    ids, attn = _inputs(1, 6, [1, 2, 17, 64, 127, 128])
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(attn)))
    got = _run_port(_port(TT.params_from_jax(params), 2), ids, attn)
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_tower_matches_flax_at_full_width(monkeypatch):
    model, params = _flax(JT.LAYERS, monkeypatch, seed=3)
    ids, attn = _inputs(2, 4, [5, 128, 40, 1])
    want = np.asarray(model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(attn)))
    enc = _port(TT.params_from_jax(params), TT.LAYERS)
    assert len(enc.layers) == 12 and enc.tok_embed.weight.shape == (30522, 384)
    assert enc.layers[0].fc1.weight.shape == (1536, 384)
    np.testing.assert_allclose(_run_port(enc, ids, attn), want, atol=TOWER_ATOL, rtol=0)


def test_random_init_has_the_flax_distributions():
    enc = TT.BertEncoder(layers=2).random_init(0)
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    assert abs(sd["tok_embed.weight"].std() - 1 / np.sqrt(384)) < 1e-3
    for k in ("pos_embed", "tt_embed"):
        assert abs(sd[k].std() - 0.02) < 3e-3
    for k, fan_in in (("layers.0.query.weight", 384), ("layers.1.out.weight", 384),
                      ("layers.0.fc1.weight", 384), ("layers.1.fc2.weight", 1536)):
        std = 1 / np.sqrt(fan_in)
        assert abs(sd[k].std() - std) < 0.02 * std
        assert np.abs(sd[k]).max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert all((sd[k] == 0).all() for k in sd if k.endswith(".bias"))
    assert all((sd[k] == 1).all() for k in sd if "ln" in k and k.endswith(".weight"))
    again = TT.BertEncoder(layers=2).random_init(0).state_dict()
    assert all(torch.equal(again[k], v) for k, v in enc.state_dict().items())


def _hf_checkpoint(seed, layers, scale=0.05):
    """HF BERT names and shapes, small random values (LayerNorm near 1)."""
    rng = np.random.default_rng(seed)
    h, f = JT.HIDDEN, JT.FFN

    def w(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    t = {"embeddings.word_embeddings.weight": w(JT.VOCAB, h),
         "embeddings.position_embeddings.weight": w(JT.MAX_LEN, h),
         "embeddings.token_type_embeddings.weight": w(2, h),
         "embeddings.LayerNorm.weight": 1 + w(h), "embeddings.LayerNorm.bias": w(h),
         "embeddings.position_ids": np.arange(JT.MAX_LEN)[None], "pooler.dense.weight": w(h, h)}
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            t[f"{p}.attention.self.{proj}.weight"] = w(h, h)
            t[f"{p}.attention.self.{proj}.bias"] = w(h)
        t[f"{p}.attention.output.dense.weight"] = w(h, h)
        t[f"{p}.attention.output.dense.bias"] = w(h)
        t[f"{p}.attention.output.LayerNorm.weight"] = 1 + w(h)
        t[f"{p}.attention.output.LayerNorm.bias"] = w(h)
        t[f"{p}.intermediate.dense.weight"] = w(f, h)
        t[f"{p}.intermediate.dense.bias"] = w(f)
        t[f"{p}.output.dense.weight"] = w(h, f)
        t[f"{p}.output.dense.bias"] = w(h)
        t[f"{p}.output.LayerNorm.weight"] = 1 + w(h)
        t[f"{p}.output.LayerNorm.bias"] = w(h)
    return t


@pytest.mark.parametrize("damage", [False, True])
def test_checkpoint_loads_alike_in_both_packages(tmp_path, monkeypatch, damage):
    """One synthetic ``.npz`` with HF names (``bert.`` prefixed; with
    ``damage`` one tensor missing, one misshapen and one unknown): the same
    ``mapped`` / ``problems`` / ``unused`` from both loaders and, undamaged,
    the same embeddings."""
    layers = 2
    ckpt = {f"bert.{k}": v for k, v in _hf_checkpoint(7, layers).items()}
    if damage:
        del ckpt["bert.encoder.layer.1.output.dense.bias"]
        ckpt["bert.encoder.layer.0.output.LayerNorm.bias"] = np.zeros(5, np.float32)
        ckpt["bert.stray.tensor"] = np.zeros(3, np.float32)
    path = str(tmp_path / "bge.npz")
    np.savez(path, **ckpt)
    model, params = _flax(layers, monkeypatch)
    jparams, jreport = JT.load_bert_weights(path, params)
    enc, treport = TT.load_bert_weights(path, TT.BertEncoder(layers=layers).random_init(0))
    assert treport == jreport
    assert treport["mapped"] == len(ckpt) - (4 if damage else 2)
    if damage:
        assert treport["problems"][0] == "shape encoder.layer.0.output.LayerNorm.bias: " \
            "got (5,), want (384,)"
        assert treport["problems"][1:] == ["missing encoder.layer.1.output.dense.bias"]
        assert treport["unused"] == ["encoder.layer.0.output.LayerNorm.bias", "stray.tensor"]
        return
    assert treport["problems"] == [] and treport["unused"] == []
    ids, attn = _inputs(4, 5, [3, 128, 60, 9, 1])
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(attn)))
    np.testing.assert_allclose(_run_port(enc, ids, attn), want, atol=TOWER_ATOL, rtol=0)
    assert TT.load_bert_weights(str(tmp_path / "none.npz"), enc)[1] == {
        "mapped": 0, "problems": [f"unreadable checkpoint {tmp_path / 'none.npz'}"],
        "unused": []}


def test_status_strings_are_the_jax_packages(monkeypatch, tmp_path):
    """Offline (no weights, no vocabulary): the same degradations in both
    packages, and the documents embed to unit vectors, equal documents
    bitwise equal at any row and in any batch size."""
    monkeypatch.delenv("ZEBRA_TPU_BGE_WEIGHTS", raising=False)
    monkeypatch.delenv("ZEBRA_TPU_BGE_VOCAB", raising=False)
    monkeypatch.setenv("ZEBRA_TPU_WEIGHTS_CACHE", str(tmp_path))
    for mod in (TT, JT):
        mod._tokenizer.cache_clear()
        mod._encoder.cache_clear()
    m = TT.BGESmallEn15(device="cpu")
    got = m.status()
    assert got == JT.BGESmallEn15().status()
    assert not got["semantic"] and len(got["degradations"]) == 2
    docs = [f"document number {i} about things".encode() for i in range(70)]
    one = m.embed_documents(docs[3:4])
    many = m.embed_documents(docs)
    assert many.shape == (70, 384)
    np.testing.assert_allclose(np.linalg.norm(many, axis=1), 1.0, rtol=1e-5)
    assert np.array_equal(one[0].view(np.uint32), many[3].view(np.uint32))
    assert np.array_equal(many[66].view(np.uint32), m.embed(docs[66]).view(np.uint32))
