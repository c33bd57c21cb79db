"""Text embedding: the BGE-small-en-v1.5 encoder in PyTorch (the port of
``zebra_tpu/models/text.py``).

BERT at BGE-small's published widths (12 layers, hidden 384, 12 heads, FFN
1536, vocabulary 30522, exact-erf GELU, LayerNorm eps 1e-12), CLS pooling
and L2 normalisation. The layers compute what the JAX package's Flax module
computes, in its order: LayerNorm's variance as E[x^2] - E[x]^2 clipped at
0, the query scaled by 1/sqrt(head dim) before its dot, masked scores set to
the f32 minimum. Every call embeds padded batches of one shape
(``batch_size`` x ``SEQ_LEN``), so equal documents get bitwise equal vectors
in any batch and at any row (``Database.deduplicate`` relies on it).

Weights: ``ZEBRA_TPU_BGE_WEIGHTS`` names a local ``model.safetensors`` /
``.npz`` (else the ``fetch-weights`` cache); every tensor is mapped and any
left at random init is reported. Without one the tower runs at random
init, drawn from a seeded ``torch.Generator`` with the Flax initialisers'
distributions (not JAX's stream: the packages' random towers differ).
Tokenizer: a local ``transformers`` cache, else the pure-Python WordPiece
(``ZEBRA_TPU_BGE_VOCAB`` or a ``vocab.txt`` beside the weights), else a
deterministic hashing tokenizer. ``BGESmallEn15.status()`` reports each
fallback as the JAX package does.
"""

from __future__ import annotations

import functools
import hashlib
import math
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from zebra_tpu_torch.index.base import default_device
from zebra_tpu_torch.models.base import DIM_BGESMALL_EN_1_5, BaseModel, upload
from zebra_tpu_torch.profiling import logger

VOCAB = 30522
HIDDEN = 384
LAYERS = 12
HEADS = 12
FFN = 1536
MAX_LEN = 512
SEQ_LEN = 128  # static padded length of every batch
LN_EPS = 1e-12  # HF BertConfig.layer_norm_eps


class LayerNorm(nn.Module):
    """Flax's ``LayerNorm``: the variance as E[x^2] - E[x]^2 clipped at 0,
    then ``(x - mean) * (rsqrt(var + eps) * weight) + bias``."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def self_attention(x: torch.Tensor, query: nn.Linear, key: nn.Linear, value: nn.Linear,
                   out: nn.Linear, heads: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head self-attention over ``x [n, L, hidden]`` as Flax's
    ``MultiHeadDotProductAttention`` computes it: the query scaled by
    1/sqrt(head dim) before its dot, masked scores (``mask`` False) set to
    the f32 minimum, softmax, the heads' outputs through ``out``. Shared by
    the BERT and ViT towers."""
    n, length, hidden = x.shape
    hd = hidden // heads

    def split(t):  # [n, L, hidden] -> [n, heads, L, hd]
        return t.view(n, length, heads, hd).transpose(1, 2)

    q = split(query(x)) / math.sqrt(hd)
    scores = q @ split(key(x)).transpose(-1, -2)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    h = torch.softmax(scores, -1) @ split(value(x))
    return out(h.transpose(1, 2).reshape(n, length, hidden))


def normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Flax's ``normal(std)`` initialiser, drawn from ``g``."""
    p.copy_(torch.randn(p.shape, generator=g) * std)


def init_dense_(module: nn.Module, g: torch.Generator) -> None:
    """Flax's defaults for every ``nn.Linear`` and :class:`LayerNorm` under
    ``module``, in module order: lecun-normal weights (truncated at two
    standard deviations, std 1/sqrt(fan_in), fan_in the Linear's input
    width), zero biases, unit LayerNorm scales."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            std = 1.0 / math.sqrt(mod.weight.shape[1]) / 0.87962566103423978
            mod.weight.copy_(nn.init.trunc_normal_(torch.empty(mod.weight.shape), std=std,
                                                   a=-2 * std, b=2 * std, generator=g))
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class BertLayer(nn.Module):
    """Self-attention (q/k/v/out projections with bias) and a GELU FFN, each
    followed by a post-LN residual."""

    def __init__(self, hidden: int, heads: int, ffn: int, eps: float):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.ln1 = LayerNorm(hidden, eps)
        self.fc1 = nn.Linear(hidden, ffn)
        self.fc2 = nn.Linear(ffn, hidden)
        self.ln2 = LayerNorm(hidden, eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self_attention(x, self.query, self.key, self.value, self.out,
                                        self.heads, mask))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x))))


class BertEncoder(nn.Module):
    """``(ids [n, L] int, attention [n, L] bool) -> [n, hidden]`` unit CLS
    vectors. Widths default to BGE-small's."""

    def __init__(self, vocab: int = VOCAB, hidden: int = HIDDEN, layers: int = LAYERS,
                 heads: int = HEADS, ffn: int = FFN, max_len: int = MAX_LEN,
                 ln_eps: float = LN_EPS):
        super().__init__()
        self.tok_embed = nn.Embedding(vocab, hidden)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, hidden))
        # single-segment inputs use row 0 only (the checkpoint's [2, hidden])
        self.tt_embed = nn.Parameter(torch.zeros(2, hidden))
        self.ln_embed = LayerNorm(hidden, ln_eps)
        self.layers = nn.ModuleList(BertLayer(hidden, heads, ffn, ln_eps) for _ in range(layers))

    def forward(self, ids: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        length = ids.shape[1]
        x = self.ln_embed(self.tok_embed(ids) + self.pos_embed[:length] + self.tt_embed[0])
        mask = attn[:, None, None, :]  # over heads and query positions
        for layer in self.layers:
            x = layer(x, mask)
        cls = x[:, 0]
        return cls / torch.clamp(torch.linalg.vector_norm(cls, dim=-1, keepdim=True), min=1e-12)

    @torch.no_grad()
    def random_init(self, seed: int) -> "BertEncoder":
        """Fill the parameters from ``torch.Generator(seed)`` with the Flax
        initialisers' distributions: the token table normal with std
        1/sqrt(hidden), position and token-type rows normal with std 0.02,
        every projection lecun-normal (truncated at two standard deviations,
        std 1/sqrt(fan_in)), zero biases and unit LayerNorm scales."""
        g = torch.Generator().manual_seed(seed)
        normal_(self.tok_embed.weight, 1.0 / math.sqrt(self.tok_embed.weight.shape[1]), g)
        normal_(self.pos_embed, 0.02, g)
        normal_(self.tt_embed, 0.02, g)
        init_dense_(self, g)
        return self


def params_from_jax(flax_params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX package's Flax parameter tree
    (numpy arrays): DenseGeneral kernels ``[hidden, heads, hd]`` /
    ``[heads, hd, hidden]`` reshaped to ``[hidden, hidden]`` and transposed,
    Dense kernels transposed, LayerNorm ``scale`` as ``weight``."""
    p = flax_params
    out = {"tok_embed.weight": p["tok_embed"]["embedding"],
           "pos_embed": np.asarray(p["pos_embed"])[0],
           "tt_embed": p["tt_embed"],
           "ln_embed.weight": p["ln_embed"]["scale"], "ln_embed.bias": p["ln_embed"]["bias"]}
    i = 0
    while f"layer{i}" in p:
        src, dst = p[f"layer{i}"], f"layers.{i}"
        for proj in ("query", "key", "value", "out"):
            kernel = np.asarray(src["attn"][proj]["kernel"])  # [in, heads, hd] / [heads, hd, out]
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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


#: checkpoint tensors that CLS-pooled inference legitimately leaves unused
_BERT_IGNORED_PREFIXES = ("pooler.", "cls.", "embeddings.position_ids")


def load_bert_weights(path: str, module: BertEncoder):
    """Map the full HF BERT / BGE parameter set onto ``module`` in place.

    Returns ``(module, report)``: ``report`` lists the tensors mapped, every
    mapping problem (missing tensor, shape mismatch) and every checkpoint
    tensor left unused, as the JAX package's loader does."""
    from zebra_tpu_torch.models.hfload import Mapper, read_checkpoint

    raw = read_checkpoint(path)
    if raw is None:
        return module, {"mapped": 0, "problems": [f"unreadable checkpoint {path}"],
                        "unused": []}
    raw = {(k[5:] if k.startswith("bert.") else k): np.asarray(v) for k, v in raw.items()}
    params = {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}
    m = Mapper(raw, params)
    put = m.put
    put("tok_embed.weight", "embeddings.word_embeddings.weight")
    put("pos_embed", "embeddings.position_embeddings.weight")
    put("tt_embed", "embeddings.token_type_embeddings.weight")
    put("ln_embed.weight", "embeddings.LayerNorm.weight")
    put("ln_embed.bias", "embeddings.LayerNorm.bias")
    for i in range(len(module.layers)):
        hf, ours = f"encoder.layer.{i}", f"layers.{i}"
        for proj in ("query", "key", "value"):
            put(f"{ours}.{proj}.weight", f"{hf}.attention.self.{proj}.weight")
            put(f"{ours}.{proj}.bias", f"{hf}.attention.self.{proj}.bias")
        put(f"{ours}.out.weight", f"{hf}.attention.output.dense.weight")
        put(f"{ours}.out.bias", f"{hf}.attention.output.dense.bias")
        put(f"{ours}.ln1.weight", f"{hf}.attention.output.LayerNorm.weight")
        put(f"{ours}.ln1.bias", f"{hf}.attention.output.LayerNorm.bias")
        put(f"{ours}.fc1.weight", f"{hf}.intermediate.dense.weight")
        put(f"{ours}.fc1.bias", f"{hf}.intermediate.dense.bias")
        put(f"{ours}.fc2.weight", f"{hf}.output.dense.weight")
        put(f"{ours}.fc2.bias", f"{hf}.output.dense.bias")
        put(f"{ours}.ln2.weight", f"{hf}.output.LayerNorm.weight")
        put(f"{ours}.ln2.bias", f"{hf}.output.LayerNorm.bias")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return module, m.report(_BERT_IGNORED_PREFIXES)


class _HashTokenizer:
    """Deterministic offline fallback: whitespace split and stable hashing
    into the BERT vocabulary's id space (not WordPiece, not semantic)."""

    cls_id, sep_id, pad_id = 101, 102, 0

    def __call__(self, texts: list[str]):
        ids = np.full((len(texts), SEQ_LEN), self.pad_id, dtype=np.int32)
        attn = np.zeros((len(texts), SEQ_LEN), dtype=bool)
        for i, t in enumerate(texts):
            toks = [self.cls_id]
            for w in t.lower().split()[: SEQ_LEN - 2]:
                h = int.from_bytes(hashlib.blake2s(w.encode()).digest()[:4], "little")
                toks.append(1000 + h % (VOCAB - 1100))
            toks.append(self.sep_id)
            ids[i, : len(toks)] = toks
            attn[i, : len(toks)] = True
        return ids, attn


def _resolve_weights_path() -> str:
    """``ZEBRA_TPU_BGE_WEIGHTS`` when set, else the ``fetch-weights`` cache."""
    env = os.environ.get("ZEBRA_TPU_BGE_WEIGHTS", "")
    if env:
        return env
    from zebra_tpu_torch.models.fetch import cached_weights

    return cached_weights("bge-small") or ""


def _find_vocab_file() -> str | None:
    cand = os.environ.get("ZEBRA_TPU_BGE_VOCAB", "")
    if cand and os.path.exists(cand):
        return cand
    weights = _resolve_weights_path()
    if weights:
        sibling = os.path.join(os.path.dirname(weights), "vocab.txt")
        if os.path.exists(sibling):
            return sibling
    return None


#: runtime health of the cached tokenizer and encoder, surfaced by
#: ``BGESmallEn15.status()`` -> ``Database.model_status()`` -> the CLI warning
_STATUS = {"tokenizer": "", "weights": ""}


@functools.lru_cache(maxsize=1)
def _tokenizer():
    try:  # a local HF cache only: never the network
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("BAAI/bge-small-en-v1.5", local_files_only=True)

        def call(texts):
            enc = tok(texts, padding="max_length", truncation=True, max_length=SEQ_LEN,
                      return_tensors="np")
            return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(bool)

        _STATUS["tokenizer"] = "hf"
        return call
    except Exception:
        pass
    vocab = _find_vocab_file()
    if vocab:
        from zebra_tpu_torch.models.wordpiece import BertTokenizer

        bt = BertTokenizer(vocab)

        def call(texts):
            return bt(texts, max_length=SEQ_LEN)

        _STATUS["tokenizer"] = "wordpiece"
        return call
    logger.warning(
        "bge-small: no tokenizer found (transformers cache or vocab.txt) — "
        "falling back to the non-semantic hashing tokenizer"
    )
    _STATUS["tokenizer"] = "hash"
    return _HashTokenizer()


@functools.lru_cache(maxsize=None)
def _encoder(seed: int, device: str) -> BertEncoder:
    """The encoder on ``device``: random init from ``seed``, then the
    checkpoint where one resolves."""
    model = BertEncoder().random_init(seed)
    weights = _resolve_weights_path()
    if weights and os.path.exists(weights):
        model, report = load_bert_weights(weights, model)
        if report["problems"]:
            logger.warning(
                "bge-small checkpoint %s: %d tensors NOT mapped (random init remains!): %s",
                weights, len(report["problems"]), report["problems"][:8])
            _STATUS["weights"] = "partial"
        else:
            logger.info("bge-small: loaded %d tensors from %s", report["mapped"], weights)
            _STATUS["weights"] = "loaded"
    else:
        if weights:
            logger.warning("ZEBRA_TPU_BGE_WEIGHTS=%s does not exist — random init", weights)
        _STATUS["weights"] = "random"
    return model.to(device).eval().requires_grad_(False)


class BGESmallEn15(BaseModel):
    """384-d text embeddings. Runs on the card unless given ``device``
    (``"cpu"`` for a CPU run); without a card and without ``device`` it
    raises (``index.base.default_device``)."""

    dim = DIM_BGESMALL_EN_1_5
    name = "bge-small-en-v1.5"

    def __init__(self, batch_size: int = 64, seed: int = 0, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a tensor-parallel tower (mesh=) is not ported to the torch package yet "
                "(ROADMAP.md queue 1, sharding)")
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device or default_device())

    def encoder(self) -> BertEncoder:
        """The cached encoder module on this model's device."""
        return _encoder(self.seed, str(self.device))

    def tokenize_padded(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """``(ids, attention)`` of one chunk padded to ``batch_size`` rows
        (padding rows attend to their first position only)."""
        ids, attn = _tokenizer()(texts)
        pad = self.batch_size - len(texts)
        if pad:
            ids = np.pad(ids, ((0, pad), (0, 0)))
            attn = np.pad(attn, ((0, pad), (0, 0)))
            attn[len(texts):, 0] = True  # no fully-masked rows
        return ids, attn

    def embed_documents(self, documents: list[bytes]) -> np.ndarray:
        texts = [d.decode("utf-8", errors="replace") for d in documents]
        enc = self.encoder()
        out = torch.empty((len(texts), self.dim), dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            for start in range(0, len(texts), self.batch_size):
                chunk = texts[start : start + self.batch_size]
                ids, attn = self.tokenize_padded(chunk)
                out[start : start + len(chunk)] = enc(upload(ids, self.device),
                                                      upload(attn, self.device))[: len(chunk)]
        return out.cpu().numpy()

    def status(self) -> dict:
        """The offline fallbacks, loudly: a user must be able to tell when
        "bge-small" is not doing semantic search because its weights or its
        tokenizer are absent here."""
        _tokenizer()
        self.encoder()
        degr = []
        if _STATUS["tokenizer"] == "hash":
            degr.append(
                "non-semantic hashing tokenizer (no transformers cache; set "
                "ZEBRA_TPU_BGE_VOCAB or place vocab.txt next to the weights)"
            )
        if _STATUS["weights"] == "random":
            degr.append(
                "random-init BGE weights (run `zebra-tpu fetch-weights "
                "bge-small` on a connected machine, or set "
                "ZEBRA_TPU_BGE_WEIGHTS to a pytorch_model.bin / "
                "model.safetensors checkpoint)"
            )
        elif _STATUS["weights"] == "partial":
            degr.append("BGE checkpoint only partially mapped (see log)")
        return {"semantic": not degr, "degradations": degr}
