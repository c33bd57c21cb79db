"""Pure-Python BERT tokenizer (BasicTokenizer + WordPiece), the port's copy
of ``zebra_tpu/models/wordpiece.py``.

The uncased-BERT pipeline BGE-small-en-v1.5 uses: text cleaning,
lowercasing and accent stripping, punctuation / CJK splitting, then greedy
longest-match WordPiece with ``##`` continuation pieces. Only a
``vocab.txt`` is needed: no network, no ``transformers``. Matched to the
original BERT release's ``tokenization.py``.
"""

from __future__ import annotations

import unicodedata


def load_vocab(path: str) -> dict[str, int]:
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-letter/digit ranges count as punctuation (matches BERT, which
    # treats ``$``, ``^`` etc. as splittable even though Unicode disagrees)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing."""

    def __init__(self, lower_case: bool = True):
        self.lower_case = lower_case

    def tokenize(self, text: str) -> list[str]:
        # clean: drop control chars and U+0000/U+FFFD, normalise whitespace
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        text = "".join(out)
        # pad CJK ideographs with spaces (each becomes its own token)
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        text = "".join(out)

        tokens: list[str] = []
        for tok in text.split():
            if self.lower_case:
                tok = tok.lower()
                # strip accents (NFD decompose, drop combining marks)
                tok = "".join(
                    c for c in unicodedata.normalize("NFD", tok)
                    if unicodedata.category(c) != "Mn"
                )
            # split on punctuation
            buf: list[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if buf:
                        tokens.append("".join(buf))
                        buf = []
                    tokens.append(ch)
                else:
                    buf.append(ch)
            if buf:
                tokens.append("".join(buf))
        return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenizer over a BERT vocab."""

    def __init__(self, vocab: dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    def tokenize(self, word: str) -> list[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """Full pipeline: basic split -> WordPiece -> ids with specials/padding."""

    def __init__(self, vocab_path: str, lower_case: bool = True):
        self.vocab = load_vocab(vocab_path)
        self.basic = BasicTokenizer(lower_case=lower_case)
        self.wordpiece = WordPieceTokenizer(self.vocab)
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.pad_id = self.vocab["[PAD]"]

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def encode(self, text: str, max_length: int) -> list[int]:
        ids = [self.vocab.get(t, self.vocab.get("[UNK]", 0)) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def __call__(self, texts: list[str], max_length: int = 128):
        """Batch encode to padded ``(ids [n, L] int32, attention [n, L] bool)``."""
        import numpy as np

        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int32)
        attn = np.zeros((len(texts), max_length), dtype=bool)
        for i, t in enumerate(texts):
            row = self.encode(t, max_length)
            ids[i, : len(row)] = row
            attn[i, : len(row)] = True
        return ids, attn
