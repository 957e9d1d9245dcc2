"""Frozen copy of the port's WordPiece tokenizer and vocabulary maker.

Copied from ``legal_rag_tpu_torch/models/wordpiece.py`` (itself the JAX
package's host code) so that the plain reference tokenizes queries and
pairs without importing the program, and so that the vocabulary the
benchmark builds cannot move with later changes to the program. The
benchmark builds each store's vocabulary with :func:`build_wordpiece_vocab`
and hands it to both sides.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)
_MAX_WORD_CHARS = 200  # words longer than this become [UNK] (BERT rule)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicode doesn't
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


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """BERT basic tokenization: clean, (lowercase + strip accents),
    space out CJK, split punctuation into standalone tokens."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        elif _is_whitespace(ch):
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    tokens: List[str] = []
    for word in "".join(cleaned).split():
        if lower:
            word = word.lower()
            word = "".join(
                c
                for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a fixed vocab."""

    def __init__(self, vocab: Dict[str, int], lower: bool = True):
        self.vocab = vocab
        self.lower = lower
        self.inv_vocab = {i: t for t, i in vocab.items()}
        for sp in (PAD, UNK, CLS, SEP):
            if sp not in vocab:
                raise ValueError(f"vocab missing special token {sp}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    @classmethod
    def from_vocab_file(cls, path, lower: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lower=lower)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > _MAX_WORD_CHARS:
            return [UNK]
        pieces: List[str] = []
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
                return [UNK]  # any unmatchable remainder voids the word
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, lower=self.lower):
            out.extend(self.wordpiece(word))
        return out

    def encode(
        self, text: str, max_len: int = 256, add_special: bool = True
    ) -> List[int]:
        """Token ids, [CLS]...[SEP]-wrapped and truncated to max_len."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special:
            ids = [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
        else:
            ids = ids[:max_len]
        return ids

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 256
    ):
        """Padded id / mask matrices for a batch (numpy int32) — see
        :func:`pad_and_bucket` for the shape contract."""
        encoded = [self.encode(t, max_len=max_len) for t in texts]
        return pad_and_bucket(encoded, max_len, self.pad_id)


def pad_and_bucket(encoded, max_len: int, pad_id: int):
    """Pad encoded id lists into [B, L] id/mask matrices.

    L is the batch max bucketed to the next power of two (min 32),
    capped at ``max_len`` — a handful of buckets means a handful of jit
    compilations instead of one per distinct length (compilation is
    expensive on remote-compile TPU setups). Single source of truth for
    both the Python and native tokenizers: shapes must never diverge
    between them or their jit caches split.
    """
    import numpy as np

    longest = max((len(e) for e in encoded), default=1)
    longest = max(32, 1 << (longest - 1).bit_length())
    longest = min(max_len, longest)
    ids = np.full((len(encoded), longest), pad_id, dtype=np.int32)
    mask = np.zeros((len(encoded), longest), dtype=np.int32)
    for i, e in enumerate(encoded):
        e = e[:longest]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return ids, mask


def build_wordpiece_vocab(
    texts: Iterable[str],
    size: int = 30522,
    lower: bool = True,
    min_freq: int = 2,
) -> Dict[str, int]:
    """Corpus-driven WordPiece vocab.

    Not a full BPE trainer: specials + every observed character (and its
    ``##`` continuation form, so no word is untokenizable) + the most
    frequent whole words + most frequent word *suffixes* as continuation
    pieces. Deterministic for a given corpus.
    """
    from collections import Counter

    words: Counter = Counter()
    chars: set = set()
    for text in texts:
        for w in basic_tokenize(text, lower=lower):
            words[w] += 1
            chars.update(w)

    vocab: Dict[str, int] = {}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < size:
            vocab[tok] = len(vocab)

    for sp in SPECIALS:
        add(sp)
    for ch in sorted(chars):
        add(ch)
        add("##" + ch)
    # frequent suffix pieces make fragmented words shorter
    suffixes: Counter = Counter()
    for w, c in words.items():
        for cut in range(1, min(len(w), 8)):
            suffixes["##" + w[cut:]] += c
    for w, c in words.most_common():
        if c < min_freq:
            break
        add(w)
    for s, c in suffixes.most_common(max(0, size - len(vocab))):
        if c < min_freq * 4:
            break
        add(s)
    return vocab
