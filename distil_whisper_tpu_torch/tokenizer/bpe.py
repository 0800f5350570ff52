"""Byte-level BPE (GPT-2 family), self-contained (the port's own copy).

Whisper's text tokenizer is a byte-level BPE with the GPT-2 pre-tokenisation
regex.  This module owns encode/decode natively — the reference outsources it
to HF ``WhisperTokenizer`` (SURVEY.md §2.6) — loading the same ``vocab.json`` +
``merges.txt`` artifacts that ship with every Whisper checkpoint.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional, Tuple

def _category_class(prefix: str) -> str:
    """A regex character-class body listing every code point whose Unicode
    general category starts with ``prefix`` (``"L"`` letters, ``"N"``
    numbers), as ranges, from this Python's ``unicodedata``."""
    import sys
    import unicodedata
    ranges, start = [], None
    for cp in range(sys.maxunicode + 2):
        inside = (cp <= sys.maxunicode
                  and unicodedata.category(chr(cp)).startswith(prefix))
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def stdlib_pattern():
    """The GPT-2 pre-tokenisation pattern for the stdlib ``re``, which has
    no \\p{...} classes.  Its \\w and \\d do not split as \\p{L} and
    \\p{N} do (\\w also holds numbers such as ², ½ and Ⅻ, \\d only
    decimal digits), so the letter (L*) and number (N*) classes are built
    from ``unicodedata``."""
    import re
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d"""
        rf"""| ?[{letters}]+| ?[{numbers}]+| ?[^\s{letters}{numbers}]+"""
        r"""|\s+(?!\S)|\s+""")


try:
    import regex as _re  # supports \p{L} classes (a transformers dependency)
    # GPT-2 pre-tokenisation pattern (also used by Whisper).
    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
except ImportError:
    _PAT = stdlib_pattern()


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPE:
    """Encoder/decoder over a vocab dict + ranked merge list."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "ByteLevelBPE":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_tokenizer_json(cls, tokenizer_json: str) -> "ByteLevelBPE":
        """Load from a fast-tokenizer ``tokenizer.json`` file."""
        with open(tokenizer_json, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        return cls(model["vocab"], merges)

    # ------------------------------------------------------------------
    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        result = tuple(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab[piece])
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.inv_vocab[i] for i in ids if i in self.inv_vocab)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace")

    def id_to_piece(self, i: int) -> Optional[str]:
        return self.inv_vocab.get(i)

    def __len__(self) -> int:
        return len(self.vocab)
