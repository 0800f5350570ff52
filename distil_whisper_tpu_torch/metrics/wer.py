"""Word error rate + hallucination metrics (jiwer-equivalent, native), the
port's own copy of ``distil_whisper_tpu.metrics.wer``.

The reference delegates WER to ``evaluate``/``jiwer`` and hallucination stats
to ``jiwer.process_words`` + ``nltk.ngrams`` (reference
flax/run_long_form_transcription.py:524-550).  This module owns both:
Levenshtein alignment with substitution/insertion/deletion splits, and
repeated n-gram counting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class WordErrors:
    hits: int = 0
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    num_ref_words: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        denom = self.hits + self.substitutions + self.deletions
        return self.errors / denom if denom else 0.0

    # error-type rates relative to reference length (reference convention:
    # IER/SER/DER at flax/run_long_form_transcription.py:535-539)
    @property
    def ier(self) -> float:
        return self.insertions / self.num_ref_words if self.num_ref_words else 0.0

    @property
    def ser(self) -> float:
        return self.substitutions / self.num_ref_words if self.num_ref_words else 0.0

    @property
    def der(self) -> float:
        return self.deletions / self.num_ref_words if self.num_ref_words else 0.0

    def __add__(self, other: "WordErrors") -> "WordErrors":
        return WordErrors(
            hits=self.hits + other.hits,
            substitutions=self.substitutions + other.substitutions,
            insertions=self.insertions + other.insertions,
            deletions=self.deletions + other.deletions,
            num_ref_words=self.num_ref_words + other.num_ref_words,
        )


def align_words(ref: Sequence[str], hyp: Sequence[str]) -> WordErrors:
    """Levenshtein alignment with unit costs; ties resolved like jiwer
    (substitution preferred over insert+delete pairs)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, hits, subs, ins, dels) for ref[:i] vs hyp[:j]
    INF = 1 << 30
    prev = [(j, 0, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur: List[Tuple[int, int, int, int, int]] = [(i, 0, 0, 0, i)] + [None] * m  # type: ignore
        ri = ref[i - 1]
        for j in range(1, m + 1):
            if ri == hyp[j - 1]:
                c, h, s, ins, dl = prev[j - 1]
                cur[j] = (c, h + 1, s, ins, dl)
                continue
            sub_c, sub_h, sub_s, sub_i, sub_d = prev[j - 1]
            del_c, del_h, del_s, del_i, del_d = prev[j]
            ins_c, ins_h, ins_s, ins_i, ins_d = cur[j - 1]
            best = min(sub_c + 1, del_c + 1, ins_c + 1)
            if sub_c + 1 == best:
                cur[j] = (best, sub_h, sub_s + 1, sub_i, sub_d)
            elif del_c + 1 == best:
                cur[j] = (best, del_h, del_s, del_i, del_d + 1)
            else:
                cur[j] = (best, ins_h, ins_s, ins_i + 1, ins_d)
        prev = cur
    _, h, s, ins, dl = prev[m]
    return WordErrors(hits=h, substitutions=s, insertions=ins, deletions=dl,
                      num_ref_words=n)


def process_words(references: Sequence[str],
                  hypotheses: Sequence[str]) -> WordErrors:
    """Corpus-level WER stats over whitespace-tokenised pairs."""
    assert len(references) == len(hypotheses)
    total = WordErrors()
    for ref, hyp in zip(references, hypotheses):
        total = total + align_words(ref.split(), hyp.split())
    return total


def wer(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    return process_words(references, hypotheses).wer


def count_repeated_ngrams(text: str, n: int = 5) -> int:
    """Number of n-grams occurring more than once (hallucination signal;
    reference counts repeated 5-grams via nltk at
    flax/run_long_form_transcription.py:541-550)."""
    words = text.split()
    seen: Dict[Tuple[str, ...], int] = {}
    for i in range(len(words) - n + 1):
        g = tuple(words[i:i + n])
        seen[g] = seen.get(g, 0) + 1
    return sum(c - 1 for c in seen.values() if c > 1)
