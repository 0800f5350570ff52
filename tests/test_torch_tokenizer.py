"""The port's pre-tokenisation without the ``regex`` package.

The port falls back to a stdlib ``re`` pattern when ``regex`` is missing,
as on hosts without ``transformers``.  Its letter and number classes come
from ``unicodedata`` (L* and N*), so that it splits as ``regex``'s
\\p{L} / \\p{N} pattern does, numerals such as ², ½ and Ⅻ included.
``regex`` is installed here: the fallback pattern is built by hand and
compared with the module's ``regex`` pattern, in pre-token splits and in
ids under merges that join every adjacent pair of the test strings (so a
pre-token boundary in another place changes the ids).
"""

import pytest

from distil_whisper_tpu_torch.tokenizer import bpe

pytest.importorskip("regex")

STRINGS = ["x²", "1½", "x² + 1½ = Ⅻ", "Ⅻ and 12", "²³¹ ⅓", "café naïve",
           "é combining", "漢字かな カナ", "हिन्दी भाषा २०२४",
           "it's 3rd _x_  ", "ä́b 42nd", "٣ arabic digits ١٢",
           "tab\tnew\nline  end"]


@pytest.fixture(scope="module")
def fallback():
    return bpe.stdlib_pattern()


def _tokenizer():
    enc = bpe.bytes_to_unicode()
    vocab = {u: i for i, u in enumerate(enc.values())}
    merges = []
    for text in STRINGS:
        units = "".join(enc[b] for b in text.encode("utf-8"))
        for pair in zip(units, units[1:]):
            if pair not in merges:
                merges.append(pair)
                vocab.setdefault(pair[0] + pair[1], len(vocab))
    return bpe.ByteLevelBPE(vocab, merges)


@pytest.mark.parametrize("text", STRINGS)
def test_fallback_splits_as_regex(fallback, text):
    assert fallback.findall(text) == bpe._PAT.findall(text)


def test_fallback_ids_equal_regex(fallback, monkeypatch):
    tok = _tokenizer()
    golden = [tok.encode(t) for t in STRINGS]
    monkeypatch.setattr(bpe, "_PAT", fallback)
    tok = _tokenizer()
    assert [tok.encode(t) for t in STRINGS] == golden
    assert [tok.decode(ids) for ids in golden] == STRINGS


def test_numerals_split_with_the_numbers(fallback):
    """² and ½ are numbers (No), Ⅻ a number (Nl): "x²" is two pre-tokens
    and "1½" one."""
    assert fallback.findall("x²") == ["x", "²"]
    assert fallback.findall("1½") == ["1½"]
    assert fallback.findall("Ⅻ1") == ["Ⅻ1"]
