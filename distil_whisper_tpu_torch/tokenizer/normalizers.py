"""Text normalizers for WER evaluation (Whisper-spec English + basic), the
port's own copy of ``distil_whisper_tpu.tokenizer.normalizers``.

Native implementations of the normalizers the reference imports from HF
(``EnglishTextNormalizer`` / ``BasicTextNormalizer``, chosen per language at
reference training/run_distillation.py:1113-1117).  Behaviour is pinned to the
Whisper-paper normalization spec; tests compare against the HF implementation
on a battery of adversarial strings.
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterator, List, Match, Optional, Union

try:
    import regex
except ImportError:  # pragma: no cover
    regex = None

# Diacritics that NFKD alone does not decompose.
ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Drop marks/symbols/punctuation, fold diacritics onto base letters."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in ADDITIONAL_DIACRITICS:
            out.append(ADDITIONAL_DIACRITICS[c])
        elif unicodedata.category(c) == "Mn":
            continue
        elif unicodedata.category(c)[0] in "MSP":
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Drop symbols/punctuation but keep diacritics."""
    return "".join(" " if unicodedata.category(c)[0] in "MSP" else c
                   for c in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.clean = (remove_symbols_and_diacritics if remove_diacritics
                      else remove_symbols)
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # drop bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)       # drop parenthesised asides
        s = self.clean(s).lower()
        if self.split_letters:
            if regex is None:  # pragma: no cover
                raise ImportError("split_letters requires the 'regex' package")
            s = " ".join(regex.findall(r"\X", s, regex.U))
        # NB: no strip() — the upstream basic normalizer keeps edge whitespace.
        return re.sub(r"\s+", " ", s)


# ----------------------------------------------------------------------
# English number normalizer (words -> digits), Whisper spec
# ----------------------------------------------------------------------


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic digits, preserving order.

    Handles cardinals, ordinals, "double/triple" digits, currency
    (pounds/dollars/cents), "point" decimals, per-cent, and plural/possessive
    suffixes — the rule set of the Whisper-paper normalizer.
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {name: i for i, name in enumerate(
            ["one", "two", "three", "four", "five", "six", "seven", "eight",
             "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
             "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"],
            start=1)}
        self.ones_plural = {f"{name}s": (value, "s")
                            for name, value in self.ones.items()}
        self.ones_ordinal = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
            **{name + ("h" if name.endswith("t") else "th"): (value, "th")
               for name, value in self.ones.items()
               if value > 3 and value != 5 and value != 12},
        }
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
                     "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
        self.tens_plural = {name.replace("y", "ies"): (value, "s")
                            for name, value in self.tens.items()}
        self.tens_ordinal = {name.replace("y", "ieth"): (value, "th")
                             for name, value in self.tens.items()}
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = {
            "hundred": 100, "thousand": 1_000, "million": 1_000_000,
            "billion": 1_000_000_000, "trillion": 1_000_000_000_000,
            "quadrillion": 1_000_000_000_000_000,
            "quintillion": 1_000_000_000_000_000_000,
            "sextillion": 1_000_000_000_000_000_000_000,
            "septillion": 1_000_000_000_000_000_000_000_000,
            "octillion": 1_000_000_000_000_000_000_000_000_000,
            "nonillion": 1_000_000_000_000_000_000_000_000_000_000,
            "decillion": 1_000_000_000_000_000_000_000_000_000_000_000,
        }
        self.multipliers_plural = {f"{name}s": (value, "s")
                                   for name, value in self.multipliers.items()}
        self.multipliers_ordinal = {f"{name}th": (value, "th")
                                    for name, value in self.multipliers.items()}
        self.multipliers_suffixed = {**self.multipliers_plural,
                                     **self.multipliers_ordinal}
        self.decimals = {*self.ones, *self.tens, *self.zeros}

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+"}
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢"}
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values())
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = {key for mapping in [
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials] for key in mapping}
        self.literal_words = {"one", "ones"}

    def process_words(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def to_fraction(s: str) -> Optional[Fraction]:
            try:
                return Fraction(s)
            except ValueError:
                return None

        def output(result: Union[str, int]) -> str:
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = None
            prefix = None
            return result

        if len(words) == 0:
            return

        for i, current in enumerate(words):
            prev = words[i - 1] if i != 0 else None
            next_ = words[i + 1] if i != len(words) - 1 else None
            if skip:
                skip = False
                continue

            next_is_numeric = next_ is not None and re.match(r"^\d+(\.\d+)?$", next_)
            has_prefix = current[0] in self.prefixes
            current_without_prefix = current[1:] if has_prefix else current
            if re.match(r"^\d+(\.\d+)?$", current_without_prefix):
                # digit literal, possibly signed or fractional/decimal
                f = to_fraction(current_without_prefix)
                if f is None:
                    raise ValueError("Converting the fraction failed")
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # a pending "n." glues onto the digits (decimal
                        # fractions, ip-address-like runs)
                        value = str(value) + str(current)
                        continue
                    else:
                        yield output(value)
                prefix = current[0] if has_prefix else prefix
                if f.denominator == 1:
                    value = f.numerator  # whole number -> keep it an int
                else:
                    value = current_without_prefix
            elif current not in self.words:
                # ordinary word: flush any pending number, pass it through
                if value is not None:
                    yield output(value)
                yield output(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones:
                ones = self.ones[current]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:  # "twenty one": fill the 0
                        assert isinstance(value, str)
                        value = value[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    if value % 10 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
                else:  # teens merge only onto a clean hundreds boundary
                    if value % 100 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
            elif current in self.ones_suffixed:
                # suffixed form ("first", "ones"): terminal — emit now
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield output(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert isinstance(value, str)
                        yield output(value[:-1] + str(ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                else:  # teens merge only onto a clean hundreds boundary
                    if value % 100 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                value = None
            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    if value % 100 == 0:
                        value += tens
                    else:
                        value = str(value) + str(tens)
            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield output(str(tens) + suffix)
                elif isinstance(value, str):
                    yield output(str(value) + str(tens) + suffix)
                else:
                    if value % 100 == 0:
                        yield output(str(value + tens) + suffix)
                    else:
                        yield output(str(value) + str(tens) + suffix)
            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield output(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield output(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield output(str(p.numerator) + suffix)
                    else:
                        yield output(value)
                        yield output(str(multiplier) + suffix)
                else:  # accumulated int: scale the sub-thousand residue
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield output(str(value) + suffix)
                value = None
            elif current in self.preceding_prefixers:
                # sign-like words ("minus", "negative") become a prefix only
                # when a number actually follows
                if value is not None:
                    yield output(value)
                if next_ in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield output(current)
            elif current in self.following_prefixers:
                # currency words prefix the number they FOLLOW ("five dollars"
                # -> "$5"); bare currency words pass through
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield output(value)
                else:
                    yield output(current)
            elif current in self.suffixers:
                # words rendered as a trailing symbol on the number
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if next_ in suffix:
                            yield output(str(value) + suffix[next_])
                            skip = True
                        else:
                            yield output(value)
                            yield output(current)
                    else:
                        yield output(str(value) + suffix)
                else:
                    yield output(current)
            elif current in self.specials:
                if next_ not in self.words and not next_is_numeric:
                    # special forms bind only when a numeric word follows
                    if value is not None:
                        yield output(value)
                    yield output(current)
                elif current == "and":
                    # the "and" inside a multiplier chain ("one hundred and
                    # five") is silent; elsewhere it is an ordinary word
                    if prev not in self.multipliers:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current in ("double", "triple"):
                    if next_ in self.ones or next_ in self.zeros:
                        repeats = 2 if current == "double" else 3
                        ones = self.ones.get(next_, 0)
                        value = str(value or "") + str(ones) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current == "point":
                    if next_ in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:  # pragma: no cover
                    raise ValueError(f"Unexpected token: {current}")
            else:  # pragma: no cover
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield output(value)

    def preprocess(self, s: str) -> str:
        # "<number> and a half" reads as a decimal: rewrite to "point five"
        # (only when the preceding word really is numeric)
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                results.append(segment)
            else:
                results.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)
        # split glued digit/letter runs so the FSM sees separate words...
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        # ...except ordinal/plural suffixes, which re-attach
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: Match) -> str:
            try:
                currency = m.group(1)
                integer = m.group(2)
                cents = int(m.group(3))
                return f"{currency}{integer}.{cents:02d}"
            except ValueError:  # pragma: no cover
                return m.string

        def extract_cents(m: Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:  # pragma: no cover
                return m.string

        # fold cents into the dollar amount: "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # a lone "1"/"1s" reads better spelled out
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(word for word in self.process_words(s.split()) if word is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British->American spelling map (loaded from a checkpoint's
    ``normalizer.json`` when available)."""

    def __init__(self, english_spelling_mapping: Optional[Dict[str, str]] = None):
        self.mapping = english_spelling_mapping or {}

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    def __init__(self, english_spelling_mapping: Optional[Dict[str, str]] = None):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            # fixed-form contractions with irregular expansions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # abbreviated titles (the trailing space guards re-splitting)
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # perfect-tense 'd/'s before the handful of participles where
            # the expansion is unambiguous (a full participle list would be
            # open-ended)
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",  # no "'s done": is/has both plausible
            r"'s got\b": " has got",
            # regular clitic expansions
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer(
            english_spelling_mapping)

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # drop bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)       # drop parenthesised asides
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # re-attach floating apostrophes
        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # keep only decimal points
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")  # spare number symbols
        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)
        # number symbols that ended up unattached to digits are noise
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)  # collapse whitespace runs
        return s.strip()
