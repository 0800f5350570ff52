"""Whisper tokenizer (the port's own copy): BPE + special-token layout +
timestamp handling + the strided-chunk ASR merge.

Owns natively what the reference gets from HF ``WhisperTokenizer``
(SURVEY.md §2.6): the special-token layout (SOT / language / task /
notimestamps / prev / nospeech / eos), the 1501 arithmetic timestamp tokens
<|0.00|>..<|30.00|> (timestamp_begin = vocab - 1501, cf. reference
training/run_distillation.py:980-982), prompt construction, and
``decode_asr`` — the timestamp-driven merge of overlapping strided chunks used
by the chunked long-form pipeline (reference pipeline.py:353-375).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .bpe import ByteLevelBPE
from .languages import LANGUAGES, TO_LANGUAGE_CODE

TIME_PRECISION = 0.02


class WhisperTokenizer:
    """Loads from a local HF Whisper checkpoint dir (vocab.json + merges.txt,
    added_tokens.json, or tokenizer.json)."""

    def __init__(self, bpe: ByteLevelBPE, added_tokens: Dict[str, int],
                 spelling_mapping: Optional[Dict[str, str]] = None):
        self.bpe = bpe
        self.added_tokens = dict(added_tokens)
        self.inv_added = {v: k for k, v in self.added_tokens.items()}
        self.spelling_mapping = spelling_mapping or {}

        def find(tok: str) -> Optional[int]:
            if tok in self.added_tokens:
                return self.added_tokens[tok]
            return self.bpe.vocab.get(tok)

        self.eos = find("<|endoftext|>")
        self.sot = find("<|startoftranscript|>")
        self.translate = find("<|translate|>")
        self.transcribe = find("<|transcribe|>")
        self.sot_prev = find("<|startofprev|>")
        self.no_speech = find("<|nospeech|>") or find("<|nocaptions|>")
        self.no_timestamps = find("<|notimestamps|>")
        if self.no_timestamps is None:
            raise ValueError("checkpoint tokenizer lacks <|notimestamps|>")
        self.timestamp_begin = self.no_timestamps + 1
        self.vocab_size = self.timestamp_begin + 1501

        self.lang_to_id = {}
        for code in LANGUAGES:
            tid = find(f"<|{code}|>")
            if tid is not None:
                self.lang_to_id[code] = tid
        self.id_to_lang = {v: k for k, v in self.lang_to_id.items()}

        # every id >= eos is a special/added/timestamp token
        self._first_special = self.eos

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str) -> "WhisperTokenizer":
        p = Path(path)
        added: Dict[str, int] = {}
        if (p / "vocab.json").exists() and (p / "merges.txt").exists():
            bpe = ByteLevelBPE.from_files(str(p / "vocab.json"),
                                          str(p / "merges.txt"))
            if (p / "added_tokens.json").exists():
                with open(p / "added_tokens.json", encoding="utf-8") as f:
                    added = json.load(f)
        elif (p / "tokenizer.json").exists():
            bpe = ByteLevelBPE.from_tokenizer_json(str(p / "tokenizer.json"))
            with open(p / "tokenizer.json", encoding="utf-8") as f:
                tj = json.load(f)
            added = {t["content"]: t["id"] for t in tj.get("added_tokens", [])}
        else:
            raise FileNotFoundError(f"no tokenizer artifacts in {path}")
        spelling = None
        if (p / "normalizer.json").exists():
            with open(p / "normalizer.json", encoding="utf-8") as f:
                spelling = json.load(f)
        return cls(bpe, added, spelling)

    # ------------------------------------------------------------------
    # encode / decode
    # ------------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        """Plain-text BPE encode (no special tokens added)."""
        return self.bpe.encode(text)

    def encode_transcript(self, text: str) -> List[int]:
        """Encode a string that may embed special/timestamp markers
        (``<|...|>``) — how pseudo-label transcripts are stored on disk."""
        import re
        out: List[int] = []
        pos = 0
        for m in re.finditer(r"<\|[^|<>]*\|>", text):
            if m.start() > pos:
                out.extend(self.bpe.encode(text[pos:m.start()]))
            marker = m.group(0)
            inner = marker[2:-2]
            if marker in self.added_tokens:
                out.append(self.added_tokens[marker])
            else:
                try:
                    out.append(self.timestamp_token(float(inner)))
                except ValueError:
                    out.extend(self.bpe.encode(marker))
            pos = m.end()
        if pos < len(text):
            out.extend(self.bpe.encode(text[pos:]))
        return out

    def build_transcript_ids(self, text: str, language: Optional[str] = None,
                             task: str = "transcribe",
                             timestamps: bool = False) -> List[int]:
        """Full label sequence for plain text: prompt + text + eos (what HF's
        ``tokenizer(text)`` with special tokens produces for training)."""
        return (self.prompt_ids(language, task, no_timestamps=not timestamps)
                + self.encode(" " + text.strip()) + [self.eos])

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / TIME_PRECISION))

    def timestamp_value(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * TIME_PRECISION

    def id_to_token(self, i: int) -> str:
        if i >= self.timestamp_begin:
            return f"<|{self.timestamp_value(i):.2f}|>"
        if i in self.inv_added:
            return self.inv_added[i]
        piece = self.bpe.id_to_piece(i)
        return piece if piece is not None else ""

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True,
               decode_with_timestamps: bool = False) -> str:
        out: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                out.append(self.bpe.decode(run))
                run.clear()

        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                if decode_with_timestamps:
                    flush()
                    out.append(f"<|{self.timestamp_value(i):.2f}|>")
                continue
            if i >= self._first_special or i in self.inv_added:
                if not skip_special_tokens:
                    flush()
                    out.append(self.id_to_token(i))
                continue
            run.append(i)
        flush()
        return "".join(out)

    # ------------------------------------------------------------------
    # prompts
    # ------------------------------------------------------------------
    def prompt_ids(self, language: Optional[str] = None,
                   task: str = "transcribe",
                   no_timestamps: bool = True) -> List[int]:
        """[SOT, <|lang|>, <|task|>, (<|notimestamps|>)] decoder prompt."""
        ids = [self.sot]
        if language is not None:
            code = TO_LANGUAGE_CODE.get(language.lower(), language.lower())
            if code not in self.lang_to_id:
                raise ValueError(f"unknown language {language!r}")
            ids.append(self.lang_to_id[code])
            if task == "translate":
                ids.append(self.translate)
            else:
                ids.append(self.transcribe)
        if no_timestamps:
            ids.append(self.no_timestamps)
        return ids

    def previous_text_prompt(self, text: str, max_len: int = 223) -> List[int]:
        """<|startofprev|> + (tail-truncated) previous-context tokens."""
        toks = self.encode(" " + text.strip())
        return [self.sot_prev] + toks[-max_len:]

    def strip_prompt(self, ids: List[int]) -> List[int]:
        """Drop a leading <|startofprev|>...<|startoftranscript|> prefix."""
        if ids and ids[0] == self.sot_prev:
            if self.sot in ids:
                return ids[ids.index(self.sot):]
        return ids

    # ------------------------------------------------------------------
    # ASR chunk merge (semantics of HF tokenization_whisper._decode_asr)
    # ------------------------------------------------------------------
    def decode_asr(self, model_outputs: List[Dict[str, Any]], *,
                   return_timestamps: Union[bool, str] = False,
                   return_language: bool = False,
                   time_precision: float = TIME_PRECISION,
                   segment_size: int = 1500
                   ) -> Tuple[str, Dict[str, Any]]:
        """Merge overlapping strided chunk outputs into one transcript.

        Each element of ``model_outputs`` is ``{"tokens": List[int]}`` with an
        optional ``"stride": (chunk_len_s, left_s, right_s)``.  Timestamps
        inside a stride region are deferred; text across chunk boundaries is
        reconciled with a sliding longest-common-sequence merge.
        """
        ts_begin = self.timestamp_begin
        last_language: Optional[str] = None

        def new_chunk():
            return {"language": last_language, "timestamp": [None, None],
                    "text": ""}

        chunks: List[Dict[str, Any]] = []
        chunk = new_chunk()
        time_offset = 0.0
        previous_tokens: List[List[int]] = []
        skip = False
        right_stride_start = None

        for output in model_outputs:
            token_ids = [int(t) for t in output["tokens"]]
            token_ids = self.strip_prompt(token_ids)

            last_timestamp = None
            first_timestamp = ts_begin
            # multi-segment (sequential long-form) bookkeeping
            cur_max_timestamp = 0.0
            prev_segments_len = 0.0
            penultimate_timestamp = 0.0

            if "stride" in output and output["stride"] is not None:
                chunk_len, stride_left, stride_right = output["stride"]
                time_offset -= stride_left
                right_stride_start = chunk_len - stride_right
                if stride_left:
                    first_timestamp = stride_left / time_precision + ts_begin
                if stride_right:
                    for token in reversed(token_ids):
                        if token >= ts_begin:
                            if (last_timestamp is not None and
                                    (token - ts_begin) * time_precision
                                    < right_stride_start):
                                break
                            last_timestamp = token

            current_tokens: List[int] = []

            for i, token in enumerate(token_ids):
                if token >= self.vocab_size:
                    continue
                lang = self.id_to_lang.get(token)
                if lang is not None:
                    # language token: may split chunks when language changes
                    if (last_language and lang != last_language
                            and not return_timestamps):
                        previous_tokens.append(current_tokens)
                        resolved = _longest_common_sequence(previous_tokens)
                        chunk["text"] = self.decode(resolved)
                        chunks.append(chunk)
                        previous_tokens = []
                        current_tokens = []
                        chunk = new_chunk()
                    chunk["language"] = lang
                    last_language = lang
                elif token >= ts_begin:
                    timestamp = (token - ts_begin) * time_precision
                    if timestamp < cur_max_timestamp:
                        # a new inner segment started (sequential long-form)
                        last_was_single_ending = i >= 2 and not (
                            token_ids[i - 1] >= ts_begin
                            and token_ids[i - 2] >= ts_begin)
                        if last_was_single_ending:
                            prev_segments_len += time_precision * segment_size
                        else:
                            cur_max_timestamp = penultimate_timestamp
                            prev_segments_len += penultimate_timestamp
                    penultimate_timestamp = cur_max_timestamp
                    cur_max_timestamp = timestamp

                    time = round(timestamp + time_offset + prev_segments_len, 2)
                    if last_timestamp and token >= last_timestamp:
                        # falls in the right stride: defer to the next chunk
                        skip = True
                    elif skip or (previous_tokens and token < first_timestamp):
                        skip = False
                    elif chunk["timestamp"][0] is None:
                        chunk["timestamp"][0] = time
                    else:
                        if time == chunk["timestamp"][0]:
                            # duplicate timestamp: treat as a fresh start
                            pass
                        else:
                            chunk["timestamp"][1] = time
                            previous_tokens.append(current_tokens)
                            resolved = _longest_common_sequence(previous_tokens)
                            chunk["text"] = self.decode(resolved)
                            chunks.append(chunk)
                            previous_tokens = []
                            current_tokens = []
                            chunk = new_chunk()
                elif token >= self._first_special or token in self.inv_added:
                    pass  # non-language special token
                else:
                    current_tokens.append(token)

            if "stride" in output and output["stride"] is not None:
                time_offset += chunk_len - stride_right

            if current_tokens:
                previous_tokens.append(current_tokens)
            elif not any(previous_tokens):
                chunk = new_chunk()
                previous_tokens = []
                current_tokens = []

        if previous_tokens:
            resolved = _longest_common_sequence(previous_tokens)
            chunk["text"] = self.decode(resolved)
            chunks.append(chunk)

        full_text = "".join(c["text"] for c in chunks)
        optional: Dict[str, Any] = {}
        if return_timestamps or return_language:
            for c in chunks:
                if not return_timestamps:
                    c.pop("timestamp")
                else:
                    c["timestamp"] = tuple(c["timestamp"])
                if not return_language:
                    c.pop("language")
            optional = {"chunks": chunks}
        return full_text, optional


def _longest_common_sequence(sequences: List[List[int]]) -> List[int]:
    """Greedy pairwise sliding-window merge of overlapping token sequences.

    For each adjacent pair, find the alignment with the highest match ratio
    (an i/10000 epsilon favours longer perfect overlaps), then stitch at the
    overlap midpoint — trusting the left sequence for the left half and the
    right sequence for the right half.
    """
    left = list(sequences[0])
    total: List[int] = []
    for right in sequences[1:]:
        ln, rn = len(left), len(right)
        best = 0.0
        best_idx = (ln, ln, 0, 0)
        for i in range(1, ln + rn):
            eps = i / 10000.0
            ls, lstop = max(0, ln - i), min(ln, ln + rn - i)
            rs, rstop = max(0, i - ln), min(rn, i)
            lseg = left[ls:lstop]
            rseg = right[rs:rstop]
            matches = sum(1 for a, b in zip(lseg, rseg) if a == b)
            matching = matches / i + eps
            if matches > 1 and matching > best:
                best = matching
                best_idx = (ls, lstop, rs, rstop)
        ls, lstop, rs, rstop = best_idx
        lmid = (lstop + ls) // 2
        rmid = (rstop + rs) // 2
        total.extend(left[:lmid])
        left = list(right[rmid:])
    total.extend(left)
    return total
