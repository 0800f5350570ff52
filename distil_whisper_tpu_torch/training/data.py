"""Training data pipeline: label preparation, collation, WER filtering,
speaker-aware audio packing.

The port's own copy of ``distil_whisper_tpu.training.data`` (numpy, the
port's tokenizer and WER), with the same rules:

* WER-threshold filter incl. the all-caps hallucination reject.
* Per-sample timestamp keep-probability + <|notimestamps|> insertion at the
  task position, condition-on-prev prompting with the max_label_length // 2
  cutoff.
* Collator: shift-right into decoder_input_ids, -100 on pads and on
  everything up to and including <|startoftranscript|> when a prompt is
  present.
* Speaker-aware 30 s packing (pseudo-labelling) and <|startofprev|>
  prompt-column construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..metrics.wer import wer as compute_wer
from ..tokenizer import WhisperTokenizer
from .losses import LABEL_PAD


# ----------------------------------------------------------------------
# Filtering
# ----------------------------------------------------------------------


def is_wer_in_range(ground_truth: str, transcript: Optional[str],
                    normalizer: Callable[[str], str],
                    wer_threshold: float) -> bool:
    """Keep a pseudo-labelled sample iff WER(gt, pl) < threshold (in %)."""
    norm_gt = normalizer(ground_truth)
    if transcript is not None and transcript.upper() == transcript:
        # entirely upper-case transcripts are erroneous teacher generations
        return False
    if len(norm_gt) > 0 and transcript is not None:
        norm_pl = normalizer(transcript)
        return 100.0 * compute_wer([norm_gt], [norm_pl]) < wer_threshold
    return False


def in_length_range(audio_len_samples: int, label_len: int,
                    min_input: int, max_input: int,
                    min_label: int, max_label: int) -> bool:
    """Audio/label length gates."""
    return (min_input < audio_len_samples < max_input
            and min_label < label_len < max_label)


# ----------------------------------------------------------------------
# Label preparation
# ----------------------------------------------------------------------


def round_timestamp_ids(token_ids: Sequence[int], timestamp_begin: int,
                        ndigits: int = 1,
                        time_precision: float = 0.02) -> List[int]:
    """Round timestamp tokens to ``ndigits`` decimals of seconds, in
    token-id space (not on the rendered string)."""
    out = []
    for t in token_ids:
        if t >= timestamp_begin:
            seconds = round((t - timestamp_begin) * time_precision, 2)
            t = timestamp_begin + int(round(round(seconds, ndigits)
                                            / time_precision))
        out.append(int(t))
    return out


def prepare_labels(tokenizer: WhisperTokenizer, transcript: str,
                   *, is_pseudo_label: bool,
                   language: Optional[str], task: str = "transcribe",
                   prev_ids: Optional[List[int]] = None,
                   timestamp_probability: float = 0.2,
                   condition_on_prev_probability: float = 0.2,
                   max_label_length: int = 448,
                   round_timestamps: bool = False,
                   rng: Optional[np.random.Generator] = None) -> List[int]:
    """One training label sequence, mirroring prepare_train_dataset."""
    rng = rng or np.random.default_rng()
    nots = tokenizer.no_timestamps
    is_multilingual = len(tokenizer.lang_to_id) > 1
    timestamp_position = 3 if is_multilingual else 1
    prompt_cutoff = max_label_length // 2

    if is_pseudo_label:
        token_ids = tokenizer.encode_transcript(transcript)
    else:
        token_ids = tokenizer.build_transcript_ids(
            transcript, language=language, task=task, timestamps=False)

    has_timestamps = any(t > nots for t in token_ids)
    predict_timestamps = True
    if has_timestamps:
        predict_timestamps = bool(rng.binomial(1, timestamp_probability))
        if not predict_timestamps:
            token_ids = [t for t in token_ids if t < nots]
            token_ids.insert(timestamp_position, nots)
        elif round_timestamps:
            token_ids = round_timestamp_ids(token_ids,
                                            tokenizer.timestamp_begin)

    if not bool(rng.binomial(1, condition_on_prev_probability)):
        prev_ids = None

    if prev_ids is not None:
        if has_timestamps and not predict_timestamps:
            prev_ids = [t for t in prev_ids if t < nots]
        if len(prev_ids) > prompt_cutoff:
            prev_ids = prev_ids[-prompt_cutoff + 1:]
        if len(prev_ids + token_ids) + 1 > max_label_length:
            trim_length = len(token_ids) - max_label_length + 1
            prev_ids = prev_ids[trim_length:]
        token_ids = [tokenizer.sot_prev] + list(prev_ids) + token_ids
    return token_ids


def prev_prompt_from_output(tokenizer: WhisperTokenizer,
                            token_ids: Sequence[int]) -> List[int]:
    """Build the condition_on_prev column entry from a previous segment's
    generated ids: drop eos, drop the SOT/lang/task header, prepend
    <|startofprev|>."""
    is_multilingual = len(tokenizer.lang_to_id) > 1
    timestamp_position = 3 if is_multilingual else 1
    ids = [int(t) for t in token_ids if int(t) != tokenizer.eos]
    return [tokenizer.sot_prev] + ids[timestamp_position:]


# ----------------------------------------------------------------------
# Collation
# ----------------------------------------------------------------------


def shift_and_mask(label_ids: Sequence[Sequence[int]], *,
                   decoder_start_token_id: int, pad_token_id: int,
                   max_target_length: int,
                   pad_to_multiple_of: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """Pad label sequences, split into (decoder_input_ids, labels), and mask
    pads + prompt region with -100."""
    width = max(len(x) for x in label_ids)
    if pad_to_multiple_of:
        width = -(-width // pad_to_multiple_of) * pad_to_multiple_of
    width = min(max(width, 2), max_target_length)

    padded = np.full((len(label_ids), width), pad_token_id, np.int64)
    mask = np.zeros((len(label_ids), width), np.int64)
    for i, ids in enumerate(label_ids):
        ids = list(ids)[:width]
        padded[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1

    decoder_input_ids = padded[:, :-1]
    labels = padded[:, 1:].copy()
    labels[mask[:, 1:] != 1] = LABEL_PAD

    # mask everything up to and including SOT when a prompt precedes it
    is_sot = labels == decoder_start_token_id
    bos_index = np.argmax(is_sot, axis=1)
    bos_index = np.where(bos_index > 0, bos_index + 1, bos_index)
    prompt_mask = np.arange(labels.shape[1])[None, :] < bos_index[:, None]
    labels = np.where(prompt_mask, LABEL_PAD, labels)
    return {"decoder_input_ids": decoder_input_ids.astype(np.int32),
            "labels": labels.astype(np.int32)}


@dataclasses.dataclass
class Collator:
    """features (mel arrays) + label id lists -> fixed-shape numpy batch."""
    decoder_start_token_id: int
    pad_token_id: int
    max_target_length: int = 448
    pad_target_to_multiple_of: Optional[int] = 32

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        feats = np.stack([np.asarray(s["input_features"], np.float32)
                          for s in samples])
        out = shift_and_mask(
            [s["labels"] for s in samples],
            decoder_start_token_id=self.decoder_start_token_id,
            pad_token_id=self.pad_token_id,
            max_target_length=self.max_target_length,
            pad_to_multiple_of=self.pad_target_to_multiple_of)
        out["input_features"] = feats
        return out


# ----------------------------------------------------------------------
# Speaker-aware packing (pseudo-labelling front half)
# ----------------------------------------------------------------------


def pack_samples_iter(samples: Iterable[Dict[str, Any]],
                      max_input_samples: int = 480_000,
                      audio_key: str = "audio", text_key: str = "text",
                      speaker_key: Optional[str] = "speaker_id"
                      ) -> Iterable[Dict[str, Any]]:
    """Streaming speaker-aware packer: concatenate consecutive same-speaker
    utterances up to 30 s; mark packed samples whose predecessor shares the
    speaker with condition_on_prev=1.
    Input should be sorted by speaker for best packing.  Yields packed samples one at a time — RAM stays O(1 sample), so
    a 22k-hour corpus streams through (the list variant materialised every
    waveform)."""
    pending: Optional[Dict[str, Any]] = None
    prev_speaker = object()  # sentinel unequal to any real speaker id
    for s in samples:
        arr = np.asarray(s[audio_key]["array"] if isinstance(s[audio_key], dict)
                         else s[audio_key], np.float32)
        text = s[text_key]
        speaker = s.get(speaker_key) if speaker_key else None
        if pending is not None:
            same = speaker == pending["speaker_id"]
            if same and len(arr) + len(pending["audio"]) <= max_input_samples:
                pending["audio"] = np.concatenate([pending["audio"], arr])
                pending["text"] = pending["text"] + " " + text
                continue
            yield pending
            prev_speaker = pending["speaker_id"]
            pending = None
        cond = 1 if speaker == prev_speaker else 0
        pending = {"audio": arr, "text": text, "speaker_id": speaker,
                   "condition_on_prev": cond}
    if pending is not None:
        yield pending


def pack_samples(samples: Iterable[Dict[str, Any]],
                 max_input_samples: int = 480_000,
                 audio_key: str = "audio", text_key: str = "text",
                 speaker_key: Optional[str] = "speaker_id"
                 ) -> List[Dict[str, Any]]:
    """Materialised :func:`pack_samples_iter` (small corpora / tests)."""
    return list(pack_samples_iter(samples, max_input_samples=max_input_samples,
                                  audio_key=audio_key, text_key=text_key,
                                  speaker_key=speaker_key))
