"""Token- and word-level timestamps via cross-attention DTW.

Counterpart of ``distil_whisper_tpu.generation.word_timestamps``: the host
half (alignment heads, median filter, DTW, token times, word grouping) is a
numpy copy; the device half (:func:`selected_cross_weights`,
:func:`extract_token_timestamps`) runs the port's teacher-forced decoder
pass.  Semantics pinned to HF ``WhisperGenerationMixin._extract_token_timestamps``
and the OpenAI implementation it ports: select alignment heads,
std-normalise each head over the token axis (unbiased=False), median-filter
over time (width 7), average heads, then dynamic-time-warp the negative
matrix and read token times at text-index jumps.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.whisper import cross_attention_probs

TIME_PRECISION = 0.02


def default_alignment_heads(cfg: WhisperConfig) -> Tuple[Tuple[int, int], ...]:
    """Fallback when the checkpoint ships no ``alignment_heads``: every head
    of the top half of the decoder (the openai-whisper default)."""
    start = cfg.decoder_layers // 2
    return tuple((l, h) for l in range(start, cfg.decoder_layers)
                 for h in range(cfg.decoder_attention_heads))


def load_alignment_heads(path: str, cfg: WhisperConfig
                         ) -> Tuple[Tuple[int, int], ...]:
    """alignment_heads from the checkpoint's generation_config.json, else the
    top-half-of-decoder default."""
    import json
    from pathlib import Path
    p = Path(path) / "generation_config.json"
    if p.exists():
        heads = json.loads(p.read_text()).get("alignment_heads")
        if heads:
            return tuple((int(l), int(h)) for l, h in heads)
    return default_alignment_heads(cfg)


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding (HF
    ``_median_filter``)."""
    if width <= 0 or width % 2 != 1:
        raise ValueError("filter width must be odd and positive")
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.sort(windows, axis=-1)[..., pad]


def dtw(matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment over a cost matrix [tokens, frames]; returns
    (text_indices, time_indices).  Tie-breaking matches HF/openai exactly
    (strictly-less comparisons favouring the diagonal, then the text step)."""
    n, m = matrix.shape
    cost = np.full((n + 1, m + 1), np.inf, np.float64)
    trace = -np.ones((n + 1, m + 1), np.int8)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        col_prev = cost[:, j - 1]
        col = cost[:, j]
        for i in range(1, n + 1):
            c0 = col_prev[i - 1]
            c1 = col[i - 1]
            c2 = col_prev[i]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            col[i] = matrix[i - 1, j - 1] + c
            trace[i, j] = t
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(text_indices[::-1]), np.asarray(time_indices[::-1])


def token_timestamps_from_weights(weights: np.ndarray, num_input_ids: int,
                                  seq_lens: Optional[np.ndarray] = None,
                                  num_frames: Optional[Sequence[int]] = None,
                                  median_filter_width: int = 7,
                                  time_precision: float = TIME_PRECISION
                                  ) -> np.ndarray:
    """weights [B, n_heads, S, Tk] (already head-selected) -> per-token times
    [B, S+1] in seconds.  ``S`` covers positions 0..seq-2 (every token's
    query except the last); position rows < num_input_ids are the prompt and
    are dropped from the DTW, their timestamps reported as 0.0 (HF contract).
    """
    b, _, s_all, tk = weights.shape
    out = np.zeros((b, s_all + 1), np.float32)
    w = weights[:, :, num_input_ids:, :]
    if w.shape[2] == 0:
        return out
    for bi in range(b):
        m = w[bi]
        if seq_lens is not None:
            # only rows for real (pre-EOS) tokens take part in the DTW
            n_rows = max(int(seq_lens[bi]) - 1 - num_input_ids, 0)
            m = m[:, :n_rows]
            if n_rows == 0:
                continue
        if num_frames is not None:
            m = m[..., : int(num_frames[bi]) // 2]
        std = m.std(axis=-2, keepdims=True)
        mean = m.mean(axis=-2, keepdims=True)
        m = (m - mean) / np.maximum(std, 1e-10)
        m = median_filter(m, median_filter_width)
        m = m.mean(axis=0)
        text_indices, time_indices = dtw(-m.astype(np.float64))
        jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1
                       ).astype(bool)
        jump_times = time_indices[jumps] * time_precision
        n_rows = m.shape[0]
        out[bi, num_input_ids:num_input_ids + n_rows] = jump_times
        out[bi, num_input_ids + n_rows] = jump_times[-1]
    return out


@torch.no_grad()
def selected_cross_weights(dec_params, cfg: WhisperConfig, seqs: torch.Tensor,
                           alignment_heads: Sequence[Tuple[int, int]],
                           enc: Optional[torch.Tensor] = None,
                           cross=None,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, n_sel_heads, S, Tk] fp32 weights of the alignment heads, in the
    order of ``alignment_heads``.  Heads are kept layer by layer and the pass
    stops after the last layer that has one, so the full [L, B, H, S, Tk]
    tensor is never held (2 x 16 x 20 x 448 x 1500 fp32 values, 1.7 GB,
    for a 2-layer, 20-head decoder at 16 windows x 448 positions)."""
    wanted = {}
    for j, (layer, head) in enumerate(alignment_heads):
        wanted.setdefault(int(layer), []).append((j, int(head)))
    out = [None] * len(alignment_heads)
    for layer, probs in cross_attention_probs(dec_params, cfg, seqs, enc=enc,
                                              cross=cross, dtype=dtype):
        for j, head in wanted.get(layer, ()):
            out[j] = probs[:, head].clone()
        if layer >= max(wanted):
            break
    return torch.stack(out, dim=1)


def extract_token_timestamps(params, cfg: WhisperConfig,
                             sequences, seq_len,
                             num_input_ids: int,
                             alignment_heads: Sequence[Tuple[int, int]],
                             enc: Optional[torch.Tensor] = None,
                             cross=None,
                             num_frames: Optional[Sequence[int]] = None,
                             median_filter_width: int = 7,
                             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Per-token timestamps [B, S] (seconds) for generated ``sequences``.

    Runs one teacher-forced pass over ``sequences[:, :-1]`` collecting the
    fp32 cross-attention probs of ``alignment_heads`` and applies the HF
    normalise/filter/DTW pipeline on the host.
    """
    dec = params["decoder"] if "decoder" in params else params
    device = dec["tok_emb"].device
    seqs = torch.as_tensor(sequences).long().to(device)
    sel = selected_cross_weights(dec, cfg, seqs[:, :-1], alignment_heads,
                                 enc=enc, cross=cross, dtype=dtype)
    ts = token_timestamps_from_weights(
        sel.float().cpu().numpy(), num_input_ids,
        seq_lens=np.asarray(torch.as_tensor(seq_len).cpu()),
        num_frames=num_frames, median_filter_width=median_filter_width)
    return ts[:, :seqs.shape[1]]


def words_from_tokens(tokenizer, token_ids: List[int],
                      token_times: np.ndarray,
                      time_offset: float = 0.0):
    """Group decoded tokens into words with (start, end) spans.

    Mirrors HF's ``_split_tokens_on_spaces`` heuristic for space-delimited
    languages: a new word starts at a token whose text begins with a space
    (or at punctuation boundaries); special/timestamp tokens are skipped.
    """
    words = []
    cur_text, cur_start, cur_end = "", None, None
    for tid, t in zip(token_ids, token_times):
        if int(tid) >= tokenizer.eos:   # special / timestamp tokens
            continue
        piece = tokenizer.decode([int(tid)])
        if piece == "":
            continue
        starts_word = piece.startswith(" ") or not cur_text
        if starts_word and cur_text:
            words.append({"word": cur_text,
                          "start": round(time_offset + cur_start, 2),
                          "end": round(time_offset + cur_end, 2)})
            cur_text, cur_start = "", None
        if cur_start is None:
            cur_start = float(t)
        cur_text += piece
        cur_end = float(t)
    if cur_text:
        words.append({"word": cur_text,
                      "start": round(time_offset + cur_start, 2),
                      "end": round(time_offset + cur_end, 2)})
    return words
