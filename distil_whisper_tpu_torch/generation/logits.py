"""Logits processors over ``(scores [B, V], loop state)``.

Counterpart of ``distil_whisper_tpu.generation.logits`` with the same
semantics (pinned to ``transformers.generation.logits_process``): masking is
vectorised with a vocabulary index, no per-row Python.  ``gen_idx`` is the
index within the generated region: a Python int when every lane steps
together, or a [B] tensor when lanes sit at different indices (the verify
columns of speculative decoding).  The int path keeps its early returns.

The Whisper timestamp FSM state is three per-sample values carried by the
generation loop: ``prev`` / ``prevprev`` (last two generated tokens) and
``last_ts`` (the most recent timestamp token, 0 if none).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..config import WhisperConfig

NEG_INF = float("-inf")


def _vocab_iota(scores: torch.Tensor) -> torch.Tensor:
    return torch.arange(scores.shape[-1], device=scores.device)[None, :]


def _per_lane(gen_idx) -> bool:
    return isinstance(gen_idx, torch.Tensor)


def _token_mask(scores: torch.Tensor, token_ids: Sequence[int]) -> torch.Tensor:
    return _cached_token_mask(tuple(token_ids), scores.shape[-1],
                              scores.device)


@functools.lru_cache(maxsize=64)
def _cached_token_mask(token_ids: Tuple[int, ...], vocab: int,
                       device: torch.device) -> torch.Tensor:
    """[1, V] bool mask of ``token_ids``, built once per device: a copy of
    the ids from the host at every step would wait for the card."""
    mask = torch.zeros(vocab, dtype=torch.bool)
    mask[list(token_ids)] = True
    return mask.to(device)[None, :]


def suppress_tokens(scores: torch.Tensor,
                    token_ids: Sequence[int]) -> torch.Tensor:
    """Unconditionally set the given token ids to -inf (HF SuppressTokens)."""
    if not token_ids:
        return scores
    return scores.masked_fill(_token_mask(scores, token_ids), NEG_INF)


def suppress_tokens_at_begin(scores: torch.Tensor, gen_idx,
                             token_ids: Sequence[int]) -> torch.Tensor:
    """HF SuppressTokensAtBegin: only at the first generated position."""
    if not token_ids:
        return scores
    if _per_lane(gen_idx):
        mask = (gen_idx == 0)[:, None] & _token_mask(scores, token_ids)
        return scores.masked_fill(mask, NEG_INF)
    if gen_idx != 0:
        return scores
    return scores.masked_fill(_token_mask(scores, token_ids), NEG_INF)


def force_tokens(scores: torch.Tensor, gen_idx,
                 forced: Sequence[Tuple[int, int]],
                 prompt_len: int) -> torch.Tensor:
    """Force specific tokens at absolute decoder positions.

    ``forced`` uses HF ``forced_decoder_ids`` convention: (position, token)
    with position counted from the start of the decoder sequence (position 0
    is the token *after* decoder_start).  A per-lane ``gen_idx`` looks each
    lane's position up in a table of the forced ids (-1 = none).
    """
    if not _per_lane(gen_idx):
        table = dict(forced)
        tok = table.get(gen_idx + prompt_len, -1)
        if tok < 0:
            return scores
        forced_scores = torch.full_like(scores, NEG_INF)
        forced_scores[:, tok] = 0.0
        return forced_scores
    if not forced:
        return scores
    max_pos = max(p for p, _ in forced)
    table = _forced_table(tuple(forced), scores.device)
    pos = gen_idx.long() + prompt_len
    tok = torch.where(pos <= max_pos, table[pos.clamp(0, max_pos)], -1)
    forced_scores = torch.where(_vocab_iota(scores) == tok[:, None], 0.0,
                                NEG_INF).to(scores.dtype)
    return torch.where((tok >= 0)[:, None], forced_scores, scores)


@functools.lru_cache(maxsize=16)
def _forced_table(forced: Tuple[Tuple[int, int], ...],
                  device: torch.device) -> torch.Tensor:
    """The forced id of each position up to the last forced one (-1 =
    none), built once per device."""
    table = torch.full((max(p for p, _ in forced) + 1,), -1, dtype=torch.long)
    for p, t in forced:
        table[p] = t
    return table.to(device)


def min_new_tokens(scores: torch.Tensor, gen_idx, min_tokens: int,
                   eos_token_id: int) -> torch.Tensor:
    if min_tokens <= 0:
        return scores
    if _per_lane(gen_idx):
        mask = (gen_idx < min_tokens)[:, None] & (
            _vocab_iota(scores) == eos_token_id)
        return scores.masked_fill(mask, NEG_INF)
    if gen_idx >= min_tokens:
        return scores
    return scores.masked_fill(_vocab_iota(scores) == eos_token_id, NEG_INF)


class TimestampState(NamedTuple):
    """Per-sample FSM state for the Whisper timestamp rules."""
    prev: torch.Tensor       # [B] int64, last generated token (-1 if none)
    prevprev: torch.Tensor   # [B] int64, second-to-last (-1 if none)
    last_ts: torch.Tensor    # [B] int64, most recent timestamp token id (0 = none)

    @staticmethod
    def init(batch: int, device="cpu") -> "TimestampState":
        return TimestampState(
            prev=torch.full((batch,), -1, dtype=torch.long, device=device),
            prevprev=torch.full((batch,), -1, dtype=torch.long, device=device),
            last_ts=torch.zeros((batch,), dtype=torch.long, device=device),
        )

    def update(self, token: torch.Tensor, ts_begin: int) -> "TimestampState":
        token = token.long()
        return TimestampState(
            prev=token,
            prevprev=self.prev,
            last_ts=torch.where(token >= ts_begin, token, self.last_ts),
        )


def timestamp_rules(scores: torch.Tensor, gen_idx, state: TimestampState,
                    cfg: WhisperConfig,
                    max_initial_timestamp_index: Optional[int] = 50,
                    detect_from_logprob: bool = True) -> torch.Tensor:
    """WhisperTimeStampLogitsProcessor, vectorised; ``gen_idx`` an int or a
    per-lane [B] tensor."""
    ts_begin = cfg.timestamp_begin
    eos = cfg.eos_token_id
    iota = _vocab_iota(scores)

    # 1. always suppress <|notimestamps|>
    scores = scores.masked_fill(iota == cfg.no_timestamps_token_id, NEG_INF)

    last_was = (state.prev >= ts_begin) & (gen_idx >= 1)              # [B]
    penult_was = (state.prevprev >= ts_begin) | (gen_idx < 2)         # [B]

    # 2. timestamps come in pairs
    force_text = (last_was & penult_was)[:, None]
    scores = scores.masked_fill(force_text & (iota >= ts_begin), NEG_INF)
    force_ts_or_eos = (last_was & ~penult_was)[:, None]
    scores = scores.masked_fill(force_ts_or_eos & (iota < eos), NEG_INF)

    # 3. non-decreasing timestamps
    has_ts = state.last_ts > 0
    bound = torch.where(last_was & ~penult_was, state.last_ts,
                        state.last_ts + 1)                            # [B]
    ts_too_small = (iota >= ts_begin) & (iota < bound[:, None])
    scores = scores.masked_fill(has_ts[:, None] & ts_too_small, NEG_INF)

    # 4. first generated token must be an (early) timestamp
    if _per_lane(gen_idx):
        at_begin = (gen_idx == 0)[:, None]
        scores = scores.masked_fill(at_begin & (iota < ts_begin), NEG_INF)
        if max_initial_timestamp_index is not None:
            last_allowed = ts_begin + max_initial_timestamp_index
            scores = scores.masked_fill(at_begin & (iota > last_allowed),
                                        NEG_INF)
    elif gen_idx == 0:
        scores = scores.masked_fill(iota < ts_begin, NEG_INF)
        if max_initial_timestamp_index is not None:
            last_allowed = ts_begin + max_initial_timestamp_index
            scores = scores.masked_fill(iota > last_allowed, NEG_INF)

    # 5. if total timestamp probability beats every text token, force timestamp
    if detect_from_logprob:
        logprobs = torch.log_softmax(scores.float(), dim=-1)
        ts_mask = iota >= ts_begin
        ts_logprob = torch.logsumexp(
            logprobs.masked_fill(~ts_mask, NEG_INF), dim=-1)          # [B]
        max_text = torch.amax(logprobs.masked_fill(ts_mask, NEG_INF), dim=-1)
        force = (ts_logprob > max_text)[:, None]
        scores = scores.masked_fill(force & (iota < ts_begin), NEG_INF)
    return scores
