"""Beam search (HF semantics: length-penalised, 2K candidate pool).

Counterpart of ``distil_whisper_tpu.generation.beam``.  JAX's
``lax.while_loop`` is a Python loop with the same HF early-stopping-false
stop rule; the decode of a step whose logits would never be read is skipped.
The KV cache carries a flattened beam dim and is re-gathered along it after
every reorder.  The port's cache is written in place by ``decode``, so the
reorder gathers into new buffers (``index_select``): a beam never reads a
slot another beam is writing.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import WhisperConfig
from ..device import resolve_device
from ..models.whisper import cross_kv, decode, encode, init_cache, kv_width
from . import logits as L
from .generate import GenerationOptions, _process_scores, check_params_device

NEG_INF = float("-inf")


class BeamOutput(NamedTuple):
    sequences: torch.Tensor   # [B, total] best finished beam, pad after
    seq_len: torch.Tensor     # [B]
    scores: torch.Tensor      # [B] length-penalised log-prob of the best beam
    sum_logprobs: torch.Tensor    # [B] un-penalised sum log-prob incl. EOS
    no_speech_prob: torch.Tensor  # [B] fp32 (zeros unless no_speech_token_id)


def _penalty(cur: int, length_penalty: float, device) -> torch.Tensor:
    """``cur ** length_penalty`` in fp32 as a 0-dim tensor: dividing by a
    tensor is IEEE division on every device (by a Python number, PyTorch on
    CUDA multiplies by the reciprocal)."""
    return torch.tensor(cur, dtype=torch.float32, device=device) ** length_penalty


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] -> x[b, idx[b, m]] as [B, M, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


@torch.no_grad()
def beam_search(dec_params: Dict[str, Any], cfg: WhisperConfig,
                cross: Dict[str, Any], prompt_ids: torch.Tensor,
                opts: GenerationOptions, num_beams: int = 5,
                length_penalty: float = 1.0,
                sot_slot: int = 0,
                pad_len: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> BeamOutput:
    """HF-style beam search.  ``cross`` K/V are for batch B (expanded here).

    ``sot_slot``: prompt position of <|startoftranscript|> (0 for plain
    prompts; the SOT index for condition-on-prev prompts), where
    no_speech_prob is read.  ``pad_len`` [B]: left-padded prompts, masked
    out of self-attention with positions shifted per sample, as in
    ``generate()``."""
    b, p = prompt_ids.shape
    k = num_beams
    total = p + opts.max_new_tokens
    if total > cfg.max_target_positions:
        raise ValueError(f"prompt({p}) + max_new({opts.max_new_tokens}) "
                         f"exceeds {cfg.max_target_positions}")
    device = prompt_ids.device
    eos = cfg.eos_token_id
    vocab = cfg.vocab_size

    # every cross leaf (bf16 K/V, or int8 K/V and their scales) has the
    # batch on axis 1
    cross_bk = {name: arr.repeat_interleave(k, dim=1)
                for name, arr in cross.items()}
    prompt_ids = prompt_ids.long()
    prompts_bk = prompt_ids.repeat_interleave(k, dim=0)
    pad_bk = (pad_len.long().repeat_interleave(k, dim=0)
              if pad_len is not None else None)

    cache = init_cache(cfg, b * k, dtype=dtype, max_len=total, device=device,
                       width=kv_width(dec_params))
    prefill_logits, cache = decode(dec_params, cfg, prompts_bk,
                                   cross=cross_bk, cache=cache, pos_offset=0,
                                   pad_len=pad_bk, dtype=dtype)

    # <|nospeech|> probability at the SOT slot of beam 0
    if opts.no_speech_token_id is not None:
        sot_logits = prefill_logits.view(b, k, p, -1)[:, 0, sot_slot]
        probs0 = torch.softmax(sot_logits.float(), dim=-1)
        no_speech_prob = probs0[:, opts.no_speech_token_id]
    else:
        no_speech_prob = torch.zeros((b,), dtype=torch.float32, device=device)

    tokens = torch.full((b, k, total), cfg.pad_token_id, dtype=torch.long,
                        device=device)
    tokens[:, :, :p] = prompt_ids[:, None, :]
    # only beam 0 is live initially (all beams identical)
    live_scores = torch.full((b, k), NEG_INF, device=device)
    live_scores[:, 0] = 0.0
    fin_tokens = tokens.clone()
    fin_scores = torch.full((b, k), NEG_INF, device=device)
    fin_sum = torch.full((b, k), NEG_INF, device=device)   # un-penalised
    fin_len = torch.full((b, k), p, dtype=torch.long, device=device)
    last_logits = prefill_logits[:, -1].float()            # [B*K, V]
    ts = L.TimestampState.init(b * k, device)
    beam_base = (torch.arange(b, device=device) * k)[:, None]

    def improvable(cur, live_scores, fin_scores) -> bool:
        # HF early_stopping=False: go on while the best live beam, penalised
        # at the current length, could still beat the worst kept finished one
        max_live = live_scores.amax(dim=1) / _penalty(cur, length_penalty,
                                                      device)
        return bool((max_live > fin_scores.amin(dim=1)).any())

    cur = p
    go_on = cur < total
    while go_on:
        gen_idx = cur - p
        # HF beam order: log_softmax first, processors applied to log-probs
        # without renormalisation
        logp = torch.log_softmax(last_logits, dim=-1)
        logp = _process_scores(logp, gen_idx, ts, cfg, opts, p)
        cand = live_scores[:, :, None] + logp.view(b, k, vocab)   # [B, K, V]

        top_scores, top_idx = torch.topk(cand.view(b, k * vocab), 2 * k,
                                         dim=1)                    # [B, 2K]
        src_beam = top_idx // vocab
        tok = top_idx % vocab
        # finished hypotheses are stored WITHOUT the eos token, penalised by
        # the full sequence length
        cand_tokens = _gather_beams(tokens, src_beam)             # [B, 2K, T]
        is_eos = tok == eos
        penalty = _penalty(cur, length_penalty, device)
        fin_cand_scores = torch.where(is_eos, top_scores / penalty, NEG_INF)

        # merge finished candidates into the finished set (keep the top K)
        all_fin_scores = torch.cat([fin_scores, fin_cand_scores], 1)
        all_fin_sum = torch.cat(
            [fin_sum, torch.where(is_eos, top_scores, NEG_INF)], 1)
        all_fin_tokens = torch.cat([fin_tokens, cand_tokens], 1)
        all_fin_len = torch.cat(
            [fin_len, torch.full((b, 2 * k), cur, dtype=torch.long,
                                 device=device)], 1)
        fin_scores, fin_idx = torch.topk(all_fin_scores, k, dim=1)
        fin_tokens = _gather_beams(all_fin_tokens, fin_idx)
        fin_sum = all_fin_sum.gather(1, fin_idx)
        fin_len = all_fin_len.gather(1, fin_idx)

        # live beams: the best K candidates that are not eos
        live_cand = torch.where(is_eos, NEG_INF, top_scores)
        live_scores, live_idx = torch.topk(live_cand, k, dim=1)  # [B, K]
        live_src = src_beam.gather(1, live_idx)
        live_tok = tok.gather(1, live_idx)
        tokens = _gather_beams(tokens, live_src)
        tokens[:, :, cur] = live_tok

        # reorder the cache and the FSM state along the beam dim (new
        # buffers: decode writes the cache in place)
        flat_src = (beam_base + live_src).reshape(-1)
        cache = {name: x.index_select(1, flat_src)
                 for name, x in cache.items()}
        ts = L.TimestampState(*(f.index_select(0, flat_src) for f in ts))
        ts = ts.update(live_tok.reshape(-1), cfg.timestamp_begin)
        cur += 1
        go_on = cur < total and improvable(cur, live_scores, fin_scores)
        if not go_on:
            break
        lg, cache = decode(dec_params, cfg, live_tok.reshape(-1, 1),
                           cross=cross_bk, cache=cache, pos_offset=cur - 1,
                           pad_len=pad_bk, dtype=dtype)
        last_logits = lg[:, -1].float()

    # fall back to the best live beam when nothing finished
    live_pen = torch.clamp(_penalty(cur, length_penalty, device), min=1.0)
    live_final = live_scores / live_pen
    no_fin = (fin_scores == NEG_INF).all(dim=1, keepdim=True)
    fin_scores = torch.where(no_fin, live_final, fin_scores)
    fin_sum = torch.where(no_fin, live_scores, fin_sum)
    fin_tokens = torch.where(no_fin[:, :, None], tokens, fin_tokens)
    fin_len = torch.where(no_fin, cur, fin_len)

    best = torch.argmax(fin_scores, dim=1)[:, None]
    sequences = _gather_beams(fin_tokens, best)[:, 0]
    seq_len = fin_len.gather(1, best)[:, 0]
    scores = fin_scores.gather(1, best)[:, 0]
    sum_logprobs = fin_sum.gather(1, best)[:, 0]
    iota = torch.arange(total, device=device)[None, :]
    sequences = torch.where(iota < seq_len[:, None], sequences,
                            cfg.pad_token_id)
    return BeamOutput(sequences=sequences, seq_len=seq_len, scores=scores,
                      sum_logprobs=sum_logprobs.float(),
                      no_speech_prob=no_speech_prob)


@torch.no_grad()
def encode_and_beam_search(params, cfg: WhisperConfig, mel, prompt_ids,
                           opts: GenerationOptions, num_beams: int = 5,
                           length_penalty: float = 1.0, sot_slot: int = 0,
                           pad_len=None, dtype: torch.dtype = torch.float32,
                           device="cuda") -> BeamOutput:
    """mel [B, n_mels, 3000] + prompt [B, P] -> BeamOutput, on ``device``
    (where ``params`` must already live)."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    mel = torch.as_tensor(mel).to(dev)
    prompt_ids = torch.as_tensor(prompt_ids).to(dev)
    if pad_len is not None:
        pad_len = torch.as_tensor(pad_len).to(dev)
    enc = encode(params["encoder"], cfg, mel, dtype=dtype)
    cross = cross_kv(params["decoder"], cfg, enc)
    return beam_search(params["decoder"], cfg, cross, prompt_ids, opts,
                       num_beams=num_beams, length_penalty=length_penalty,
                       sot_slot=sot_slot, pad_len=pad_len, dtype=dtype)
