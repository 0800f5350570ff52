"""Autoregressive generation (greedy and sampling) with the Whisper logits
rules.

Counterpart of ``distil_whisper_tpu.generation.generate``: a static token
budget, a static-shape KV cache, and the processor stack of :mod:`.logits`.
JAX's ``lax.while_loop`` is a Python loop with the same stop rule (stop when
the budget is spent or every row has emitted EOS); the decode of a step
whose logits would never be read is skipped.  Sampling draws from an
explicit ``torch.Generator`` (JAX splits a threefry key per step; the two
cannot give the same draws, only the same distribution).

Everything returned is fixed-shape; host-side code slices with ``seq_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..device import resolve_device
from ..models.whisper import cross_kv, decode, encode, init_cache, kv_width
from . import logits as L


@dataclasses.dataclass(frozen=True)
class GenerationOptions:
    """Generation settings."""
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    do_sample: bool = False
    top_k: int = 0                       # 0 = no top-k filtering
    return_timestamps: bool = False
    max_initial_timestamp_index: Optional[int] = 50
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = ()
    forced_decoder_ids: Tuple[Tuple[int, int], ...] = ()
    no_speech_token_id: Optional[int] = None

    @classmethod
    def from_config(cls, cfg: WhisperConfig, **kw) -> "GenerationOptions":
        defaults = dict(suppress_tokens=tuple(cfg.suppress_tokens),
                        begin_suppress_tokens=tuple(cfg.begin_suppress_tokens),
                        forced_decoder_ids=tuple(cfg.forced_decoder_ids))
        defaults.update(kw)
        return cls(**defaults)


class GenerateOutput(NamedTuple):
    sequences: torch.Tensor      # [B, prompt+max_new] int64, pad after EOS
    seq_len: torch.Tensor        # [B] total length incl. prompt and EOS
    sum_logprobs: torch.Tensor   # [B] fp32 sum over generated tokens (incl. EOS)
    no_speech_prob: torch.Tensor  # [B] fp32 (zeros unless no_speech_token_id set)


def _process_scores(scores, gen_idx: int, ts_state, cfg: WhisperConfig,
                    opts: GenerationOptions, prompt_len: int):
    scores = L.force_tokens(scores, gen_idx, opts.forced_decoder_ids, prompt_len)
    scores = L.suppress_tokens_at_begin(scores, gen_idx, opts.begin_suppress_tokens)
    scores = L.suppress_tokens(scores, opts.suppress_tokens)
    scores = L.min_new_tokens(scores, gen_idx, opts.min_new_tokens,
                              cfg.eos_token_id)
    if opts.return_timestamps:
        scores = L.timestamp_rules(scores, gen_idx, ts_state, cfg,
                                   opts.max_initial_timestamp_index)
    return scores


def _select(scores: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator],
            opts: GenerationOptions) -> torch.Tensor:
    """Greedy or temperature (+ top-k) sampling over processed scores."""
    if not opts.do_sample:
        return torch.argmax(scores, dim=-1)
    s = scores.float() / max(float(temperature), 1e-6)
    if opts.top_k > 0:
        kth = torch.topk(s, opts.top_k, dim=-1).values[:, -1:]
        s = s.masked_fill(s < kth, L.NEG_INF)
    return torch.multinomial(torch.softmax(s, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(dec_params: Dict[str, Any], cfg: WhisperConfig,
             cross: Dict[str, Any], prompt_ids: torch.Tensor,
             opts: GenerationOptions,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             pad_len: Optional[torch.Tensor] = None,
             sot_slot: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> GenerateOutput:
    """Extend ``prompt_ids`` [B, P] by up to max_new_tokens, greedily or,
    with ``opts.do_sample``, by sampling at ``temperature`` with draws from
    ``generator`` (a generator on the prompt's device; seeded with 0 when
    not given).

    ``cross`` is the precomputed cross-attention K/V (:func:`...models.cross_kv`).
    The prompt must already contain decoder_start/lang/task tokens;
    ``opts.forced_decoder_ids`` is also honoured.

    ``pad_len`` [B] marks left-padded prompt slots (condition-on-prev
    prompts of different lengths in one batch, cf. ``models.whisper.decode``).
    The <|nospeech|> probability is read at the <|startoftranscript|> slot:
    ``sot_slot`` when given, else ``pad_len[b]``, else 0.
    """
    b, p = prompt_ids.shape
    total = p + opts.max_new_tokens
    if total > cfg.max_target_positions:
        raise ValueError(f"prompt({p}) + max_new({opts.max_new_tokens}) "
                         f"exceeds {cfg.max_target_positions}")
    device = prompt_ids.device
    prompt_ids = prompt_ids.long()
    if opts.do_sample and generator is None:
        # never the global RNG; the JAX package's default key is PRNGKey(0)
        generator = torch.Generator(device=device).manual_seed(0)
    cache = init_cache(cfg, b, dtype=dtype, max_len=total, device=device,
                       width=kv_width(dec_params))
    prefill_logits, cache = decode(dec_params, cfg, prompt_ids, cross=cross,
                                   cache=cache, pos_offset=0, pad_len=pad_len,
                                   dtype=dtype)

    # <|nospeech|> probability from the raw logits at the SOT position
    if opts.no_speech_token_id is not None:
        if sot_slot is not None:
            sot_logits = prefill_logits[:, sot_slot]
        elif pad_len is None:
            sot_logits = prefill_logits[:, 0]
        else:
            sot_logits = prefill_logits[torch.arange(b, device=device),
                                        pad_len.long()]
        probs0 = torch.softmax(sot_logits.float(), dim=-1)
        no_speech_prob = probs0[:, opts.no_speech_token_id]
    else:
        no_speech_prob = torch.zeros((b,), dtype=torch.float32, device=device)

    tokens = torch.full((b, total), cfg.pad_token_id, dtype=torch.long,
                        device=device)
    tokens[:, :p] = prompt_ids
    last_logits = prefill_logits[:, -1].float()
    ts = L.TimestampState.init(b, device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    sum_logprobs = torch.zeros((b,), dtype=torch.float32, device=device)
    seq_len = torch.full((b,), p, dtype=torch.long, device=device)

    cur = p
    while cur < total:
        gen_idx = cur - p
        scores = _process_scores(last_logits, gen_idx, ts, cfg, opts, p)
        nxt = _select(scores, temperature, generator, opts)
        logp = torch.log_softmax(scores, dim=-1)
        tok_logp = logp.gather(1, nxt[:, None])[:, 0]

        was_finished = finished
        nxt = torch.where(was_finished, cfg.pad_token_id, nxt)
        sum_logprobs = sum_logprobs + torch.where(was_finished, 0.0, tok_logp)
        finished = was_finished | (nxt == cfg.eos_token_id)
        seq_len = torch.where(was_finished, seq_len, cur + 1)
        tokens[:, cur] = nxt
        ts = ts.update(nxt, cfg.timestamp_begin)
        cur += 1
        if cur >= total or bool(finished.all()):
            break
        lg, cache = decode(dec_params, cfg, nxt[:, None], cross=cross,
                           cache=cache, pos_offset=cur - 1, pad_len=pad_len,
                           dtype=dtype)
        last_logits = lg[:, -1].float()

    return GenerateOutput(sequences=tokens, seq_len=seq_len,
                          sum_logprobs=sum_logprobs,
                          no_speech_prob=no_speech_prob)


# ----------------------------------------------------------------------
# Convenience wrapper (an entry point)
# ----------------------------------------------------------------------


def check_params_device(params: Dict[str, Any], dev: torch.device) -> None:
    if params["decoder"]["tok_emb"].device.type != dev.type:
        raise ValueError(f"params live on {params['decoder']['tok_emb'].device}"
                         f", not on {dev}")


@torch.no_grad()
def encode_and_generate(params: Dict[str, Any], cfg: WhisperConfig,
                        mel, prompt_ids, opts: GenerationOptions,
                        temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        pad_len=None, sot_slot: Optional[int] = None,
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> GenerateOutput:
    """mel [B, n_mels, 3000] + prompt [B, P] -> GenerateOutput, on ``device``
    (where ``params`` must already live)."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    mel = torch.as_tensor(mel).to(dev)
    prompt_ids = torch.as_tensor(prompt_ids).to(dev)
    if pad_len is not None:
        pad_len = torch.as_tensor(pad_len).to(dev)
    enc = encode(params["encoder"], cfg, mel, dtype=dtype)
    cross = cross_kv(params["decoder"], cfg, enc)
    return generate(params["decoder"], cfg, cross, prompt_ids, opts,
                    temperature=temperature, generator=generator,
                    pad_len=pad_len, sot_slot=sot_slot, dtype=dtype)
