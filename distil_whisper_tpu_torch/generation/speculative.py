"""Speculative decoding: a draft proposes, the teacher verifies.

Counterpart of ``distil_whisper_tpu.generation.speculative``.  Greedy
acceptance: the draft proposes ``gamma`` tokens one at a time, the teacher
scores the last accepted token and all ``gamma`` proposals in ONE decode of
``gamma + 1`` tokens, and the longest prefix where the proposals equal the
teacher's own choices is accepted, plus the teacher's token after it.  Every
emitted token is the teacher's choice under the full logits-processor stack
(the timestamp FSM included, run per verify column), so the output equals
the teacher's greedy ``generate``; the speed-up comes from one teacher
decode per ``accepted + 1`` tokens.  The draft-free variant
(:func:`ngram_speculative_generate_batched`) copies its proposals from the
most recent repeat of the sequence's last n-gram.

The JAX package runs one lane as a ``lax.while_loop`` and batches lanes with
``jax.vmap``.  Here the batch is native: every lane keeps its own cursor
(``decode`` takes per-lane cursors, ``pad_len`` included), its own token
window and its own counters, and a lane that has finished is frozen with
``torch.where`` while the others go on, as the vmapped loop freezes it.  A
round holds all its state as tensors and syncs with the host once, to ask
whether any lane is still active.  The caches are written in place; a
finished lane's decode rewrites the slots of its last window, whose values
no emitted token reads any more.

The draft's cache holds every accepted token, unlike the reference's: its
first step of a round feeds the token before the window too, so the slot
of the last prompt token (the reference's prefill stops one short) and
that of the last proposal of a fully accepted round (never fed back) are
written.  A draft equal to the teacher accepts every proposal; the tokens
are the teacher's either way.

Benchmark-only knobs turn the proposals and the teacher's choices into a
position-keyed oracle while both models still run their full compute:
``synthetic_acceptance`` (the draft proposes the oracle token with that
probability) and ``synthetic_period`` / ``synthetic_repeat_prob`` (a
periodic token stream for the n-gram lookup).  Their coins come from a
``torch.Generator`` (lane ``b``'s acceptance coins from seed ``b``, the
repeat coins from seed 9), one coin a position: the same law as JAX's
``bernoulli(fold_in(key, pos))``, other draws.  Their output tokens are
synthetic.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import WhisperConfig
from ..models.whisper import cross_kv, decode, encode, init_cache
from ..ops.quant import maybe_quantize_encoder
from . import logits as L
from .generate import GenerationOptions, check_params_device


class SpeculativeOutput(NamedTuple):
    sequences: torch.Tensor      # [B, total] int64, pad after the end
    seq_len: torch.Tensor        # [B]
    rounds: torch.Tensor         # [B] verify rounds a lane took part in
    drafted: torch.Tensor        # [B] draft tokens proposed
    accepted: torch.Tensor       # [B] draft tokens accepted
    sum_logprobs: torch.Tensor   # [B] fp32, generated tokens incl. EOS
    no_speech_prob: torch.Tensor  # [B] fp32 (zeros unless requested)


def _process(scores, gen_idx, cfg: WhisperConfig, opts: GenerationOptions,
             prompt_len, ts_state=None, use_ts=None):
    """The processor stack of ``generate._process_scores``, in its order
    (token identity with the greedy path depends on it); ``gen_idx`` an int
    or a per-row tensor, ``prompt_len`` an int or a per-row tensor,
    ``ts_state`` the timestamp FSM state of each row's context (required iff
    ``opts.return_timestamps``).  ``use_ts`` [N] bool gates the timestamp
    rules per row (the serving engine's lanes mix timestamped and plain
    requests); None applies them to every row."""
    scores = L.force_tokens(scores, gen_idx, opts.forced_decoder_ids,
                            prompt_len)
    scores = L.suppress_tokens_at_begin(scores, gen_idx,
                                        opts.begin_suppress_tokens)
    scores = L.suppress_tokens(scores, opts.suppress_tokens)
    scores = L.min_new_tokens(scores, gen_idx, opts.min_new_tokens,
                              cfg.eos_token_id)
    if opts.return_timestamps:
        ts_scores = L.timestamp_rules(scores, gen_idx, ts_state, cfg,
                                      opts.max_initial_timestamp_index)
        scores = (ts_scores if use_ts is None
                  else torch.where(use_ts[:, None], ts_scores, scores))
    return scores


def _bias_to(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Make ``target`` [N] the argmax of ``scores`` [N, V] while keeping the
    result a function of the computed logits (clamped and scaled to at most
    1e-4, under a +1e6 one-hot), as JAX does so that no model pass is dead
    code."""
    iota = torch.arange(scores.shape[-1], device=scores.device)[None, :]
    bias = torch.where(iota == target[:, None], 1e6, 0.0)
    return torch.clamp(scores, min=-1e5) * 1e-9 + bias


def _oracle(pos: torch.Tensor) -> torch.Tensor:
    """Position-keyed pseudo-random token of ``synthetic_acceptance``, far
    from EOS and the special tokens (JAX's hash)."""
    return (pos * 60493 % 997) % 400 + 10


def _periodic_oracle(pos: torch.Tensor, period: int, vocab_size: int,
                     repeat: Optional[torch.Tensor]) -> torch.Tensor:
    """The ``synthetic_period`` stream: a period-R token at each position,
    or, where ``repeat`` (coins over positions) is False, a position-unique
    filler token past the periodic band (JAX's hashes)."""
    periodic = ((pos % period) * 131 % 389) % 400 + 10
    if repeat is None:
        return periodic
    lo = 410
    span = max(min(vocab_size - 1 - lo, 400), 1)
    unique = (pos * 7919 % 25013) % span + lo
    return torch.where(repeat[pos], periodic, unique)


def synthetic_coins(seed: int, length: int, prob: float,
                    device="cpu") -> torch.Tensor:
    """[length] bool coins, True with probability ``prob``, one a position,
    drawn from a CPU ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return (torch.rand(length, generator=gen) < prob).to(device)


def _teacher_choices(t_logits, cur, p, gamma: int, cfg: WhisperConfig,
                     opts: GenerationOptions, bias_fn=None, ts_state=None,
                     drafts=None, use_ts=None):
    """The teacher's choice and its log-probability for each verify column:
    column ``i`` of lane ``b`` predicts position ``cur[b] + i``.  All
    ``gamma + 1`` columns of all lanes go through the processor stack as one
    [B * (gamma + 1), V] batch of rows.  ``p`` is the prompt length, an int
    or per lane [B]; ``use_ts`` [B] gates the timestamp rules per lane.

    Column ``i``'s timestamp state is the lane's carried state advanced
    through ``drafts[:, :i]``, the context its logits saw.  Columns past the
    first mismatch see a counterfactual state, but exactly those columns are
    discarded by :func:`_verify_accept`.  Returns ``(choices [B, gamma+1]
    int64, logps [B, gamma+1] fp32)``."""
    b, w, v = t_logits.shape
    cols = torch.arange(w, device=t_logits.device)
    if isinstance(p, torch.Tensor):           # one prompt length a row
        p = p.long()[:, None].expand(b, w).reshape(-1)
    gen_idx = (cur[:, None] + cols).reshape(-1) - p
    if use_ts is not None:
        use_ts = use_ts[:, None].expand(b, w).reshape(-1)
    ts = None
    if ts_state is not None:
        states = [ts_state]
        for i in range(gamma):
            states.append(states[-1].update(drafts[:, i], cfg.timestamp_begin))
        ts = L.TimestampState(*(torch.stack([getattr(s, f) for s in states],
                                            dim=1).reshape(-1)
                                for f in L.TimestampState._fields))
    scores = _process(t_logits.float().reshape(b * w, v), gen_idx, cfg, opts,
                      p, ts_state=ts, use_ts=use_ts)
    if bias_fn is not None:
        scores = bias_fn(scores, (cur[:, None] + cols).reshape(-1))
    choice = torch.argmax(scores, dim=-1)
    logp = torch.log_softmax(scores, dim=-1).gather(1, choice[:, None])[:, 0]
    return choice.view(b, w), logp.view(b, w)


def _ts_advance(ts: L.TimestampState, window: torch.Tensor,
                n_eff: torch.Tensor, ts_begin: int) -> L.TimestampState:
    """Advance each lane's timestamp state past its emitted verify window
    ``window[b, 0 .. n_eff[b]]``: ``n_eff + 1`` ``TimestampState.update``
    calls in one."""
    idx = torch.arange(window.shape[1], device=window.device)[None, :]
    emitted = idx <= n_eff[:, None]
    prev = window.gather(1, n_eff[:, None])[:, 0]
    before = window.gather(1, (n_eff - 1).clamp(min=0)[:, None])[:, 0]
    prevprev = torch.where(n_eff >= 1, before, ts.prev)
    is_ts = emitted & (window >= ts_begin)
    ts_pos = torch.where(is_ts, idx, -1).amax(dim=1)
    last = window.gather(1, ts_pos.clamp(min=0)[:, None])[:, 0]
    return L.TimestampState(prev=prev, prevprev=prevprev,
                            last_ts=torch.where(ts_pos >= 0, last, ts.last_ts))


def _verify_accept(t_choice, drafts, cur, total: int, eos: int, gamma: int):
    """Longest-matching-prefix acceptance for each lane.  Returns the
    ``gamma + 1`` tokens to write at ``cur``, the number of accepted draft
    tokens ``n_eff`` (cut at an EOS inside the window) and whether the lane
    is finished (EOS emitted, or the budget spent)."""
    matches = (drafts == t_choice[:, :gamma]).long()
    n = torch.cumprod(matches, dim=1).sum(dim=1)               # [B]
    idx = torch.arange(gamma + 1, device=drafts.device)[None, :]
    candidate = torch.cat([drafts, t_choice[:, gamma:]], dim=1)
    accepted_vec = torch.where(idx == n[:, None], t_choice, candidate)
    is_eos = (accepted_vec == eos) & (idx <= n[:, None])
    eos_idx = torch.where(is_eos, idx, gamma + 1).amin(dim=1)
    n_eff = torch.minimum(n, eos_idx)
    finished = is_eos.any(dim=1) | (cur + n_eff + 1 >= total)
    return accepted_vec, n_eff, finished


def _no_speech(logits, opts: GenerationOptions, pad_len, sot_slot):
    """<|nospeech|> probability from the prefill logits at the
    <|startoftranscript|> slot (``sot_slot``, else ``pad_len[b]``, else 0),
    as ``generate``."""
    b = logits.shape[0]
    if opts.no_speech_token_id is None:
        return torch.zeros((b,), dtype=torch.float32, device=logits.device)
    if sot_slot is not None:
        sot = logits[:, sot_slot]
    elif pad_len is None:
        sot = logits[:, 0]
    else:
        sot = logits[torch.arange(b, device=logits.device), pad_len.long()]
    return torch.softmax(sot.float(), dim=-1)[:, opts.no_speech_token_id]


def _propose_ngram(tokens: torch.Tensor, cur, gamma: int, max_ngram: int,
                   pad_id: int, min_start=0):
    """Draft ``gamma`` tokens per lane by n-gram lookup over the accepted
    sequence: the most recent earlier occurrence of the last k-gram (k =
    ``max_ngram`` down to 1, the longest match wins) and the tokens that
    followed it.  A match must lie before ``cur - 1`` (slots from ``cur`` on
    hold rejected junk, and the gram may not match itself) and at or after
    ``min_start`` (the left-pad filler of a padded prompt).

    tokens [B, T], ``cur`` and ``min_start`` ints or [B] tensors.  Returns
    ``(drafts [B, gamma] int64, found [B] bool)``; lanes without a match
    propose ``pad_id``."""
    bsz, t = tokens.shape
    dev = tokens.device

    def lanes(x):            # an int is filled on the device, never copied
        if isinstance(x, torch.Tensor):
            return x.long().expand(bsz)
        return torch.full((bsz,), int(x), dtype=torch.long, device=dev)
    cur, min_start = lanes(cur), lanes(min_start)
    found = torch.zeros(bsz, dtype=torch.bool, device=dev)
    start = torch.zeros(bsz, dtype=torch.long, device=dev)
    for k in range(max_ngram, 0, -1):
        at = (cur - k).clamp(min=0)[:, None] + torch.arange(k, device=dev)
        gram = tokens.gather(1, at.clamp(max=t - 1))             # [B, k]
        windows = tokens.unfold(1, k, 1)                         # [B, T-k+1, k]
        eq = (windows == gram[:, None, :]).all(dim=2)
        j = torch.arange(t - k + 1, device=dev)[None, :]
        valid = (eq & (j + k <= (cur - 1)[:, None])
                 & (cur >= k + 1)[:, None] & (j >= min_start[:, None]))
        jstar = torch.where(valid, j, -1).amax(dim=1)
        ok = jstar >= 0
        start = torch.where(~found & ok, jstar + k, start)
        found = found | ok
    start = start.clamp(max=t - gamma)           # as dynamic_slice clamps
    drafts = tokens.gather(1, start[:, None] + torch.arange(gamma, device=dev))
    return torch.where(found[:, None], drafts, pad_id), found


def _speculate(teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
               teacher_cross: Dict[str, Any], prompt_ids: torch.Tensor,
               opts: GenerationOptions, gamma: int, propose, bias_fn,
               max_len_cfgs, pad_len, sot_slot, dtype,
               draft_prefill=None) -> SpeculativeOutput:
    """The accept/verify loop shared by both methods.

    ``propose(tokens, win, ts)`` returns ``(drafts [B, gamma],
    found [B] or None)``: the draft model's or the n-gram lookup's
    proposals for the lanes whose last accepted token sits at slot
    ``win``.  ``bias_fn(scores, pos)`` is the synthetic-token override of
    the teacher's choices (or None)."""
    b, p = prompt_ids.shape
    total = p + opts.max_new_tokens
    if total > min(c.max_target_positions for c in max_len_cfgs):
        raise ValueError(f"prompt({p}) + max_new({opts.max_new_tokens}) "
                         "exceeds the models' max_target_positions")
    if gamma < 1:
        raise ValueError(f"gamma must be at least 1, got {gamma}")
    dev = prompt_ids.device
    eos, pad = teacher_cfg.eos_token_id, teacher_cfg.pad_token_id
    prompt_ids = prompt_ids.long()
    if pad_len is not None:
        pad_len = pad_len.to(dev).long()
    # gamma + 1 slots of slack: the verify window may overhang the budget
    # near the end; the overhang is junk and sliced off below
    slack = gamma + 1
    t_cache = init_cache(teacher_cfg, b, dtype=dtype, max_len=total + slack,
                         device=dev)
    t_logits, _ = decode(teacher_dec, teacher_cfg, prompt_ids,
                         cross=teacher_cross, cache=t_cache, pos_offset=0,
                         pad_len=pad_len, dtype=dtype)
    if draft_prefill is not None:
        draft_prefill(prompt_ids, total + slack)
    no_speech_prob = _no_speech(t_logits, opts, pad_len, sot_slot)

    # the first token comes from the teacher's prefill (position p)
    ts = L.TimestampState.init(b, dev)
    first = _process(t_logits[:, -1].float(), 0, teacher_cfg, opts, p,
                     ts_state=ts)
    if bias_fn is not None:
        first = bias_fn(first, torch.full((b,), p, device=dev))
    first_tok = torch.argmax(first, dim=-1)
    sum_logprobs = torch.log_softmax(first, dim=-1).gather(
        1, first_tok[:, None])[:, 0]
    del t_logits, first

    tokens = torch.full((b, total + slack), pad, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt_ids
    tokens[:, p] = first_tok
    ts = ts.update(first_tok, teacher_cfg.timestamp_begin)
    cur = torch.full((b,), p + 1, dtype=torch.long, device=dev)
    # a lane's window: the slot of its last accepted token while it runs,
    # its last window's slot once it has finished (in bounds by
    # construction: the cache never needs clamping)
    win = cur - 1
    finished = first_tok == eos
    rounds = drafted = accepted = torch.zeros((b,), dtype=torch.long,
                                              device=dev)
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]

    active = ~finished & (cur < total)
    while bool(active.any()):                     # the round's one sync
        # the first slot of the verify window: a running lane's cursor
        base = win + 1
        drafts, found = propose(tokens, win, ts)
        t_in = torch.cat([tokens.gather(1, win[:, None]), drafts], dim=1)
        t_logits, _ = decode(teacher_dec, teacher_cfg, t_in,
                             cross=teacher_cross, cache=t_cache,
                             pos_offset=win, pad_len=pad_len, dtype=dtype)
        t_choice, t_logp = _teacher_choices(t_logits, base, p, gamma,
                                            teacher_cfg, opts, bias_fn,
                                            ts_state=ts, drafts=drafts)
        del t_logits
        accepted_vec, n_eff, done = _verify_accept(t_choice, drafts, base,
                                                   total, eos, gamma)
        # finished lanes keep their tokens: the write puts back the values
        # already there
        at = base[:, None] + idx
        tokens[rows, at] = torch.where(active[:, None], accepted_vec,
                                       tokens[rows, at])
        emit = (idx <= n_eff[:, None]) & (base[:, None] + idx < total)
        gained = torch.where(emit, t_logp, 0.0).sum(dim=1)
        sum_logprobs = torch.where(active, sum_logprobs + gained, sum_logprobs)
        g = gamma if found is None else torch.where(found, gamma, 0)
        got = n_eff if found is None else torch.minimum(n_eff, g)
        rounds = rounds + active.long()
        drafted = drafted + torch.where(active, g, 0)
        accepted = accepted + torch.where(active, got, 0)
        new_ts = _ts_advance(ts, accepted_vec, n_eff,
                             teacher_cfg.timestamp_begin)
        ts = L.TimestampState(*(torch.where(active, n, o)
                                for n, o in zip(new_ts, ts)))
        new_cur = base + n_eff + 1
        finished = finished | (active & done)
        win = torch.where(active & ~done, new_cur - 1, win)
        cur = torch.where(active, new_cur, cur)
        active = ~finished & (cur < total)

    seq_len = torch.clamp(cur, max=total)
    keep = torch.arange(total, device=dev)[None, :] < seq_len[:, None]
    sequences = torch.where(keep, tokens[:, :total], pad)
    return SpeculativeOutput(sequences=sequences, seq_len=seq_len,
                             rounds=rounds, drafted=drafted,
                             accepted=accepted, sum_logprobs=sum_logprobs,
                             no_speech_prob=no_speech_prob)


@torch.no_grad()
def speculative_generate_batched(
        teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
        draft_dec: Dict[str, Any], draft_cfg: WhisperConfig,
        teacher_cross: Dict[str, Any], draft_cross: Dict[str, Any],
        prompt_ids: torch.Tensor, opts: GenerationOptions,
        gamma: int = 5, dtype: torch.dtype = torch.float32,
        synthetic_acceptance: Optional[float] = None,
        pad_len: Optional[torch.Tensor] = None,
        sot_slot: Optional[int] = None) -> SpeculativeOutput:
    """Greedy speculative decoding of a batch of lanes: the draft
    (``draft_dec`` on its own ``draft_cross``, often the teacher's encoder
    states projected by the draft) proposes ``gamma`` tokens a round, the
    teacher verifies them in one decode.  Token for token the teacher's
    greedy ``generate``, with ``opts.return_timestamps`` too.

    ``pad_len`` [B] and ``sot_slot`` take the left-padded prompt layout of
    :mod:`.sequential`; with ``sum_logprobs`` and ``no_speech_prob`` this is
    a drop-in for ``generate`` at the sequential ladder's greedy rung.

    ``synthetic_acceptance`` (benchmark only): both models run their full
    compute, but the teacher always chooses a position-keyed oracle token
    and the draft proposes it with this probability per token (lane ``b``
    draws its coins from seed ``b``), so a round accepts the prefix law's
    share.  The output tokens are then synthetic.

    Returns per-lane ``rounds``, ``drafted`` and ``accepted`` [B]."""
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    slack = gamma + 1
    total_len = p + opts.max_new_tokens + slack
    bias_fn = None
    coins = None
    if synthetic_acceptance is not None:
        coins = torch.stack([synthetic_coins(lane, total_len,
                                             synthetic_acceptance, dev)
                             for lane in range(b)])

        def bias_fn(scores, pos):
            return _bias_to(scores, _oracle(pos))

    state = {}

    def prefill(prompt, max_len):
        state["cache"] = init_cache(draft_cfg, b, dtype=dtype,
                                    max_len=max_len, device=dev)
        if p > 1:
            decode(draft_dec, draft_cfg, prompt[:, :-1], cross=draft_cross,
                   cache=state["cache"], pos_offset=0, pad_len=pad_len,
                   dtype=dtype)

    def propose(tokens, win, ts):
        # the draft runs the same processor stack and timestamp FSM, from
        # the accepted prefix's state, so that its proposals are legal.  Its
        # first step feeds the slots win - 1 and win: slot win - 1 is the
        # last prompt token in the first round (the prefill stops one
        # short) and the last proposal after a fully accepted round, which
        # no step has fed
        tok = tokens.gather(1, torch.stack([win - 1, win], dim=1))
        start, dts, out = win - 1, ts, []
        for _ in range(gamma):
            lg, _ = decode(draft_dec, draft_cfg, tok, cross=draft_cross,
                           cache=state["cache"], pos_offset=start,
                           pad_len=pad_len, dtype=dtype)
            pos = start + tok.shape[1]            # the proposal's position
            scores = _process(lg[:, -1].float(), pos - p, draft_cfg, opts, p,
                              ts_state=dts)
            if coins is not None:
                agree = coins.gather(1, pos[:, None])[:, 0]
                target = torch.where(agree, _oracle(pos), _oracle(pos) + 1)
                scores = _bias_to(scores, target)
            nxt = torch.argmax(scores, dim=-1)
            out.append(nxt)
            start, tok = pos, nxt[:, None]
            dts = dts.update(nxt, draft_cfg.timestamp_begin)
        return torch.stack(out, dim=1), None

    return _speculate(teacher_dec, teacher_cfg, teacher_cross, prompt_ids,
                      opts, gamma, propose, bias_fn, (teacher_cfg, draft_cfg),
                      pad_len, sot_slot, dtype, draft_prefill=prefill)


@torch.no_grad()
def ngram_speculative_generate_batched(
        teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
        teacher_cross: Dict[str, Any],
        prompt_ids: torch.Tensor, opts: GenerationOptions,
        gamma: int = 5, max_ngram: int = 3,
        dtype: torch.dtype = torch.float32,
        synthetic_period: Optional[int] = None,
        synthetic_repeat_prob: Optional[float] = None,
        pad_len: Optional[torch.Tensor] = None,
        sot_slot: Optional[int] = None) -> SpeculativeOutput:
    """Prompt-lookup decoding: speculation with no draft model.  Proposals
    are copied from the continuation of the most recent repeat of each
    lane's last n-gram (:func:`_propose_ngram`); the teacher verifies as in
    :func:`speculative_generate_batched`, so the output is its greedy
    output.  ``drafted`` and ``accepted`` count rounds whose lookup found a
    match.

    ``synthetic_period`` (benchmark only) makes the teacher choose a period-R
    token stream, so after R tokens every lookup succeeds;
    ``synthetic_repeat_prob`` q dilutes it (each position repeats with
    probability q, else takes a unique filler token).  Output tokens are
    then synthetic."""
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    total_len = p + opts.max_new_tokens + gamma + 1
    bias_fn = None
    if synthetic_period is not None:
        repeat = None
        if synthetic_repeat_prob is not None and synthetic_repeat_prob < 1.0:
            repeat = synthetic_coins(9, total_len, synthetic_repeat_prob, dev)

        def bias_fn(scores, pos):
            return _bias_to(scores, _periodic_oracle(
                pos, synthetic_period, teacher_cfg.vocab_size, repeat))

    min_start = 0 if pad_len is None else pad_len.to(dev).long()

    def propose(tokens, win, ts):
        return _propose_ngram(tokens, win + 1, gamma, max_ngram,
                              teacher_cfg.pad_token_id, min_start=min_start)

    return _speculate(teacher_dec, teacher_cfg, teacher_cross, prompt_ids,
                      opts, gamma, propose, bias_fn, (teacher_cfg,), pad_len,
                      sot_slot, dtype)


def check_method(method: Optional[str], assistant) -> None:
    """The entry points' argument checks (JAX's): ``method`` is None,
    "draft" with an ``assistant=(draft_params, draft_cfg)``, or "ngram"
    without one."""
    if method not in (None, "draft", "ngram"):
        raise ValueError(f"unknown speculative_method {method!r}; use "
                         "'draft' or 'ngram'")
    if method == "draft" and assistant is None:
        raise ValueError("speculative_method='draft' requires "
                         "assistant=(draft_params, draft_cfg)")
    if method == "ngram" and assistant is not None:
        raise ValueError("pick ONE speculation method: assistant draft or "
                         "ngram lookup")


def prepare_assistant(assistant, dtype: torch.dtype, device):
    """The draft ``(params, cfg)`` under the teacher's policy: on the
    entry point's device, quantized by its own ``cfg.quantize_*`` flags, and
    in bf16 with the fast attention and the encoder kernel, as the entry
    points set them for the teacher.  Idempotent; None stays None."""
    if assistant is None:
        return None
    d_params, d_cfg = assistant
    check_params_device(d_params, device)
    d_params = maybe_quantize_encoder(d_params, d_cfg)
    if dtype == torch.bfloat16:
        d_cfg = d_cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    return d_params, d_cfg


def speculate_windows(params: Dict[str, Any], cfg: WhisperConfig,
                      mels: torch.Tensor, enc: torch.Tensor,
                      cross: Dict[str, Any], prompt_ids: torch.Tensor,
                      opts: GenerationOptions, method: str, assistant=None,
                      gamma: int = 5, max_ngram: int = 3,
                      dtype: torch.dtype = torch.float32,
                      pad_len: Optional[torch.Tensor] = None,
                      sot_slot: Optional[int] = None) -> SpeculativeOutput:
    """Speculative greedy decode of a batch of windows whose teacher
    encoder states and cross K/V are ``enc`` and ``cross``: ``method``
    "ngram", or "draft" with ``assistant=(draft_params, draft_cfg)``.  A
    draft of the teacher's width shares the teacher's encoder states (a
    distil draft keeps the teacher's encoder); another encodes ``mels``
    with its own encoder."""
    if method == "ngram":
        return ngram_speculative_generate_batched(
            params["decoder"], cfg, cross, prompt_ids, opts, gamma=gamma,
            max_ngram=max_ngram, dtype=dtype, pad_len=pad_len,
            sot_slot=sot_slot)
    d_params, d_cfg = assistant
    d_enc = (enc if d_cfg.d_model == cfg.d_model
             else encode(d_params["encoder"], d_cfg, mels, dtype=dtype))
    return speculative_generate_batched(
        params["decoder"], cfg, d_params["decoder"], d_cfg, cross,
        cross_kv(d_params["decoder"], d_cfg, d_enc), prompt_ids, opts,
        gamma=gamma, dtype=dtype, pad_len=pad_len, sot_slot=sot_slot)
