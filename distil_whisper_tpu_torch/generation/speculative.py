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
``torch.where`` while the others go on, as the vmapped loop freezes it.
JAX's ``while_loop`` becomes a prefill and blocks of
:data:`ROUNDS_PER_BLOCK` rounds over fixed state buffers, every round
written in place, with one read of the device a block (JAX's ``cond``);
a round after every lane has finished is fully masked and changes no
output.  On the card the prefill (both models' cross K/V, the prompt's
decodes, the first token) and the block replay as CUDA graphs
(:mod:`.graphs`), the counterpart of JAX's one compiled loop; on the CPU
the same bodies run eagerly.  The caches are written in place; a finished
lane's decode rewrites the slots of its last window, whose values no
emitted token reads any more.  :func:`speculate_eager` is the plain
version (a read of the device every round), held bit for bit against the
blocked loop.  A teacher (and a draft) sharded over a mesh runs the same
loops, its collectives on the groups' device comms inside the graphs;
under 2-D sharding "a lane is active" is agreed over the data group
(``generate._agree``), a rank whose lanes have ended running masked
rounds, so that every rank gathers the same layers.

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

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import WhisperConfig
from ..models.whisper import decode, encode, init_cache, kv_width
from ..ops.quant import maybe_quantize_encoder
from . import graphs as G
from . import logits as L
from ..parallel import device_comm
from .generate import (GenerationOptions, _agree, _cross, _cross_layout,
                       _stop_group, check_params_device)
from .generate import _program_key as _decode_key


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


#: rounds a block: the host reads the device once a block.  Chosen on the
#: card: ``chip_smoke.py``'s ``speculative_path`` times 1, 2, 4 and 8 on
#: large-v3 with the distil draft (2 is the continuous engine's rule at
#: gamma 5) and on distil-large-v3's n-gram loop, and 1 is the fastest on
#: both (PERF.md §6): a round run past the last lane's end costs a whole
#: round, more than a host read.
ROUNDS_PER_BLOCK = 1


@dataclasses.dataclass(frozen=True)
class _Method:
    """What a loop proposes with, part of its program's key: the draft's
    config (None: n-gram lookup), the draft length, the lookup's longest
    n-gram and the benchmark knobs."""
    gamma: int
    draft_cfg: Optional[WhisperConfig] = None
    max_ngram: int = 3
    synthetic_acceptance: Optional[float] = None
    synthetic_period: Optional[int] = None
    synthetic_repeat_prob: Optional[float] = None


def _coins(m: _Method, b: int, length: int, device):
    """The knobs' coins on ``device``, drawn on the host:
    ``synthetic_acceptance``'s [b, length] (lane ``b`` from seed ``b``) and
    ``synthetic_repeat_prob``'s [length] (seed 9), each None when its knob
    is off.  A card gets them from pinned memory, without a sync."""
    def to_device(x):
        if torch.device(device).type != "cuda":
            return x.to(device)
        return x.pin_memory().to(device, non_blocking=True)

    coins = repeat = None
    if m.synthetic_acceptance is not None:
        coins = to_device(torch.stack([
            synthetic_coins(lane, length, m.synthetic_acceptance)
            for lane in range(b)]))
    if (m.synthetic_period is not None
            and m.synthetic_repeat_prob is not None
            and m.synthetic_repeat_prob < 1.0):
        repeat = to_device(synthetic_coins(9, length,
                                           m.synthetic_repeat_prob))
    return coins, repeat


class _Loop:
    """One speculative decode's fixed parts (the weights, the method, the
    options, the prompt length, the left-pad layout and the knobs' coins)
    and the loop's pieces over a state dict: the prefill, the proposals,
    the teacher's verify, one round in place, a block of rounds and the
    output."""

    def __init__(self, teacher_dec, cfg: WhisperConfig, draft_dec,
                 m: _Method, opts: GenerationOptions, prompt_len: int,
                 pad_len, sot_slot, coins, repeat, dtype):
        self.teacher_dec, self.cfg, self.draft_dec, self.m = (
            teacher_dec, cfg, draft_dec, m)
        self.opts, self.p, self.dtype = opts, prompt_len, dtype
        self.pad_len, self.sot_slot, self.coins = pad_len, sot_slot, coins
        self.total = prompt_len + opts.max_new_tokens
        # under 2-D sharding the data ranks agree on when to stop
        self.group = _stop_group(teacher_dec, cfg)
        self.bias_fn = None
        if m.synthetic_acceptance is not None:
            def bias_fn(scores, pos):
                return _bias_to(scores, _oracle(pos))
            self.bias_fn = bias_fn
        elif m.synthetic_period is not None:
            def bias_fn(scores, pos):
                return _bias_to(scores, _periodic_oracle(
                    pos, m.synthetic_period, cfg.vocab_size, repeat))
            self.bias_fn = bias_fn

    def prefill(self, t_cross, d_cross, prompt_ids) -> Dict[str, Any]:
        """The state after the prompt: each model's cross K/V (projected
        here from encoder states) and cache (the draft's holds the prompt
        but its last token), the no-speech probability, the teacher's
        first token, and each lane's cursor, window and counters."""
        cfg, opts, p, dtype = self.cfg, self.opts, self.p, self.dtype
        b = prompt_ids.shape[0]
        dev = prompt_ids.device
        prompt_ids = prompt_ids.long()
        # gamma + 1 slots of slack: the verify window may overhang the
        # budget near the end; the overhang is junk and sliced off
        size = self.total + self.m.gamma + 1
        s = {"t_cross": _cross(self.teacher_dec, cfg, t_cross),
             "t_cache": init_cache(cfg, b, dtype=dtype, max_len=size,
                                   device=dev,
                                   width=kv_width(self.teacher_dec))}
        t_logits, _ = decode(self.teacher_dec, cfg, prompt_ids,
                             cross=s["t_cross"], cache=s["t_cache"],
                             pos_offset=0, pad_len=self.pad_len, dtype=dtype)
        d_cfg = self.m.draft_cfg
        if d_cfg is not None:
            s["d_cross"] = _cross(self.draft_dec, d_cfg, d_cross)
            s["d_cache"] = init_cache(d_cfg, b, dtype=dtype, max_len=size,
                                      device=dev,
                                      width=kv_width(self.draft_dec))
            if p > 1:
                decode(self.draft_dec, d_cfg, prompt_ids[:, :-1],
                       cross=s["d_cross"], cache=s["d_cache"], pos_offset=0,
                       pad_len=self.pad_len, dtype=dtype)
        s["no_speech_prob"] = _no_speech(t_logits, opts, self.pad_len,
                                         self.sot_slot)

        # the first token comes from the teacher's prefill (position p)
        ts = L.TimestampState.init(b, dev)
        first = _process(t_logits[:, -1].float(), 0, cfg, opts, p,
                         ts_state=ts)
        if self.bias_fn is not None:
            first = self.bias_fn(first, torch.full((b,), p, device=dev))
        first_tok = torch.argmax(first, dim=-1)
        tokens = torch.full((b, size), cfg.pad_token_id, dtype=torch.long,
                            device=dev)
        tokens[:, :p] = prompt_ids
        tokens[:, p] = first_tok

        def lanes(value):
            return torch.full((b,), value, dtype=torch.long, device=dev)
        # a lane's window: the slot of its last accepted token while it
        # runs, its last window's slot once it has finished (in bounds by
        # construction: the cache never needs clamping)
        s.update(tokens=tokens, ts=ts.update(first_tok, cfg.timestamp_begin),
                 sum_logprobs=torch.log_softmax(first, dim=-1).gather(
                     1, first_tok[:, None])[:, 0],
                 cur=lanes(p + 1), win=lanes(p),
                 finished=first_tok == cfg.eos_token_id,
                 rounds=lanes(0), drafted=lanes(0), accepted=lanes(0))
        return s

    def propose(self, s: Dict[str, Any], win: torch.Tensor, ts):
        """``(drafts [B, gamma], found [B] or None)``: the draft model's or
        the n-gram lookup's proposals for lanes whose last accepted token
        sits at slot ``win``."""
        m, p = self.m, self.p
        if m.draft_cfg is None:
            return _propose_ngram(
                s["tokens"], win + 1, m.gamma, m.max_ngram,
                self.cfg.pad_token_id,
                min_start=0 if self.pad_len is None else self.pad_len)
        # the draft runs the same processor stack and timestamp FSM, from
        # the accepted prefix's state, so that its proposals are legal.  Its
        # first step feeds the slots win - 1 and win: slot win - 1 is the
        # last prompt token in the first round (the prefill stops one
        # short) and the last proposal after a fully accepted round, which
        # no step has fed
        d_cfg = m.draft_cfg
        tok = s["tokens"].gather(1, torch.stack([win - 1, win], dim=1))
        start, dts, out = win - 1, ts, []
        for _ in range(m.gamma):
            lg, _ = decode(self.draft_dec, d_cfg, tok, cross=s["d_cross"],
                           cache=s["d_cache"], pos_offset=start,
                           pad_len=self.pad_len, dtype=self.dtype)
            pos = start + tok.shape[1]            # the proposal's position
            scores = _process(lg[:, -1].float(), pos - p, d_cfg, self.opts,
                              p, ts_state=dts)
            if self.coins is not None:
                agree = self.coins.gather(1, pos[:, None])[:, 0]
                target = torch.where(agree, _oracle(pos), _oracle(pos) + 1)
                scores = _bias_to(scores, target)
            nxt = torch.argmax(scores, dim=-1)
            out.append(nxt)
            start, tok = pos, nxt[:, None]
            dts = dts.update(nxt, d_cfg.timestamp_begin)
        return torch.stack(out, dim=1), None

    def verify(self, s: Dict[str, Any], win: torch.Tensor, ts, drafts):
        """The teacher's ``gamma + 1``-wide decode of the last accepted
        token and the proposals at slot ``win``, and the acceptance:
        ``(window, n_eff, done, t_logp)`` (:func:`_verify_accept`, the
        teacher's log-probability of each column's choice)."""
        cfg, gamma = self.cfg, self.m.gamma
        t_in = torch.cat([s["tokens"].gather(1, win[:, None]), drafts], dim=1)
        t_logits, _ = decode(self.teacher_dec, cfg, t_in, cross=s["t_cross"],
                             cache=s["t_cache"], pos_offset=win,
                             pad_len=self.pad_len, dtype=self.dtype)
        t_choice, t_logp = _teacher_choices(t_logits, win + 1, self.p, gamma,
                                            cfg, self.opts, self.bias_fn,
                                            ts_state=ts, drafts=drafts)
        del t_logits
        window, n_eff, done = _verify_accept(t_choice, drafts, win + 1,
                                             self.total, cfg.eos_token_id,
                                             gamma)
        return window, n_eff, done, t_logp

    def round(self, s: Dict[str, Any]) -> None:
        """One accept/verify round of every lane, in place: every state
        tensor keeps its storage (a captured block rewrites the same
        buffers at each replay).  An inactive lane changes nothing but
        the cache slots of its frozen window, whose values no emitted
        token reads any more; a round past every lane's end changes no
        output."""
        cfg, gamma, total = self.cfg, self.m.gamma, self.total
        tokens, win, cur = s["tokens"], s["win"], s["cur"]
        finished, ts = s["finished"], s["ts"]
        active = ~finished & (cur < total)
        # the first slot of the verify window: a running lane's cursor
        base = win + 1
        drafts, found = self.propose(s, win, ts)
        window, n_eff, done, t_logp = self.verify(s, win, ts, drafts)
        idx = torch.arange(gamma + 1, device=tokens.device)[None, :]
        rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
        at = base[:, None] + idx
        tokens[rows, at] = torch.where(active[:, None], window,
                                       tokens[rows, at])
        emit = (idx <= n_eff[:, None]) & (base[:, None] + idx < total)
        gained = torch.where(emit, t_logp, 0.0).sum(dim=1)
        s["sum_logprobs"].copy_(torch.where(active, s["sum_logprobs"]
                                            + gained, s["sum_logprobs"]))
        g = gamma if found is None else torch.where(found, gamma, 0)
        got = n_eff if found is None else torch.minimum(n_eff, g)
        s["rounds"].add_(active.long())
        s["drafted"].add_(torch.where(active, g, 0))
        s["accepted"].add_(torch.where(active, got, 0))
        new_ts = [torch.where(active, n, o) for n, o in zip(
            _ts_advance(ts, window, n_eff, cfg.timestamp_begin), ts)]
        for o, n in zip(ts, new_ts):
            o.copy_(n)
        new_cur = base + n_eff + 1
        win.copy_(torch.where(active & ~done, new_cur - 1, win))
        finished.copy_(finished | (active & done))
        cur.copy_(torch.where(active, new_cur, cur))

    def active(self, finished: torch.Tensor, cur: torch.Tensor
               ) -> torch.Tensor:
        """Whether a lane is still active (a bool [] tensor): under 2-D
        sharding a lane of any rank of the data group."""
        running = (~finished & (cur < self.total)).sum()
        return _agree(running, self.group) > 0

    def block(self, s: Dict[str, Any], rounds: int) -> torch.Tensor:
        """``rounds`` rounds; returns whether a lane is still active (a
        bool [] tensor), the one value the host reads a block."""
        for _ in range(rounds):
            self.round(s)
        return self.active(s["finished"], s["cur"])

    def output(self, s: Dict[str, Any]) -> SpeculativeOutput:
        total = self.total
        seq_len = torch.clamp(s["cur"], max=total)
        keep = (torch.arange(total, device=seq_len.device)[None, :]
                < seq_len[:, None])
        sequences = torch.where(keep, s["tokens"][:, :total],
                                self.cfg.pad_token_id)
        return SpeculativeOutput(sequences=sequences, seq_len=seq_len,
                                 rounds=s["rounds"], drafted=s["drafted"],
                                 accepted=s["accepted"],
                                 sum_logprobs=s["sum_logprobs"],
                                 no_speech_prob=s["no_speech_prob"])


def _run_eager(loop: _Loop, t_cross, d_cross,
               prompt_ids: torch.Tensor) -> SpeculativeOutput:
    """The plain loop: one round at a time, every state tensor bound anew
    each round, and a read of the device a round that stops at the first
    round where no lane is active."""
    s = loop.prefill(t_cross, d_cross, prompt_ids)
    cfg, gamma, total = loop.cfg, loop.m.gamma, loop.total
    tokens, ts, cur, win = s["tokens"], s["ts"], s["cur"], s["win"]
    finished, sum_logprobs = s["finished"], s["sum_logprobs"]
    rounds, drafted, accepted = s["rounds"], s["drafted"], s["accepted"]
    idx = torch.arange(gamma + 1, device=tokens.device)[None, :]
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]

    active = ~finished & (cur < total)
    while device_comm.host_read(loop.active(finished, cur)):  # one sync
        base = win + 1
        drafts, found = loop.propose(s, win, ts)
        accepted_vec, n_eff, done, t_logp = loop.verify(s, win, ts, drafts)
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
        new_ts = _ts_advance(ts, accepted_vec, n_eff, cfg.timestamp_begin)
        ts = L.TimestampState(*(torch.where(active, n, o)
                                for n, o in zip(new_ts, ts)))
        new_cur = base + n_eff + 1
        finished = finished | (active & done)
        win = torch.where(active & ~done, new_cur - 1, win)
        cur = torch.where(active, new_cur, cur)
        active = ~finished & (cur < total)
    s.update(cur=cur, sum_logprobs=sum_logprobs, rounds=rounds,
             drafted=drafted, accepted=accepted)
    return loop.output(s)


def _read_flags(flags: torch.Tensor) -> bool:
    """The block's one host sync: True when no lane is active.  A
    collective that waits for a peer past the device comms' bound raises
    here."""
    G.bump("host_syncs")
    return not device_comm.host_read(flags)


class _Program(NamedTuple):
    """A captured speculative decode: its loop over the static inputs, the
    prefill and block graphs, and the state and flag they rewrite."""
    loop: _Loop
    inputs: Dict[str, Any]
    prefill: G.Graph
    block: G.Graph
    state: Dict[str, Any]
    flags: torch.Tensor


def _capture(owner: G.GraphOwner, make_loop, values: Dict[str, Any],
             rounds: int) -> _Program:
    """Warm the prefill and one round up on the owner's stream, then
    capture the prefill and a block of ``rounds`` rounds."""
    device = values["prompt"].device
    inputs = G.static_like(values)
    G.load(inputs, values)
    loop = make_loop(inputs["pad_len"], inputs["coins"], inputs["repeat"])

    def prefill():
        return loop.prefill(inputs["t_cross"], inputs["d_cross"],
                            inputs["prompt"])

    with owner.side(device):
        loop.block(prefill(), 1)
    prefill_graph, state = owner.capture(prefill, device)
    block_graph, flags = owner.capture(lambda: loop.block(state, rounds),
                                       device)
    return _Program(loop, inputs, prefill_graph, block_graph, state, flags)


def _program_key(teacher_dec, cfg: WhisperConfig, draft_dec, m: _Method,
                 t_cross, d_cross, prompt_ids, opts: GenerationOptions,
                 pad_len, sot_slot, dtype, rounds: int):
    """The key of ``generate``'s program for the teacher's decode (rounds in
    place of steps) with the method (draft length, lookup, knobs and the
    draft's config), the draft's cross-attention layout and the draft's
    weights."""
    return ((m, None if d_cross is None else _cross_layout(d_cross),
             () if draft_dec is None else G.params_key(draft_dec))
            + _decode_key(teacher_dec, cfg, opts, t_cross, prompt_ids,
                          pad_len, sot_slot, dtype, rounds))


def _speculate(teacher_dec: Dict[str, Any], cfg: WhisperConfig, draft_dec,
               m: _Method, t_cross, d_cross, prompt_ids: torch.Tensor,
               opts: GenerationOptions, pad_len, sot_slot, dtype,
               graphs: Optional[G.GraphOwner],
               eager: bool = False) -> SpeculativeOutput:
    """Both methods' loop: checks, the knobs' coins, then the plain loop
    (``eager``), the blocked loop run eagerly (CPU tensors) or its
    captured program (CUDA tensors), sharded trees alike."""
    b, p = prompt_ids.shape
    limit = min(c.max_target_positions
                for c in (cfg, m.draft_cfg) if c is not None)
    if p + opts.max_new_tokens > limit:
        raise ValueError(f"prompt({p}) + max_new({opts.max_new_tokens}) "
                         "exceeds the models' max_target_positions")
    if m.gamma < 1:
        raise ValueError(f"gamma must be at least 1, got {m.gamma}")
    dev = prompt_ids.device
    if pad_len is not None:
        pad_len = pad_len.to(dev).long()
    coins, repeat = _coins(m, b, p + opts.max_new_tokens + m.gamma + 1, dev)

    def make_loop(pad_len, coins, repeat):
        return _Loop(teacher_dec, cfg, draft_dec, m, opts, p, pad_len,
                     sot_slot, coins, repeat, dtype)

    if eager:
        return _run_eager(make_loop(pad_len, coins, repeat), t_cross,
                          d_cross, prompt_ids)
    rounds = ROUNDS_PER_BLOCK
    if dev.type != "cuda":
        loop = make_loop(pad_len, coins, repeat)
        s = loop.prefill(t_cross, d_cross, prompt_ids)
        while not _read_flags(loop.block(s, rounds)):
            pass
        return loop.output(s)

    owner = graphs if graphs is not None else G.GraphOwner("speculate")
    values = dict(t_cross=t_cross, d_cross=d_cross, prompt=prompt_ids.long(),
                  pad_len=pad_len, coins=coins, repeat=repeat)
    key = _program_key(teacher_dec, cfg, draft_dec, m, t_cross, d_cross,
                       prompt_ids, opts, pad_len, sot_slot, dtype, rounds)
    with owner.lock:
        prog = owner.entry(key, lambda: _capture(owner, make_loop, values,
                                                 rounds))
        G.load(prog.inputs, values)
        with owner.side(dev):
            prog.prefill.replay()
            while True:
                prog.block.replay()
                if _read_flags(prog.flags):
                    break
            # the state is rewritten by the next call: hand out copies
            return SpeculativeOutput(*(t.clone() for t in
                                       prog.loop.output(prog.state)))


@torch.no_grad()
def speculate_eager(teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
                    teacher_cross, prompt_ids: torch.Tensor,
                    opts: GenerationOptions, gamma: int = 5, draft=None,
                    max_ngram: int = 3, dtype: torch.dtype = torch.float32,
                    synthetic_acceptance: Optional[float] = None,
                    synthetic_period: Optional[int] = None,
                    synthetic_repeat_prob: Optional[float] = None,
                    pad_len: Optional[torch.Tensor] = None,
                    sot_slot: Optional[int] = None) -> SpeculativeOutput:
    """The plain version of both methods: the accept/verify loop one
    round at a time, reading the device every round and stopping at the
    first round where no lane is active.  ``draft=(draft_dec, draft_cfg,
    draft_cross)`` speculates with a draft model, None by n-gram lookup;
    the other arguments are those of :func:`speculative_generate_batched`
    and :func:`ngram_speculative_generate_batched`.  Tests and the smoke
    hold the blocked loops against it bit for bit."""
    d_dec, d_cfg, d_cross = draft if draft is not None else (None,) * 3
    m = _Method(int(gamma), d_cfg, int(max_ngram), synthetic_acceptance,
                synthetic_period, synthetic_repeat_prob)
    return _speculate(teacher_dec, teacher_cfg, d_dec, m, teacher_cross,
                      d_cross, prompt_ids, opts, pad_len, sot_slot, dtype,
                      None, eager=True)


@torch.no_grad()
def speculative_generate_batched(
        teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
        draft_dec: Dict[str, Any], draft_cfg: WhisperConfig,
        teacher_cross, draft_cross,
        prompt_ids: torch.Tensor, opts: GenerationOptions,
        gamma: int = 5, dtype: torch.dtype = torch.float32,
        synthetic_acceptance: Optional[float] = None,
        pad_len: Optional[torch.Tensor] = None,
        sot_slot: Optional[int] = None,
        graphs: Optional[G.GraphOwner] = None) -> SpeculativeOutput:
    """Greedy speculative decoding of a batch of lanes: the draft
    (``draft_dec`` on its own ``draft_cross``, often the teacher's encoder
    states) proposes ``gamma`` tokens a round, the teacher verifies them in
    one decode.  Token for token the teacher's greedy ``generate``, with
    ``opts.return_timestamps`` too.

    ``teacher_cross`` and ``draft_cross`` are encoder states [B, T, d]
    (each model's cross K/V are then projected inside the prefill: on the
    card inside its graph, never copied) or precomputed K/V
    (:func:`...models.cross_kv`, copied once a call into the graph's
    buffers on the card).

    ``pad_len`` [B] and ``sot_slot`` take the left-padded prompt layout of
    :mod:`.sequential`; with ``sum_logprobs`` and ``no_speech_prob`` this is
    a drop-in for ``generate`` at the sequential ladder's greedy rung.

    ``synthetic_acceptance`` (benchmark only): both models run their full
    compute, but the teacher always chooses a position-keyed oracle token
    and the draft proposes it with this probability per token (lane ``b``
    draws its coins from seed ``b``), so a round accepts the prefix law's
    share.  The output tokens are then synthetic.

    The rounds run in blocks of :data:`ROUNDS_PER_BLOCK` with one read of
    the device a block.  On a CUDA tensor the prefill and the block replay
    as CUDA graphs, captured at the first call of each shape and setting
    into ``graphs`` (an owner's pool, stream and cache; without one the
    call captures into an owner of its own, freed when it returns).  A
    failed capture raises.  A tree sharded over a process group decodes
    through :func:`speculate_eager`.

    Returns per-lane ``rounds``, ``drafted`` and ``accepted`` [B]."""
    m = _Method(int(gamma), draft_cfg,
                synthetic_acceptance=synthetic_acceptance)
    return _speculate(teacher_dec, teacher_cfg, draft_dec, m, teacher_cross,
                      draft_cross, prompt_ids, opts, pad_len, sot_slot, dtype,
                      graphs)


@torch.no_grad()
def ngram_speculative_generate_batched(
        teacher_dec: Dict[str, Any], teacher_cfg: WhisperConfig,
        teacher_cross, prompt_ids: torch.Tensor, opts: GenerationOptions,
        gamma: int = 5, max_ngram: int = 3,
        dtype: torch.dtype = torch.float32,
        synthetic_period: Optional[int] = None,
        synthetic_repeat_prob: Optional[float] = None,
        pad_len: Optional[torch.Tensor] = None,
        sot_slot: Optional[int] = None,
        graphs: Optional[G.GraphOwner] = None) -> SpeculativeOutput:
    """Prompt-lookup decoding: speculation with no draft model.  Proposals
    are copied from the continuation of the most recent repeat of each
    lane's last n-gram (:func:`_propose_ngram`); the teacher verifies as in
    :func:`speculative_generate_batched` (``teacher_cross``, the blocks,
    the graphs and ``graphs`` as there), so the output is its greedy
    output.  ``drafted`` and ``accepted`` count rounds whose lookup found a
    match.

    ``synthetic_period`` (benchmark only) makes the teacher choose a period-R
    token stream, so after R tokens every lookup succeeds;
    ``synthetic_repeat_prob`` q dilutes it (each position repeats with
    probability q, else takes a unique filler token).  Output tokens are
    then synthetic."""
    m = _Method(int(gamma), None, int(max_ngram),
                synthetic_period=synthetic_period,
                synthetic_repeat_prob=synthetic_repeat_prob)
    return _speculate(teacher_dec, teacher_cfg, None, m, teacher_cross, None,
                      prompt_ids, opts, pad_len, sot_slot, dtype, graphs)


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


def prepare_assistant(assistant, dtype: torch.dtype, device, mesh=None):
    """The draft ``(params, cfg)`` under the teacher's policy: on the
    entry point's device, quantized by its own ``cfg.quantize_*`` flags,
    sharded over the teacher's ``mesh`` (the model axis must divide the
    draft's heads too), and in bf16 with the fast attention and the encoder
    kernel, as the entry points set them for the teacher.  Call it once on
    an unsharded draft; None stays None."""
    if assistant is None:
        return None
    d_params, d_cfg = assistant
    check_params_device(d_params, device)
    d_params = maybe_quantize_encoder(d_params, d_cfg)
    if mesh is not None:
        from ..parallel.mesh import shard_params
        d_params = shard_params(d_params, mesh, cfg=d_cfg)
    if dtype == torch.bfloat16:
        d_cfg = d_cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    return d_params, d_cfg


def speculate_windows(params: Dict[str, Any], cfg: WhisperConfig,
                      mels: torch.Tensor, enc: torch.Tensor,
                      prompt_ids: torch.Tensor, opts: GenerationOptions,
                      method: str, assistant=None, gamma: int = 5,
                      max_ngram: int = 3, dtype: torch.dtype = torch.float32,
                      pad_len: Optional[torch.Tensor] = None,
                      sot_slot: Optional[int] = None,
                      graphs: Optional[G.GraphOwner] = None
                      ) -> SpeculativeOutput:
    """Speculative greedy decode of a batch of windows whose teacher
    encoder states are ``enc``: ``method`` "ngram", or "draft" with
    ``assistant=(draft_params, draft_cfg)``, in ``graphs``' programs on the
    card.  A draft of the teacher's width shares the teacher's encoder
    states (a distil draft keeps the teacher's encoder); another encodes
    ``mels`` with its own encoder.  Each model's cross K/V are projected
    inside the loop's prefill."""
    if method == "ngram":
        return ngram_speculative_generate_batched(
            params["decoder"], cfg, enc, prompt_ids, opts, gamma=gamma,
            max_ngram=max_ngram, dtype=dtype, pad_len=pad_len,
            sot_slot=sot_slot, graphs=graphs)
    d_params, d_cfg = assistant
    d_enc = (enc if d_cfg.d_model == cfg.d_model
             else encode(d_params["encoder"], d_cfg, mels, dtype=dtype))
    return speculative_generate_batched(
        params["decoder"], cfg, d_params["decoder"], d_cfg, enc, d_enc,
        prompt_ids, opts, gamma=gamma, dtype=dtype, pad_len=pad_len,
        sot_slot=sot_slot, graphs=graphs)
