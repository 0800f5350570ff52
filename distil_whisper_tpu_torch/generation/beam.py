"""Beam search (HF semantics: length-penalised, 2K candidate pool).

Counterpart of ``distil_whisper_tpu.generation.beam``: JAX's
``lax.while_loop`` (``cond``: the budget and the HF early-stopping-false
stop rule; ``body``: one step of every beam) becomes, as in
:mod:`.generate`, a prefill and blocks of :data:`~.generate.BLOCK_STEPS`
steps over fixed device state, with one read of the device a block.  The
cursor, the length penalty (``cur ** length_penalty`` of the device cursor)
and the stop flag live on the device; a step taken after the flag is set
changes no token, score or cursor, so the outputs do not depend on the
block length.  On the card the prefill (cross K/V, repeated K times, the
prompt's decode of B·K rows, the no-speech probability) and the block
replay as CUDA graphs (:mod:`.graphs`), the counterpart of the jitted loop;
on the CPU the same body runs eagerly.

The KV cache carries a flattened beam dim and is re-gathered along it after
every reorder.  ``decode`` writes the cache in place, so a reorder must not
gather into the buffer it reads; the blocked loop keeps a ping-pong pair of
caches and gathers from one into the other (``index_select(out=)``), so
that the graph's state keeps its addresses and a step moves the cache once,
where a gather into scratch and a copy back would move it twice.  A block
of an odd number of steps copies the pair's second cache back into the
first at its end.

:func:`beam_search_eager` is the plain version: the step loop with an int
cursor, a read of the device at every step for the stop rule, and the
reorder into new buffers.  Tests and the smoke hold the blocked loop
against it bit for bit.  A tree sharded over a mesh searches through the
same loops as an unsharded one, its collectives on the groups' device
comms inside the graphs; under 2-D sharding the stop rule is agreed over
the data group (``generate._agree``), and a rank whose own rows have
stopped steps on with them masked (the plain loop: decodes whose results
it drops), so that every rank gathers the same layers.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import WhisperConfig
from ..device import resolve_device
from ..models.whisper import decode, encode, init_cache, kv_width
from ..parallel import device_comm
from . import graphs as G
from . import logits as L
from .generate import (BLOCK_STEPS, GenerationOptions, _agree,
                       _check_budget, _cross, _process_scores, _program_key,
                       _read_flags, _stop_group, check_params_device)

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


def _device_penalty(cur: torch.Tensor, length_penalty: float) -> torch.Tensor:
    """:func:`_penalty` of the device cursor ``cur`` (a 0-dim int tensor):
    the same 0-dim fp32 power, read from no host int."""
    return cur.float() ** length_penalty


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] -> x[b, idx[b, m]] as [B, M, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def _expand_beams(dec_params, cfg: WhisperConfig, cross, prompt_ids,
                  pad_len, k: int):
    """Cross K/V (projected here from encoder states), prompts and pad
    lengths of B rows repeated K times along the batch."""
    # every cross leaf (bf16 K/V, or int8 K/V and their scales) has the
    # batch on axis 1
    cross_bk = {name: arr.repeat_interleave(k, dim=1)
                for name, arr in _cross(dec_params, cfg, cross).items()}
    prompts_bk = prompt_ids.long().repeat_interleave(k, dim=0)
    pad_bk = (pad_len.long().repeat_interleave(k, dim=0)
              if pad_len is not None else None)
    return cross_bk, prompts_bk, pad_bk


def _no_speech_beam0(prefill_logits, opts: GenerationOptions, b: int, k: int,
                     sot_slot: int) -> torch.Tensor:
    """<|nospeech|> probability at the SOT slot of beam 0."""
    if opts.no_speech_token_id is None:
        return torch.zeros((b,), dtype=torch.float32,
                           device=prefill_logits.device)
    p = prefill_logits.shape[1]
    sot_logits = prefill_logits.view(b, k, p, -1)[:, 0, sot_slot]
    probs0 = torch.softmax(sot_logits.float(), dim=-1)
    return probs0[:, opts.no_speech_token_id]


def _finish(cfg: WhisperConfig, tokens, live_scores, fin_tokens, fin_scores,
            fin_sum, fin_len, cur, penalty, no_speech_prob) -> BeamOutput:
    """The best-live fallback where nothing finished, then the best beam;
    ``cur`` the final cursor (an int or a 0-dim tensor) and ``penalty`` its
    ``cur ** length_penalty``."""
    total = tokens.shape[2]
    live_final = live_scores / torch.clamp(penalty, min=1.0)
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
    iota = torch.arange(total, device=tokens.device)[None, :]
    sequences = torch.where(iota < seq_len[:, None], sequences,
                            cfg.pad_token_id)
    return BeamOutput(sequences=sequences, seq_len=seq_len, scores=scores,
                      sum_logprobs=sum_logprobs.float(),
                      no_speech_prob=no_speech_prob)


# ----------------------------------------------------------------------
# The plain version: the step loop, one read of the device a step
# ----------------------------------------------------------------------


@torch.no_grad()
def beam_search_eager(dec_params: Dict[str, Any], cfg: WhisperConfig,
                      cross, prompt_ids: torch.Tensor,
                      opts: GenerationOptions, num_beams: int = 5,
                      length_penalty: float = 1.0,
                      sot_slot: int = 0,
                      pad_len: Optional[torch.Tensor] = None,
                      dtype: torch.dtype = torch.float32) -> BeamOutput:
    """:func:`beam_search` as a step loop with an int cursor that reads the
    device at every step for the stop rule and skips the decode whose
    logits would never be read; the cache and the timestamp state are
    reordered into new buffers."""
    b, p = prompt_ids.shape
    k = num_beams
    total = _check_budget(cfg, p, opts)
    device = prompt_ids.device
    eos = cfg.eos_token_id
    vocab = cfg.vocab_size

    cross_bk, prompts_bk, pad_bk = _expand_beams(dec_params, cfg, cross,
                                                 prompt_ids, pad_len, k)
    prompt_ids = prompt_ids.long()
    cache = init_cache(cfg, b * k, dtype=dtype, max_len=total, device=device,
                       width=kv_width(dec_params))
    prefill_logits, cache = decode(dec_params, cfg, prompts_bk,
                                   cross=cross_bk, cache=cache, pos_offset=0,
                                   pad_len=pad_bk, dtype=dtype)
    no_speech_prob = _no_speech_beam0(prefill_logits, opts, b, k, sot_slot)

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

    group = _stop_group(dec_params, cfg)
    cur = p
    searching = cur < total      # this rank's rows: its own stop rule
    if not searching:
        return _finish(cfg, tokens, live_scores, fin_tokens, fin_scores,
                       fin_sum, fin_len, cur,
                       _penalty(cur, length_penalty, device), no_speech_prob)
    while True:
        if not searching:
            # another data rank searches on: the same decode, dropped
            decode(dec_params, cfg, live_tok.reshape(-1, 1), cross=cross_bk,
                   cache=cache, pos_offset=cur - 1, pad_len=pad_bk,
                   dtype=dtype)
            if not device_comm.host_read(_agree(torch.zeros(
                    (), dtype=torch.int32, device=device), group)):
                break
            continue
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
        searching = cur < total and improvable(cur, live_scores, fin_scores)
        if not device_comm.host_read(_agree(torch.full(
                (), int(searching), dtype=torch.int32, device=device),
                group)):
            break
        if not searching:
            continue
        lg, cache = decode(dec_params, cfg, live_tok.reshape(-1, 1),
                           cross=cross_bk, cache=cache, pos_offset=cur - 1,
                           pad_len=pad_bk, dtype=dtype)
        last_logits = lg[:, -1].float()

    return _finish(cfg, tokens, live_scores, fin_tokens, fin_scores, fin_sum,
                   fin_len, cur, _penalty(cur, length_penalty, device),
                   no_speech_prob)


# ----------------------------------------------------------------------
# The blocked loop: a body over device state, run in blocks
# ----------------------------------------------------------------------


def _beam_prefill(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
                  cross, prompt_ids: torch.Tensor, k: int, sot_slot: int,
                  pad_len, dtype: torch.dtype) -> Dict[str, Any]:
    """The loop's state after the prompt (JAX's initial ``state``): cross
    K/V of B·K rows, the ping-pong pair of caches (the first holding the
    prompt), the no-speech probability, the live and finished beams, the
    last logits, the timestamp state, the device cursor [B·K] and the stop
    flag (set where the budget is 0)."""
    b, p = prompt_ids.shape
    total = p + opts.max_new_tokens
    device = prompt_ids.device
    cross_bk, prompts_bk, pad_bk = _expand_beams(dec_params, cfg, cross,
                                                 prompt_ids, pad_len, k)
    caches = [init_cache(cfg, b * k, dtype=dtype, max_len=total,
                         device=device, width=kv_width(dec_params))
              for _ in range(2)]
    prefill_logits, _ = decode(dec_params, cfg, prompts_bk, cross=cross_bk,
                               cache=caches[0], pos_offset=0, pad_len=pad_bk,
                               dtype=dtype)
    tokens = torch.full((b, k, total), cfg.pad_token_id, dtype=torch.long,
                        device=device)
    tokens[:, :, :p] = prompt_ids.long()[:, None, :]
    live_scores = torch.full((b, k), NEG_INF, device=device)
    live_scores[:, 0] = 0.0
    cur = torch.full((b * k,), p, dtype=torch.long, device=device)
    return dict(
        cross=cross_bk, pad_len=pad_bk, caches=caches, tokens=tokens,
        live_scores=live_scores, fin_tokens=tokens.clone(),
        fin_scores=torch.full((b, k), NEG_INF, device=device),
        fin_sum=torch.full((b, k), NEG_INF, device=device),
        fin_len=torch.full((b, k), p, dtype=torch.long, device=device),
        last_logits=prefill_logits[:, -1].float(),
        ts=L.TimestampState.init(b * k, device), cur=cur,
        done=cur[0] >= total,
        no_speech_prob=_no_speech_beam0(prefill_logits, opts, b, k,
                                        sot_slot))


def _beam_step(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
               s: Dict[str, Any], prompt_len: int, length_penalty: float,
               src: Dict[str, torch.Tensor], dst: Dict[str, torch.Tensor],
               dtype: torch.dtype) -> None:
    """One step of every beam at the device cursor, in place (JAX's
    ``body``, then its ``cond`` into the stop flag), reading the cache
    ``src`` and leaving the reordered cache, with the new token's K/V, in
    ``dst``.  While the flag is set a step changes no token, score,
    timestamp state or cursor; its cache and logits are never read."""
    tokens = s["tokens"]
    b, k, total = tokens.shape
    vocab = cfg.vocab_size
    eos = cfg.eos_token_id
    cur = s["cur"]
    at = cur[0]
    go = ~s["done"]
    logp = torch.log_softmax(s["last_logits"], dim=-1)
    logp = _process_scores(logp, cur - prompt_len, s["ts"], cfg, opts,
                           prompt_len)
    cand = s["live_scores"][:, :, None] + logp.view(b, k, vocab)

    top_scores, top_idx = torch.topk(cand.view(b, k * vocab), 2 * k, dim=1)
    src_beam = top_idx // vocab
    tok = top_idx % vocab
    cand_tokens = _gather_beams(tokens, src_beam)
    is_eos = tok == eos
    penalty = _device_penalty(at, length_penalty)
    fin_cand_scores = torch.where(is_eos, top_scores / penalty, NEG_INF)

    all_fin_scores = torch.cat([s["fin_scores"], fin_cand_scores], 1)
    all_fin_sum = torch.cat(
        [s["fin_sum"], torch.where(is_eos, top_scores, NEG_INF)], 1)
    all_fin_tokens = torch.cat([s["fin_tokens"], cand_tokens], 1)
    all_fin_len = torch.cat([s["fin_len"], at.expand(b, 2 * k)], 1)
    fin_scores, fin_idx = torch.topk(all_fin_scores, k, dim=1)
    fin_tokens = _gather_beams(all_fin_tokens, fin_idx)
    fin_sum = all_fin_sum.gather(1, fin_idx)
    fin_len = all_fin_len.gather(1, fin_idx)

    live_cand = torch.where(is_eos, NEG_INF, top_scores)
    live_scores, live_idx = torch.topk(live_cand, k, dim=1)
    live_src = src_beam.gather(1, live_idx)
    live_tok = tok.gather(1, live_idx)
    new_tokens = _gather_beams(tokens, live_src)
    # ``at`` < total while the flag is clear; clamped for a masked step
    new_tokens.index_copy_(2, at.clamp(max=total - 1).view(1),
                           live_tok[:, :, None])

    flat_src = ((torch.arange(b, device=tokens.device) * k)[:, None]
                + live_src).reshape(-1)
    for name, x in src.items():
        torch.index_select(x, 1, flat_src, out=dst[name])
    ts = s["ts"]
    new_ts = L.TimestampState(*(f.index_select(0, flat_src) for f in ts))
    new_ts = new_ts.update(live_tok.reshape(-1), cfg.timestamp_begin)

    for name, new in (("tokens", new_tokens), ("live_scores", live_scores),
                      ("fin_tokens", fin_tokens), ("fin_scores", fin_scores),
                      ("fin_sum", fin_sum), ("fin_len", fin_len)):
        s[name].copy_(torch.where(go, new, s[name]))
    for o, n in zip(ts, new_ts):
        o.copy_(torch.where(go, n, o))
    cur.add_(go.long())
    # HF early_stopping=False: stop when the budget is spent or no live
    # beam, penalised at the new length, can beat the worst finished one
    max_live = s["live_scores"].amax(dim=1) / _device_penalty(
        cur[0], length_penalty)
    improvable = (max_live > s["fin_scores"].amin(dim=1)).any()
    s["done"].copy_(s["done"] | ~(cur[0] < total) | ~improvable)

    lg, _ = decode(dec_params, cfg, live_tok.reshape(-1, 1), cross=s["cross"],
                   cache=dst, pos_offset=cur - 1, pad_len=s["pad_len"],
                   dtype=dtype)
    s["last_logits"].copy_(lg[:, -1].float())


def _beam_block(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
                s: Dict[str, Any], steps: int, prompt_len: int,
                length_penalty: float, dtype: torch.dtype) -> torch.Tensor:
    """``steps`` steps over the ping-pong caches (an odd count copies the
    second back into the first); returns ``[done, cursor]`` (int64 [2]),
    the one vector the host reads a block."""
    caches = s["caches"]
    for i in range(steps):
        _beam_step(dec_params, cfg, opts, s, prompt_len, length_penalty,
                   caches[i % 2], caches[(i + 1) % 2], dtype)
    if steps % 2:
        for name, x in caches[1].items():
            caches[0][name].copy_(x)
    left = _agree((~s["done"]).long(), _stop_group(dec_params, cfg))
    return torch.stack([(left == 0).long(), s["cur"][0]])


def _beam_output(cfg: WhisperConfig, s: Dict[str, Any],
                 length_penalty: float) -> BeamOutput:
    """The best-live fallback and the best beam, from the loop's state."""
    at = s["cur"][0]
    return _finish(cfg, s["tokens"], s["live_scores"], s["fin_tokens"],
                   s["fin_scores"], s["fin_sum"], s["fin_len"], at,
                   _device_penalty(at, length_penalty), s["no_speech_prob"])


class _Program(NamedTuple):
    """A captured beam search: the weights its graphs read, its static
    inputs, the prefill and block graphs, and the state and flags they
    rewrite."""
    dec_params: Dict[str, Any]
    inputs: Dict[str, Any]
    prefill: G.Graph
    block: G.Graph
    state: Dict[str, Any]
    flags: torch.Tensor


def _capture(owner: G.GraphOwner, dec_params, cfg: WhisperConfig,
             opts: GenerationOptions, values: Dict[str, Any], k: int,
             length_penalty: float, sot_slot: int, dtype: torch.dtype,
             steps: int) -> _Program:
    """Warm the prefill and one step up on the owner's stream, then capture
    the prefill and a block of ``steps`` steps."""
    device = values["prompt"].device
    p = values["prompt"].shape[1]
    inputs = G.static_like(values)
    G.load(inputs, values)

    def prefill():
        return _beam_prefill(dec_params, cfg, opts, inputs["cross"],
                             inputs["prompt"], k, sot_slot,
                             inputs["pad_len"], dtype)

    def block(state, n):
        return _beam_block(dec_params, cfg, opts, state, n, p,
                           length_penalty, dtype)

    with owner.side(device):
        block(prefill(), 1)
    prefill_graph, state = owner.capture(prefill, device)
    block_graph, flags = owner.capture(lambda: block(state, steps), device)
    return _Program(dec_params, inputs, prefill_graph, block_graph, state,
                    flags)


def _beam_key(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
              cross, prompt_ids, pad_len, sot_slot, dtype, steps: int,
              num_beams: int, length_penalty: float):
    """The key of ``generate``'s program (rows, prompt length, options,
    layout, block length, weights) led by the beams and the length
    penalty."""
    return (("beam", num_beams, float(length_penalty))
            + _program_key(dec_params, cfg, opts, cross, prompt_ids, pad_len,
                           sot_slot, dtype, steps))


@torch.no_grad()
def beam_search(dec_params: Dict[str, Any], cfg: WhisperConfig,
                cross, prompt_ids: torch.Tensor,
                opts: GenerationOptions, num_beams: int = 5,
                length_penalty: float = 1.0,
                sot_slot: int = 0,
                pad_len: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                graphs: Optional[G.GraphOwner] = None) -> BeamOutput:
    """HF-style beam search of ``num_beams`` beams a row of ``prompt_ids``
    [B, P].

    ``cross`` is the encoder states [B, T, d] (the cross-attention K/V are
    then projected inside the prefill: on the card inside its graph) or
    precomputed K/V of B rows (:func:`...models.cross_kv`, copied once a
    call into the graph's buffers on the card); either is repeated K times
    inside the prefill.

    ``sot_slot``: prompt position of <|startoftranscript|> (0 for plain
    prompts; the SOT index for condition-on-prev prompts), where
    no_speech_prob is read.  ``pad_len`` [B]: left-padded prompts, masked
    out of self-attention with positions shifted per sample, as in
    ``generate()``.

    The loop runs in blocks of :data:`~.generate.BLOCK_STEPS` steps (fewer
    for a smaller budget) with one read of the device a block.  On a CUDA
    tensor the prefill and the block replay as CUDA graphs, captured at the
    first call of each shape and setting into ``graphs`` (an owner's pool,
    stream and cache; without one the call captures into an owner of its
    own, freed when it returns).  A failed capture raises.  A tree sharded
    over a mesh searches alike (every rank of its groups calls it alike)."""
    p = prompt_ids.shape[1]
    total = _check_budget(cfg, p, opts)
    device = prompt_ids.device
    k = num_beams
    steps = max(1, min(BLOCK_STEPS, opts.max_new_tokens))
    if pad_len is not None:
        pad_len = pad_len.to(device).long()
    if device.type != "cuda":
        s = _beam_prefill(dec_params, cfg, opts, cross, prompt_ids, k,
                          sot_slot, pad_len, dtype)
        while not _read_flags(_beam_block(dec_params, cfg, opts, s, steps, p,
                                          length_penalty, dtype), total):
            pass
        return _beam_output(cfg, s, length_penalty)

    owner = graphs if graphs is not None else G.GraphOwner("beam_search")
    values = dict(cross=cross, prompt=prompt_ids.long(), pad_len=pad_len)
    key = _beam_key(dec_params, cfg, opts, cross, prompt_ids, pad_len,
                    sot_slot, dtype, steps, k, length_penalty)
    with owner.lock:
        prog = owner.entry(key, lambda: _capture(
            owner, dec_params, cfg, opts, values, k, length_penalty,
            sot_slot, dtype, steps))
        G.load(prog.inputs, values)
        with owner.side(device):
            prog.prefill.replay()
            while True:
                prog.block.replay()
                if _read_flags(prog.flags, total):
                    break
        # fresh tensors: the state is rewritten by the next call
        return _beam_output(cfg, prog.state, length_penalty)


@torch.no_grad()
def encode_and_beam_search(params, cfg: WhisperConfig, mel, prompt_ids,
                           opts: GenerationOptions, num_beams: int = 5,
                           length_penalty: float = 1.0, sot_slot: int = 0,
                           pad_len=None, dtype: torch.dtype = torch.float32,
                           device="cuda",
                           graphs: Optional[G.GraphOwner] = None
                           ) -> BeamOutput:
    """mel [B, n_mels, 3000] + prompt [B, P] -> BeamOutput, on ``device``
    (where ``params`` must already live): the encoder, then
    :func:`beam_search` on its states."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    mel = torch.as_tensor(mel).to(dev)
    prompt_ids = torch.as_tensor(prompt_ids).to(dev)
    if pad_len is not None:
        pad_len = torch.as_tensor(pad_len).to(dev)
    enc = encode(params["encoder"], cfg, mel, dtype=dtype)
    return beam_search(params["decoder"], cfg, enc, prompt_ids, opts,
                       num_beams=num_beams, length_penalty=length_penalty,
                       sot_slot=sot_slot, pad_len=pad_len, dtype=dtype,
                       graphs=graphs)
