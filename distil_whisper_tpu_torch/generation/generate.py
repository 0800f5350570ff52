"""Autoregressive generation (greedy and sampling) with the Whisper logits
rules.

Counterpart of ``distil_whisper_tpu.generation.generate``: a static token
budget, a static-shape KV cache, and the processor stack of :mod:`.logits`.
JAX's ``lax.while_loop`` becomes a loop over blocks of :data:`BLOCK_STEPS`
steps: the body is a function of device state with a per-lane device
cursor (JAX's ``body``), every lane at the same cursor, and the host reads
"every row finished" and the cursor once a block (JAX's ``cond``).  On the
card the prefill (cross K/V, the prompt's decode, the no-speech
probability) and the block run as CUDA graphs (:mod:`.graphs`),
the counterpart of :func:`build_generate`'s one compiled program; on the
CPU the same body runs eagerly.  The outputs do not depend on the block
length: a finished row writes pads and adds 0, and a step past the budget
writes and moves nothing (its decode writes K/V into the last cache slot,
whose logits are never read).

:func:`generate_eager` is the plain version: the step loop with an int
cursor that stops at the first step where every row has finished, reading
the device at every step.  Tests and the smoke hold the blocked loop
against it bit for bit.

A tree sharded over a mesh (tensor parallel over 'model', 2-D over
'data') decodes through the same blocked loop and, on the card, the same
graphs: its collectives run on the groups' device comms
(``parallel/device_comm.py``), which a graph captures, and every rank of a
group replays the same programs in the same order.  Under 2-D sharding
the data ranks hold other rows but gather every layer together, so they
must run the same steps: the stop flag a block (or a step, in the plain
loop) is agreed over the data group, the sum of the rows still running
(:func:`_agree`); a rank whose rows have all ended steps on with them
masked, as past an early stop.  The ranks of a model group hold the same
rows and, the device comm combining in rank order, the same bits.

Sampling draws from an explicit ``torch.Generator``, by the exponential
race ``argmax(p / q)`` with ``q ~ Exp(1)`` (``torch.multinomial``'s own
one-sample method, without its host-side checks of the probabilities, which
a graph cannot hold).  JAX splits a threefry key per step; the two cannot
give the same draws, only the same distribution.  The temperature is a
device scalar, so the sequential ladder's rungs replay one sampling graph,
as JAX's traced temperature reuses one program.

Everything returned is fixed-shape; host-side code slices with ``seq_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..device import resolve_device
from ..models.whisper import cross_kv, decode, encode, init_cache, kv_width
from ..parallel import device_comm, fsdp, groups
from ..parallel import tensor_parallel as tp
from . import graphs as G
from . import logits as L

#: steps a block: the host reads the device once a block.  Chosen on the
#: card: ``chip_smoke.py``'s ``compiled_decode_path`` times 4, 8, 16 and 32
#: on distil-large-v3 at 16 windows × 128 tokens, flat from 8 up (PERF.md
#: §6); 16 bounds the steps run past an early stop.
BLOCK_STEPS = 16


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


def _process_scores(scores, gen_idx, ts_state, cfg: WhisperConfig,
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


def _temperature(temperature, device) -> torch.Tensor:
    """The temperature as a 0-dim fp32 tensor on ``device``, made by a fill
    (no copy from the host)."""
    if isinstance(temperature, torch.Tensor):
        return temperature.to(device=device, dtype=torch.float32)
    return torch.full((), float(temperature), dtype=torch.float32,
                      device=device)


def _select(scores: torch.Tensor, temperature,
            generator: Optional[torch.Generator],
            opts: GenerationOptions) -> torch.Tensor:
    """Greedy or temperature (+ top-k) sampling over processed scores;
    ``temperature`` a number or a 0-dim tensor."""
    if not opts.do_sample:
        return torch.argmax(scores, dim=-1)
    temp = _temperature(temperature, scores.device)
    s = scores.float() / temp.clamp(min=1e-6)
    if opts.top_k > 0:
        kth = torch.topk(s, opts.top_k, dim=-1).values[:, -1:]
        s = s.masked_fill(s < kth, L.NEG_INF)
    probs = torch.softmax(s, dim=-1)
    q = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _no_speech(prefill_logits, opts: GenerationOptions, pad_len,
               sot_slot: Optional[int]) -> torch.Tensor:
    """<|nospeech|> probability from the raw logits at the SOT position:
    ``sot_slot`` when given, else ``pad_len[b]``, else 0."""
    b = prefill_logits.shape[0]
    device = prefill_logits.device
    if opts.no_speech_token_id is None:
        return torch.zeros((b,), dtype=torch.float32, device=device)
    if sot_slot is not None:
        sot_logits = prefill_logits[:, sot_slot]
    elif pad_len is None:
        sot_logits = prefill_logits[:, 0]
    else:
        sot_logits = prefill_logits[torch.arange(b, device=device),
                                    pad_len.long()]
    probs0 = torch.softmax(sot_logits.float(), dim=-1)
    return probs0[:, opts.no_speech_token_id]


def _cross(dec_params, cfg: WhisperConfig, cross):
    """``cross`` as cross K/V: a dict is already K/V; a tensor is the
    encoder states, projected here."""
    if isinstance(cross, torch.Tensor):
        return cross_kv(dec_params, cfg, cross)
    return cross


def _check_budget(cfg: WhisperConfig, p: int, opts: GenerationOptions) -> int:
    total = p + opts.max_new_tokens
    if total > cfg.max_target_positions:
        raise ValueError(f"prompt({p}) + max_new({opts.max_new_tokens}) "
                         f"exceeds {cfg.max_target_positions}")
    return total


def _mesh_groups(dec_params: Dict[str, Any], cfg: WhisperConfig):
    """``(model group, data group)`` a tree is sharded over (None for an
    axis it is not sharded over)."""
    q = dec_params["layers"]["self_attn"]["q"]
    w = q["kernel"] if "kernel" in q else q["kernel_q"]
    dp = fsdp.degree(w, cfg.d_model)
    return (tp.group_of(q, cfg.d_model),
            None if dp == 1 else groups.group_for("data", dp))


def _stop_group(dec_params: Dict[str, Any], cfg: WhisperConfig):
    """The group whose ranks must agree to stop decoding this tree: its
    data group under 2-D sharding (else None)."""
    return _mesh_groups(dec_params, cfg)[1]


def _agree(count: torch.Tensor, group) -> torch.Tensor:
    """``count`` (a 0-dim integer tensor: this rank's rows, beams or lanes
    still running) summed over ``group``: the same value on every rank (a
    0-dim int32 tensor; ``count`` itself without a group)."""
    if group is None:
        return count
    return tp.reduce_int(count.reshape(1), group).reshape(())


def _comm_key(dec_params: Dict[str, Any], cfg: WhisperConfig) -> Tuple:
    """The device comms a sharded tree's program captures (group ranks and,
    on the card, workspaces: a program holds their addresses)."""
    q = dec_params["layers"]["self_attn"]["q"]
    w = q["kernel"] if "kernel" in q else q["kernel_q"]
    return device_comm.key_of(_mesh_groups(dec_params, cfg), w.is_cuda)


def _prefill(dec_params, cfg: WhisperConfig, opts: GenerationOptions, cross,
             prompt_ids: torch.Tensor, pad_len, sot_slot: Optional[int],
             dtype: torch.dtype) -> Dict[str, Any]:
    """The loop's state after the prompt: cross K/V (projected here from
    encoder states), the cache holding the prompt, the no-speech
    probability, and the counters at the first generated position."""
    b, p = prompt_ids.shape
    total = p + opts.max_new_tokens
    device = prompt_ids.device
    prompt_ids = prompt_ids.long()
    cross = _cross(dec_params, cfg, cross)
    cache = init_cache(cfg, b, dtype=dtype, max_len=total, device=device,
                       width=kv_width(dec_params))
    prefill_logits, _ = decode(dec_params, cfg, prompt_ids, cross=cross,
                               cache=cache, pos_offset=0, pad_len=pad_len,
                               dtype=dtype)
    tokens = torch.full((b, total), cfg.pad_token_id, dtype=torch.long,
                        device=device)
    tokens[:, :p] = prompt_ids
    return dict(
        cross=cross, cache=cache, tokens=tokens,
        last_logits=prefill_logits[:, -1].float(),
        ts=L.TimestampState.init(b, device),
        finished=torch.zeros((b,), dtype=torch.bool, device=device),
        sum_logprobs=torch.zeros((b,), dtype=torch.float32, device=device),
        seq_len=torch.full((b,), p, dtype=torch.long, device=device),
        cur=torch.full((b,), p, dtype=torch.long, device=device),
        no_speech_prob=_no_speech(prefill_logits, opts, pad_len, sot_slot))


# ----------------------------------------------------------------------
# The plain version: the step loop, one read of the device a step
# ----------------------------------------------------------------------


@torch.no_grad()
def generate_eager(dec_params: Dict[str, Any], cfg: WhisperConfig,
                   cross, prompt_ids: torch.Tensor,
                   opts: GenerationOptions,
                   temperature=0.0,
                   generator: Optional[torch.Generator] = None,
                   pad_len: Optional[torch.Tensor] = None,
                   sot_slot: Optional[int] = None,
                   dtype: torch.dtype = torch.float32) -> GenerateOutput:
    """:func:`generate` as a step loop with an int cursor that stops when
    the budget is spent or every row has emitted EOS (reading the device at
    every step), skipping the decode whose logits would never be read."""
    p = prompt_ids.shape[1]
    total = _check_budget(cfg, p, opts)
    device = prompt_ids.device
    if opts.do_sample and generator is None:
        # never the global RNG; the JAX package's default key is PRNGKey(0)
        generator = torch.Generator(device=device).manual_seed(0)
    temperature = _temperature(temperature, device)
    s = _prefill(dec_params, cfg, opts, cross, prompt_ids, pad_len, sot_slot,
                 dtype)
    cross, cache, tokens = s["cross"], s["cache"], s["tokens"]
    last_logits, ts, finished = s["last_logits"], s["ts"], s["finished"]
    sum_logprobs, seq_len = s["sum_logprobs"], s["seq_len"]
    group = _stop_group(dec_params, cfg)

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
        if cur >= total or not device_comm.host_read(
                _agree((~finished).sum(), group)):
            break
        lg, cache = decode(dec_params, cfg, nxt[:, None], cross=cross,
                           cache=cache, pos_offset=cur - 1, pad_len=pad_len,
                           dtype=dtype)
        last_logits = lg[:, -1].float()

    return GenerateOutput(sequences=tokens, seq_len=seq_len,
                          sum_logprobs=sum_logprobs,
                          no_speech_prob=s["no_speech_prob"])


# ----------------------------------------------------------------------
# The blocked loop: a body over device state, run in blocks
# ----------------------------------------------------------------------


def _step(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
          s: Dict[str, Any], prompt_len: int, temperature: torch.Tensor,
          generator: Optional[torch.Generator], pad_len,
          dtype: torch.dtype) -> None:
    """One step of every row at the device cursor ``s["cur"]``, in place
    (JAX's ``body``).  Past the budget (``cur == total``) it writes and
    moves nothing but the last cache slot's K/V."""
    cur = s["cur"]
    total = s["tokens"].shape[1]
    active = cur < total
    at = cur.clamp(max=total - 1)
    gen_idx = cur - prompt_len
    scores = _process_scores(s["last_logits"], gen_idx, s["ts"], cfg, opts,
                             prompt_len)
    nxt = _select(scores, temperature, generator, opts)
    logp = torch.log_softmax(scores, dim=-1)
    tok_logp = logp.gather(1, nxt[:, None])[:, 0]

    was_finished = s["finished"]
    idle = was_finished | ~active
    nxt = torch.where(was_finished, cfg.pad_token_id, nxt)
    rows = torch.arange(nxt.shape[0], device=nxt.device)
    tokens = s["tokens"]
    tokens[rows, at] = torch.where(active, nxt, tokens[rows, at])
    s["sum_logprobs"].add_(torch.where(idle, 0.0, tok_logp))
    s["seq_len"].copy_(torch.where(idle, s["seq_len"], cur + 1))
    s["finished"].copy_(torch.where(
        active, was_finished | (nxt == cfg.eos_token_id), was_finished))
    ts = s["ts"]
    new_ts = [torch.where(active, n, o)
              for n, o in zip(ts.update(nxt, cfg.timestamp_begin), ts)]
    for o, n in zip(ts, new_ts):
        o.copy_(n)
    lg, _ = decode(dec_params, cfg, nxt[:, None], cross=s["cross"],
                   cache=s["cache"], pos_offset=at, pad_len=pad_len,
                   dtype=dtype)
    s["last_logits"].copy_(torch.where(active[:, None], lg[:, -1].float(),
                                       s["last_logits"]))
    cur.add_(active.long())


def _block(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
           s: Dict[str, Any], steps: int, prompt_len: int,
           temperature: torch.Tensor, generator: Optional[torch.Generator],
           pad_len, dtype: torch.dtype) -> torch.Tensor:
    """``steps`` steps; returns ``[every row finished, cursor]`` (int64
    [2]; under 2-D sharding every row of the data group), the one vector
    the host reads a block."""
    for _ in range(steps):
        _step(dec_params, cfg, opts, s, prompt_len, temperature, generator,
              pad_len, dtype)
    left = _agree((~s["finished"]).sum(), _stop_group(dec_params, cfg))
    return torch.stack([(left == 0).long(), s["cur"][0]])


def _read_flags(flags: torch.Tensor, total: int) -> bool:
    """The block's one host sync: True when the loop is done.  A
    collective that waits for a peer past the device comms' bound raises
    here."""
    G.bump("host_syncs")
    done, cur = device_comm.host_read(flags)
    return bool(done) or cur >= total


def _output(s: Dict[str, Any]) -> GenerateOutput:
    return GenerateOutput(sequences=s["tokens"], seq_len=s["seq_len"],
                          sum_logprobs=s["sum_logprobs"],
                          no_speech_prob=s["no_speech_prob"])


class _Program:
    """A captured generate: static inputs, the prefill and block graphs,
    the state they rewrite, and the generator the block draws from."""

    def __init__(self, dec_params, inputs, prefill, block, state, flags,
                 generator):
        self.dec_params = dec_params    # the weights the graphs read
        self.inputs = inputs
        self.prefill = prefill
        self.block = block
        self.state = state
        self.flags = flags
        self.generator = generator


def _capture(owner: G.GraphOwner, dec_params, cfg: WhisperConfig,
             opts: GenerationOptions, cross, prompt_ids, pad_len,
             sot_slot: Optional[int], dtype: torch.dtype, steps: int,
             temperature) -> _Program:
    """Warm the prefill and one step up on the owner's stream, then capture
    the prefill and a block of ``steps`` steps."""
    device = prompt_ids.device
    p = prompt_ids.shape[1]
    if isinstance(cross, torch.Tensor):
        src = torch.empty_like(cross)
    else:
        src = {k: torch.empty_like(v) for k, v in cross.items()}
    inputs = dict(cross=src, prompt=torch.empty_like(prompt_ids.long()),
                  pad_len=None if pad_len is None else torch.empty_like(
                      pad_len.long()),
                  temperature=torch.zeros((), dtype=torch.float32,
                                          device=device))
    _load(inputs, cross, prompt_ids, pad_len, temperature)
    gen = (torch.Generator(device=device).manual_seed(0) if opts.do_sample
           else None)

    def prefill():
        return _prefill(dec_params, cfg, opts, inputs["cross"],
                        inputs["prompt"], inputs["pad_len"], sot_slot, dtype)

    def block(state, n):
        return _block(dec_params, cfg, opts, state, n, p,
                      inputs["temperature"], gen, inputs["pad_len"], dtype)

    with owner.side(device):
        block(prefill(), 1)
    prefill_graph, state = owner.capture(prefill, device)
    block_graph, flags = owner.capture(lambda: block(state, steps), device,
                                       generators=[] if gen is None else [gen])
    return _Program(dec_params, inputs, prefill_graph, block_graph, state,
                    flags, gen)


def _load(inputs, cross, prompt_ids, pad_len, temperature) -> None:
    """Copy one call's inputs into a program's static inputs."""
    if isinstance(cross, torch.Tensor):
        inputs["cross"].copy_(cross)
    else:
        for k, v in cross.items():
            inputs["cross"][k].copy_(v)
    inputs["prompt"].copy_(prompt_ids)
    if pad_len is not None:
        inputs["pad_len"].copy_(pad_len)
    if isinstance(temperature, torch.Tensor):
        inputs["temperature"].copy_(temperature)
    else:
        inputs["temperature"].fill_(float(temperature))


def _cross_layout(cross) -> Tuple:
    """The cross-attention input's layout: encoder states or K/V, with
    shapes and dtypes."""
    if isinstance(cross, torch.Tensor):
        return ("states", tuple(cross.shape), cross.dtype)
    return ("kv",) + tuple((k, tuple(v.shape), v.dtype)
                           for k, v in sorted(cross.items()))


def _program_key(dec_params, cfg: WhisperConfig, opts: GenerationOptions,
                 cross, prompt_ids, pad_len, sot_slot, dtype, steps):
    """JAX's jit key: batch and prompt length, the frozen options (the
    budget, greedy or sampling), the config (the int8 flags), dtype,
    device, the cross-attention input's layout, the block length, the
    weights' addresses and, for a sharded tree, its device comms."""
    return (tuple(prompt_ids.shape), opts, cfg, dtype, prompt_ids.device,
            _cross_layout(cross), pad_len is not None, sot_slot, steps,
            G.params_key(dec_params), _comm_key(dec_params, cfg))


@torch.no_grad()
def generate(dec_params: Dict[str, Any], cfg: WhisperConfig,
             cross, prompt_ids: torch.Tensor,
             opts: GenerationOptions,
             temperature=0.0,
             generator: Optional[torch.Generator] = None,
             pad_len: Optional[torch.Tensor] = None,
             sot_slot: Optional[int] = None,
             dtype: torch.dtype = torch.float32,
             graphs: Optional[G.GraphOwner] = None) -> GenerateOutput:
    """Extend ``prompt_ids`` [B, P] by up to max_new_tokens, greedily or,
    with ``opts.do_sample``, by sampling at ``temperature`` (a number or a
    0-dim tensor) with draws from ``generator`` (a generator on the
    prompt's device; seeded with 0 when not given).

    ``cross`` is the encoder states [B, T, d] (the cross-attention K/V are
    then projected inside the prefill: on the card inside its graph, never
    copied) or precomputed K/V (:func:`...models.cross_kv`, copied once a
    call into the graph's buffers on the card).  The prompt must already
    contain decoder_start/lang/task tokens; ``opts.forced_decoder_ids`` is
    also honoured.

    ``pad_len`` [B] marks left-padded prompt slots (condition-on-prev
    prompts of different lengths in one batch, cf. ``models.whisper.decode``).
    The <|nospeech|> probability is read at the <|startoftranscript|> slot:
    ``sot_slot`` when given, else ``pad_len[b]``, else 0.

    The loop runs in blocks of :data:`BLOCK_STEPS` steps (fewer for a
    smaller budget) with one read of the device a block.  On a CUDA tensor
    the prefill and the block replay as CUDA graphs, captured at the first
    call of each shape and setting into ``graphs`` (an owner's pool, stream
    and cache).  Without ``graphs`` the call captures into an owner of its
    own, freed when it returns: a caller that decodes more than once keeps
    an owner.  A failed capture raises.  A tree sharded over a mesh
    decodes alike, its collectives inside the graphs (every rank of its
    groups calls ``generate`` alike: the warm-up runs them).
    """
    p = prompt_ids.shape[1]
    total = _check_budget(cfg, p, opts)
    device = prompt_ids.device
    steps = max(1, min(BLOCK_STEPS, opts.max_new_tokens))
    if opts.do_sample and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if device.type != "cuda":
        temp = _temperature(temperature, device)
        s = _prefill(dec_params, cfg, opts, cross, prompt_ids, pad_len,
                     sot_slot, dtype)
        while not _read_flags(_block(dec_params, cfg, opts, s, steps, p,
                                     temp, generator, pad_len, dtype), total):
            pass
        return _output(s)

    owner = graphs if graphs is not None else G.GraphOwner("generate")
    key = _program_key(dec_params, cfg, opts, cross, prompt_ids, pad_len,
                       sot_slot, dtype, steps)
    with owner.lock:
        prog = owner.entry(key, lambda: _capture(
            owner, dec_params, cfg, opts, cross, prompt_ids, pad_len,
            sot_slot, dtype, steps, temperature))
        _load(prog.inputs, cross, prompt_ids, pad_len, temperature)
        if prog.generator is not None:
            prog.generator.set_state(generator.get_state())
        with owner.side(device):
            prog.prefill.replay()
            while True:
                prog.block.replay()
                if _read_flags(prog.flags, total):
                    break
        if prog.generator is not None:
            generator.set_state(prog.generator.get_state())
        # the state is rewritten by the next call: hand out copies
        return GenerateOutput(*(t.clone() for t in _output(prog.state)))


def build_generate(cfg: WhisperConfig, opts: GenerationOptions,
                   dtype: torch.dtype = torch.float32, device="cuda"):
    """The counterpart of JAX's ``build_generate``: a callable ``(params,
    mel, prompt_ids, temperature=0.0, generator=None, pad_len=None,
    sot_slot=None) -> GenerateOutput`` with a graph owner of its own.  The
    encoder runs eagerly (its kernels launch as usual); cross K/V, prefill,
    the no-speech probability and the step blocks replay as CUDA graphs on
    the card."""
    dev = resolve_device(device)
    owner = G.GraphOwner(f"build_generate:{dev}")

    def fn(params, mel, prompt_ids, temperature=0.0, generator=None,
           pad_len=None, sot_slot=None) -> GenerateOutput:
        return encode_and_generate(params, cfg, mel, prompt_ids, opts,
                                   temperature=temperature,
                                   generator=generator, pad_len=pad_len,
                                   sot_slot=sot_slot, dtype=dtype,
                                   device=dev, graphs=owner)

    return fn


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
                        temperature=0.0,
                        generator: Optional[torch.Generator] = None,
                        pad_len=None, sot_slot: Optional[int] = None,
                        dtype: torch.dtype = torch.float32,
                        device="cuda",
                        graphs: Optional[G.GraphOwner] = None
                        ) -> GenerateOutput:
    """mel [B, n_mels, 3000] + prompt [B, P] -> GenerateOutput, on ``device``
    (where ``params`` must already live): the encoder, then :func:`generate`
    on its states."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    mel = torch.as_tensor(mel).to(dev)
    prompt_ids = torch.as_tensor(prompt_ids).to(dev)
    if pad_len is not None:
        pad_len = torch.as_tensor(pad_len).to(dev)
    enc = encode(params["encoder"], cfg, mel, dtype=dtype)
    return generate(params["decoder"], cfg, enc, prompt_ids, opts,
                    temperature=temperature, generator=generator,
                    pad_len=pad_len, sot_slot=sot_slot, dtype=dtype,
                    graphs=graphs)
