"""Continuous-batching decode engine (in-flight batching for serving).

Counterpart of ``distil_whisper_tpu.serving_engine``.
:class:`.serving.BatchingTranscriber` runs every lane of a batch until the
last one finishes; this module keeps a fixed set of ``lanes`` decoding
continuously and swaps finished requests out and queued requests in
between step blocks:

* every lane carries its own cursor: ``models.whisper.decode(pos_offset=
  [B])`` writes K/V, reads position embeddings and masks attention per
  lane, and the logits rules take a per-lane ``gen_idx``, so lanes at
  different depths share one single-token step;
* admission encodes and prefills only the admitted rows and writes them
  into the lane rows of every state tensor (self and cross K/V, their int8
  scales, the timestamp FSM, the counters);
* the state lives on the pipeline's device in fixed buffers, updated in
  place (admission writes into the same storage); a block is
  ``block_steps`` steps with no host sync, and the host reads one packed
  vector ``[finished | pos | (drafted | accepted |) tokens]`` a block
  (:meth:`ContinuousBatchingEngine.unpack`);
* on the card the greedy and the sampling block (a speculative engine:
  the block at each draft length) are each one CUDA graph, captured by
  :meth:`ContinuousBatchingEngine.init_state` (before the transcriber's
  threads start) on the engine's own pool and stream
  (``generation/graphs.py``), the counterpart of JAX's jitted blocks; under
  a mesh too, the collectives inside on the groups' device comms
  (``parallel/device_comm.py``), every rank capturing and replaying the
  same blocks in the same order.

Per-lane options: language and task (prompt content), timestamps (a
per-lane gate on the FSM), the token budget, and sampling — per-lane
temperature, top-k (one ``torch.topk`` of ``k_max`` = 64, each lane masking
below its own k-th value) and seed.  A sampled lane draws by Gumbel-max
from uniforms hashed from (seed, the lane's ``gen_idx``, vocabulary index)
in 32-bit integer arithmetic: a lane's draws depend neither on its
neighbours nor on when it was admitted, and are the same on the CPU and
the card.  The sampling block runs only while a sampled lane is resident.
Long files are cut into the pipeline's strided windows, which ride lanes
like short requests and are merged at completion.  Word timestamps, beams,
sequential long-form, and sampling under a speculative engine go to a
fallback thread that runs the pipeline.

With an ``assistant`` draft (or ``ngram_speculative``) the lanes decode
speculatively: each round drafts ``gamma`` tokens per lane at the per-lane
cursors and verifies them in one (gamma + 1)-wide teacher decode, with the
timestamp FSM run per verify column; tokens equal the greedy engine's.

Under a mesh (a pipeline built with ``mesh=``, tensor parallel over its
'model' axis) one engine spans the job, as JAX's does: the lanes are split
over the 'data' axis (lane ``j`` lives on data rank ``j // (lanes / dp)``;
``lanes`` must divide by dp), the ranks of a model group hold the same
lanes and run the sharded products, admission scatters each row to its
owner's lanes, and each block's packed vector is gathered over the ranks
so that the leader reads every lane.  Global rank 0 leads: the
transcriber's device calls (admissions, blocks, language detection, the
fallback thread's pipeline calls) go through one command stream
(``parallel/lockstep.py``) that the other ranks replay in
:meth:`ContinuousTranscriber.follow`, so the step loop and the fallback
thread never issue collectives in different orders on different ranks; a
failed call ends the worker and later submissions are refused.

What the JAX engine carries for XLA and the TPU is not ported: donated
state buffers (the captured blocks rewrite fixed ones), power-of-two
admission buckets (here every free lane is filled at once; the two graphs
span every lane) and the two-deep dispatch that hid the fetch round trip
of a remote TPU.  Three threads issue device work (the step loop, the
featurizer, the fallback): eager work on the default stream, where a
tensor passes between threads only after the call that made it has
returned; the engine's blocks and the pipeline's generate graphs replay on
their owners' streams, ordered after the caller's stream and before its
next work.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio import compute_mel
from .audio.io import load_audio
from .device import resolve_device
from .generation import GenerationOptions, generate
from .generation import logits as L
from .generation.graphs import GraphOwner
from .generation.speculative import (_bias_to, _oracle, _process,
                                     _propose_ngram, _teacher_choices,
                                     _ts_advance, _verify_accept,
                                     prepare_assistant)
from .models.whisper import cross_kv, decode, encode, init_cache, kv_width
from .parallel.lockstep import Lockstep
from .parallel import device_comm
from .parallel.mesh import coordinates
from .parallel.multihost import world_size
from .serving import (ServerOverloadedError, _budget, _coerce_beams,
                      _coerce_mode, _coerce_sampling, _coerce_timestamps,
                      _gamma_step, _SeedCounter, _SequentialRunner,
                      _short_result, _StatsMixin, check_prompt,
                      estimate_accept)

logger = logging.getLogger("distil_whisper_tpu_torch")

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` of int64 ``x`` in [0, 2**32), in int64 without
    overflow (the constant is split in 16-bit halves)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xorshift-multiply, Wellons' lowbias32)
    on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sample_uniforms(seed_lo: torch.Tensor, seed_hi: torch.Tensor,
                    gen_idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] fp32 uniforms in (0, 1), a hash of (the lane's seed, its
    ``gen_idx``, the vocabulary index): 24 bits of a 32-bit hash, centred
    in their cell.  ``seed_lo``/``seed_hi`` are the 32-bit halves of each
    lane's seed (int64 [B])."""
    k1 = _mix32(seed_lo ^ _mix32(seed_hi ^ _mul32(gen_idx & _M32,
                                                  0x9E3779B9)))
    k2 = _mix32(k1 ^ 0x2545F491)
    v = _mul32(torch.arange(vocab, device=gen_idx.device), 0x85EBCA6B)
    h = _mix32(_mix32(k1[:, None] ^ v[None, :]) ^ k2[:, None])
    return ((h >> 8).float() + 0.5) * (1.0 / 2 ** 24)


def sample_lanes(scores: torch.Tensor, temp: torch.Tensor,
                 topk: torch.Tensor, seed_lo: torch.Tensor,
                 seed_hi: torch.Tensor, gen_idx: torch.Tensor,
                 k_max: int) -> torch.Tensor:
    """Per-lane temperature sampling with per-lane top-k over processed
    ``scores`` [B, V]: one ``torch.topk(k_max)``, each lane masking below
    its own k-th value (``topk == 0``: the full vocabulary), then
    Gumbel-max over :func:`sample_uniforms` — a draw from the categorical
    law of the masked, tempered scores."""
    sc = scores / temp.clamp(min=1e-6)[:, None]
    vals = torch.topk(sc, min(k_max, sc.shape[-1]), dim=-1).values
    kth = vals.gather(1, (topk - 1).clamp(0, vals.shape[-1] - 1)[:, None])
    sc = sc.masked_fill((topk > 0)[:, None] & (sc < kth), L.NEG_INF)
    u = sample_uniforms(seed_lo, seed_hi, gen_idx, sc.shape[-1])
    return torch.argmax(sc - torch.log(-torch.log(u)), dim=-1)


def synthetic_agree(tok_pos: torch.Tensor, lane: torch.Tensor,
                    prob) -> torch.Tensor:
    """The engine's ``synthetic_acceptance`` coins, JAX's hash exactly: a
    uint32 ``pos * 2654435761 + lane * 97423``, its top 24 bits over 2**24
    as fp32, below ``prob`` (a number, or an fp32 0-dim tensor on the
    coins' device, which a captured block reads without a copy from the
    host).  Lanes accept and reject independently."""
    h = (_mul32(tok_pos & _M32, 2654435761) + _mul32(lane, 97423)) & _M32
    u = (h >> 8).float() / 2 ** 24
    if not isinstance(prob, torch.Tensor):
        prob = torch.tensor(prob, dtype=torch.float32, device=u.device)
    return u < prob


def periodic_oracle(tok_pos: torch.Tensor, lane: torch.Tensor,
                    period: int) -> torch.Tensor:
    """``synthetic_period``'s teacher stream: a period-R token per position,
    phase-shifted per lane so that lanes do not finish in lockstep (JAX's
    hash)."""
    return (((tok_pos + 31 * lane) % period) * 131 % 389) % 400 + 10


def _zero_cross(cfg, batch: int, dtype, device, width: int):
    """Zero-filled cross K/V of :func:`models.whisper.cross_kv`'s structure
    for ``batch`` lanes (``width``: this rank's heads times head dim)."""
    shape = (cfg.decoder_layers, batch, cfg.max_source_positions, width)
    if cfg.quantize_cross_kv:
        scale = shape[:2] + (1, shape[3])
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(scale, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _scatter_lanes(full: Dict[str, torch.Tensor],
                   new: Dict[str, torch.Tensor], lanes: torch.Tensor) -> None:
    """Write each [L, A, ...] leaf of ``new`` into lane rows ``lanes`` of
    the [L, lanes, ...] leaf of ``full``, in place."""
    for k, buf in full.items():
        buf[:, lanes] = new[k].to(buf.dtype)


class ContinuousBatchingEngine:
    """Device state and the step and admit functions.

    One instance owns ``lanes`` decode slots over one
    :class:`.pipeline.WhisperPipeline`'s params and config; under a mesh
    this rank holds ``local`` of them, global lanes ``lane0 ..
    lane0 + local - 1``, and :meth:`admit` and :meth:`step` take and
    return global lanes (every rank calls them alike).  Thread safety is
    the caller's: the :class:`ContinuousTranscriber` worker is the only
    thread that calls :meth:`admit` and :meth:`step`.
    """

    #: the top-k width of sampled lanes (one ``torch.topk``; requests asking
    #: for a larger k are rejected at submission)
    k_max = 64

    def __init__(self, pipe, lanes: int = 8, block_steps: int = 16,
                 max_new_tokens: Optional[int] = None,
                 assistant=None, gamma: int = 5,
                 synthetic_acceptance: Optional[float] = None,
                 ngram_speculative: bool = False, max_ngram: int = 3,
                 synthetic_period: Optional[int] = None):
        self.pipe = pipe
        self.cfg = pipe.cfg
        self.tok = pipe.tokenizer
        self.dtype = pipe.dtype
        self.device = resolve_device(pipe.device)   # a missing card fails here
        mesh = getattr(pipe, "mesh", None)
        d, n_data, _, _ = coordinates(mesh)
        if lanes % n_data:
            raise ValueError(f"{lanes} lanes do not divide over a data axis "
                             f"of {n_data}")
        self.lanes = lanes
        self.local = lanes // n_data
        self.lane0 = d * self.local
        # the block's packed vector is gathered over the job's ranks
        self._gather = mesh is not None and world_size() > 1
        self.block_steps = block_steps
        self.max_new = int(max_new_tokens or pipe.max_new_tokens)
        # speculative lanes: ``assistant`` = (draft_params, draft_cfg), or
        # draft-free n-gram lookup.  ``synthetic_acceptance`` (benchmark
        # only): both models run their full compute but the choices follow
        # a position-keyed oracle, so the per-draft accept rate is pinned;
        # ``synthetic_period`` (benchmark only) biases the teacher to a
        # period-R stream so that n-gram lookups succeed.
        self.ngram = bool(ngram_speculative)
        if self.ngram and assistant is not None:
            raise ValueError(
                "pick ONE speculation method: assistant draft or ngram lookup")
        self.assistant = prepare_assistant(assistant, self.dtype, self.device,
                                           mesh)
        self.gamma = int(gamma)
        self.max_ngram = int(max_ngram)
        self.synthetic_period = synthetic_period
        self.spec = self.assistant is not None or self.ngram
        if synthetic_acceptance is not None and self.ngram:
            # on a plain greedy engine the knob is a harmless no-op
            raise ValueError(
                "synthetic_acceptance pins a DRAFT's agreement; for ngram "
                "use synthetic_period (repeating-text oracle)")
        self.synthetic_acceptance = synthetic_acceptance
        # its fp32 threshold, made once on the card (a fill, no copy)
        self._agree_below = (
            None if synthetic_acceptance is None
            else torch.full((), float(synthetic_acceptance),
                            dtype=torch.float32, device=self.device))
        # longest possible prompt: [sot, lang?, task?, notimestamps]
        langs = sorted(self.tok.lang_to_id) or [None]
        self.p_max = len(self.tok.prompt_ids(
            language=langs[0], task="transcribe", no_timestamps=True))
        self.t_store = self.p_max + self.max_new
        if self.t_store > self.cfg.max_target_positions:
            raise ValueError(f"p_max({self.p_max}) + max_new({self.max_new}) "
                             f"exceeds {self.cfg.max_target_positions}")
        if (self.assistant is not None and self.t_store
                > self.assistant[1].max_target_positions):
            raise ValueError("draft max_target_positions too small for the "
                             "serve budget")
        # adaptive-gamma headroom: buffers are sized once for the largest
        # rung the transcriber's controller may pick, among its levels
        # {gamma/2, gamma, 2 gamma}
        self.gamma_max = 2 * self.gamma if self.spec else 0
        self.gamma_levels = (
            tuple(sorted({max(1, self.gamma // 2), self.gamma,
                          self.gamma_max})) if self.spec else ())
        # scratch slack: a frozen lane keeps writing (token, K/V) at its
        # frozen cursor, which may equal t_store; a speculative round writes
        # a gamma + 1 wide window at the cursor
        self.t_buf = self.t_store + (self.gamma_max + 1 if self.spec else 1)
        self.opts = GenerationOptions.from_config(
            self.cfg, max_new_tokens=self.max_new, return_timestamps=True,
            no_speech_token_id=self.tok.no_speech)
        self._state: Optional[Dict[str, Any]] = None
        # the greedy and sampling blocks, or the speculative blocks at each
        # draft length, run as CUDA graphs on the card, meshed or not
        self.graphed = self.device.type == "cuda"
        self.graphs = GraphOwner("engine")
        self._blocks: Dict[Any, Any] = {}

    # ------------------------------------------------------------- state
    def init_state(self) -> Dict[str, Any]:
        """Allocate the lanes' state (every lane finished) and, on the card,
        capture the greedy and the sampling block over it, or the
        speculative block at each of :attr:`gamma_levels`."""
        b, cfg, dev = self.local, self.cfg, self.device
        width = kv_width(self.pipe.params["decoder"])

        def full(value, dtype):
            return torch.full((b,), value, dtype=dtype, device=dev)

        self._state = dict(
            cache=init_cache(cfg, b, dtype=self.dtype, max_len=self.t_buf,
                             device=dev, width=width),
            cross=_zero_cross(cfg, b, self.dtype, dev, width),
            tokens=torch.full((b, self.t_buf), cfg.pad_token_id,
                              dtype=torch.long, device=dev),
            last_logits=torch.zeros((b, cfg.vocab_size), device=dev),
            ts=L.TimestampState.init(b, dev),
            use_ts=full(False, torch.bool),
            prompt_len=full(1, torch.long),
            budget=full(0, torch.long),
            pos=full(1, torch.long),
            finished=full(True, torch.bool),
            sum_logprobs=full(0.0, torch.float32),
            no_speech_prob=full(0.0, torch.float32),
        )
        if self.spec:
            self._state.update(drafted=full(0, torch.long),
                               accepted=full(0, torch.long))
            if self.assistant is not None:
                d_params, d_cfg = self.assistant
                d_width = kv_width(d_params["decoder"])
                self._state.update(
                    d_cache=init_cache(d_cfg, b, dtype=self.dtype,
                                       max_len=self.t_buf, device=dev,
                                       width=d_width),
                    d_cross=_zero_cross(d_cfg, b, self.dtype, dev, d_width))
        else:
            # per-lane sampling state (sampled requests under a speculative
            # engine ride the fallback thread)
            self._state.update(temp=full(0.0, torch.float32),
                               topk=full(0, torch.long),
                               seed_lo=full(0, torch.long),
                               seed_hi=full(0, torch.long))
        if self.graphed:
            self._capture_blocks()
        return self._state

    def _block(self, variant) -> torch.Tensor:
        """One block, in place; returns the packed vector.  ``variant`` is
        the sampling flag of ``block_steps`` greedy steps or, on a
        speculative engine, the draft length of
        ``max(1, block_steps // (variant + 1))`` rounds."""
        s = self._state
        if self.spec:
            for _ in range(max(1, self.block_steps // (variant + 1))):
                self._spec_round(s, variant)
            head = [s["finished"].long(), s["pos"], s["drafted"],
                    s["accepted"]]
        else:
            for _ in range(self.block_steps):
                self._greedy_step(s, variant)
            head = [s["finished"].long(), s["pos"]]
        return torch.cat(head + [s["tokens"].reshape(-1)])

    def _capture_blocks(self) -> None:
        """Capture the greedy and the sampling block (a speculative
        engine: the block at each of :attr:`gamma_levels`) over the state's
        buffers, after a warm-up of each on the owner's stream.  Every lane
        is finished here, so the warm-up changes no lane's content (frozen
        lanes write pads and K/V at their frozen slots, which admission
        overwrites)."""
        variants = self.gamma_levels if self.spec else (False, True)
        with self.graphs.side(self.device):
            for v in variants:
                self._block(v)
        self._blocks = {v: self.graphs.capture(
            lambda v=v: self._block(v), self.device) for v in variants}

    # ------------------------------------------------------------- step
    def _greedy_step(self, s: Dict[str, Any], sampling: bool) -> None:
        """One token for every lane at its own cursor, in place: every
        state tensor keeps its storage (a captured block reads and writes
        the same buffers at each replay)."""
        cfg, opts = self.cfg, self.opts
        gen_idx = s["pos"] - s["prompt_len"]
        scores = _process(s["last_logits"], gen_idx, cfg, opts,
                          s["prompt_len"], ts_state=s["ts"],
                          use_ts=s["use_ts"])
        nxt = torch.argmax(scores, dim=-1)
        if sampling:
            drawn = sample_lanes(scores, s["temp"], s["topk"], s["seed_lo"],
                                 s["seed_hi"], gen_idx, self.k_max)
            nxt = torch.where(s["temp"] > 0, drawn, nxt)
        tok_logp = torch.log_softmax(scores, dim=-1).gather(
            1, nxt[:, None])[:, 0]

        frozen = s["finished"].clone()
        nxt = torch.where(frozen, cfg.pad_token_id, nxt)
        s["sum_logprobs"].add_(torch.where(frozen, 0.0, tok_logp))
        s["finished"].copy_(frozen | (nxt == cfg.eos_token_id)
                            | (gen_idx + 1 >= s["budget"]))
        # a frozen lane writes (a pad, its K/V) at its frozen cursor: a slot
        # past its content that nothing reads
        rows = torch.arange(self.local, device=self.device)
        pos = s["pos"].clone()
        s["tokens"][rows, pos] = nxt
        new_ts = [torch.where(frozen, o, n) for n, o in
                  zip(s["ts"].update(nxt, cfg.timestamp_begin), s["ts"])]
        for o, n in zip(s["ts"], new_ts):
            o.copy_(n)
        s["pos"].add_(torch.where(frozen, 0, 1))
        lg, _ = decode(self.pipe.params["decoder"], cfg, nxt[:, None],
                       cross=s["cross"], cache=s["cache"], pos_offset=pos,
                       dtype=self.dtype)
        s["last_logits"].copy_(torch.where(frozen[:, None], s["last_logits"],
                                           lg[:, -1].float()))

    def _draft(self, s: Dict[str, Any], gamma: int) -> torch.Tensor:
        """The draft's ``gamma`` proposals per lane, at the lane cursors,
        under the processor stack and each lane's timestamp FSM.  Its first
        step feeds the two tokens before the window (slots ``pos - 2`` and
        ``pos - 1``), so that every slot of the draft's cache holds an
        accepted token's K/V (the JAX engine's draft never writes its last
        proposal's slot after a fully accepted round)."""
        d_params, d_cfg = self.assistant
        cfg, b, dev = self.cfg, self.local, self.device
        pos, plen = s["pos"], s["prompt_len"]
        rows = torch.arange(b, device=dev)
        start = (pos - 2).clamp(min=0)
        fed = s["tokens"].gather(1, start[:, None]
                                 + torch.arange(2, device=dev))
        lg, _ = decode(d_params["decoder"], d_cfg, fed, cross=s["d_cross"],
                       cache=s["d_cache"], pos_offset=start,
                       dtype=self.dtype)
        logits = lg[rows, pos - 1 - start]
        dts, out = s["ts"], []
        for i in range(gamma):
            tok_pos = pos + i               # the position this proposal takes
            if i:
                lg, _ = decode(d_params["decoder"], d_cfg, out[-1][:, None],
                               cross=s["d_cross"], cache=s["d_cache"],
                               pos_offset=tok_pos - 1, dtype=self.dtype)
                logits = lg[:, -1]
            scores = _process(logits.float(), tok_pos - plen, cfg, self.opts,
                              plen, ts_state=dts, use_ts=s["use_ts"])
            if self.synthetic_acceptance is not None:
                agree = synthetic_agree(tok_pos, rows + self.lane0,
                                        self._agree_below)
                oracle = _oracle(tok_pos)
                scores = _bias_to(scores, torch.where(agree, oracle,
                                                      oracle + 1))
            out.append(torch.argmax(scores, dim=-1))
            dts = dts.update(out[-1], cfg.timestamp_begin)
        return torch.stack(out, dim=1)

    def _spec_round(self, s: Dict[str, Any], gamma: int) -> None:
        """One accept/verify round for every lane at its own cursor, in
        place: ``gamma`` proposals (draft or n-gram lookup), one
        (gamma + 1)-wide teacher decode, and the emitted window — the
        accepted prefix and the teacher's token after it, cut by EOS and
        the lane's budget.  Built from :mod:`.generation.speculative`'s
        primitives; frozen lanes emit nothing.  Every state tensor keeps its
        storage (a captured block reads and writes the same buffers at each
        replay)."""
        cfg, b, dev = self.cfg, self.local, self.device
        pad, eos = cfg.pad_token_id, cfg.eos_token_id
        frozen, pos = s["finished"].clone(), s["pos"].clone()
        plen = s["prompt_len"]
        last_tok = s["tokens"].gather(1, (pos - 1)[:, None])[:, 0]
        if self.ngram:
            drafts, found = _propose_ngram(s["tokens"], pos, gamma,
                                           self.max_ngram, pad)
        else:
            drafts, found = self._draft(s, gamma), None
        t_logits, _ = decode(self.pipe.params["decoder"], cfg,
                             torch.cat([last_tok[:, None], drafts], dim=1),
                             cross=s["cross"], cache=s["cache"],
                             pos_offset=pos - 1, dtype=self.dtype)
        bias_fn = None
        if self.synthetic_acceptance is not None:
            def bias_fn(scores, p):
                return _bias_to(scores, _oracle(p))
        elif self.synthetic_period is not None:
            lane = (torch.arange(b, device=dev) + self.lane0)[:, None] \
                .expand(b, gamma + 1).reshape(-1)

            def bias_fn(scores, p):
                return _bias_to(scores, periodic_oracle(
                    p, lane, self.synthetic_period))
        t_choice, t_logp = _teacher_choices(
            t_logits, pos, plen, gamma, cfg, self.opts, bias_fn,
            ts_state=s["ts"], drafts=drafts, use_ts=s["use_ts"])
        del t_logits
        window, n_eff, done = _verify_accept(t_choice, drafts, pos,
                                             plen + s["budget"], eos, gamma)
        gen_idx = pos - plen
        emit = torch.minimum(n_eff + 1, (s["budget"] - gen_idx).clamp(min=1))
        emit = torch.where(frozen, 0, emit)
        idx = torch.arange(gamma + 1, device=dev)[None, :]
        emitted = idx < emit[:, None]
        rows = torch.arange(b, device=dev)[:, None]
        # a frozen lane writes pads over its scratch window
        s["tokens"][rows, pos[:, None] + idx] = torch.where(emitted, window,
                                                            pad)
        s["sum_logprobs"].add_(torch.where(emitted, t_logp, 0.0).sum(dim=1))
        new_ts = [torch.where(emit > 0, n, o) for n, o in zip(
            _ts_advance(s["ts"], window, (emit - 1).clamp(min=0),
                        cfg.timestamp_begin), s["ts"])]
        for o, n in zip(s["ts"], new_ts):
            o.copy_(n)
        s["finished"].copy_(frozen | done)
        # drafted and accepted move together: a round whose lookup found no
        # match credits neither
        dead = frozen if found is None else frozen | ~found
        s["drafted"].add_(torch.where(dead, 0, gamma))
        s["accepted"].add_(torch.where(dead, 0, (emit - 1).clamp(min=0)))
        s["pos"].add_(emit)

    @torch.no_grad()
    def step(self, sampling: bool = False,
             gamma: Optional[int] = None) -> torch.Tensor:
        """Run one block: ``block_steps`` greedy steps (the sampling
        variant while a sampled lane is resident), or on a speculative
        engine ``max(1, block_steps // (gamma + 1))`` rounds at draft
        length ``gamma`` (at most ``gamma_max``).  Returns the packed
        device vector ``[finished | pos | (drafted | accepted |) tokens]``
        (read it with :meth:`unpack`); nothing in a block waits for the
        device.  Under a mesh every rank steps its own lanes and the
        vector holds every lane, gathered over the ranks."""
        if self._state is None:
            raise RuntimeError("call init_state() first")
        variant = bool(sampling)
        if self.spec:
            variant = int(gamma or self.gamma)
            if not 1 <= variant <= self.gamma_max:
                raise ValueError(f"gamma {variant} outside "
                                 f"1..{self.gamma_max}")
        if self.graphed:
            if variant not in self._blocks:
                # a draft length outside gamma_levels: captured at its first
                # block (the levels' warm-ups built what a capture needs)
                self._blocks[variant] = self.graphs.capture(
                    lambda: self._block(variant), self.device)
            graph, packed = self._blocks[variant]
            # replayed on the caller's stream, which the state's writes
            # (admission) are ordered on: under a mesh on one card, a
            # replay on the owner's stream with the caller's stream queued
            # behind it kept the time-sliced card from switching ranks at
            # the collectives' stream waits (215.6 ms a block against
            # 63.1, H100 80GB HBM3, 700 W; scripts/torch_mesh_collective.py)
            with torch.cuda.device(self.device):
                graph.replay()
            # the next replay rewrites the graph's vector
            packed = packed.clone()
        else:
            packed = self._block(variant)
        return (self._gather_lanes(packed, 4 if self.spec else 2)
                if self._gather else packed)

    def _gather_lanes(self, packed: torch.Tensor, heads: int) -> torch.Tensor:
        """Every data rank's packed vector (from the first rank of each
        model group), laid out as one engine's over all the lanes."""
        import torch.distributed as dist
        n = world_size()
        parts = [torch.empty_like(packed) for _ in range(n)]
        dist.all_gather(parts, packed.contiguous())
        tp = coordinates(self.pipe.mesh)[3]
        rows = torch.stack(parts[::tp])                  # [dp, local packed]
        k = heads * self.local
        head = rows[:, :k].reshape(-1, heads, self.local).transpose(0, 1)
        return torch.cat([head.reshape(-1), rows[:, k:].reshape(-1)])

    def unpack(self, packed: torch.Tensor):
        """packed device vector -> (finished [B] bool, pos [B], tokens
        [B, t_buf], counters) as numpy; this copy is the block's one host
        sync.  ``counters`` is None in greedy mode, else ``(drafted [B],
        accepted [B])``, cumulative since each lane's admission."""
        b = self.lanes
        if packed.is_cuda:          # a collective stuck past its bound raises
            device_comm.wait_device(packed.device)
        flat = packed.cpu().numpy()
        if self.spec:
            return (flat[:b].astype(bool), flat[b:2 * b],
                    flat[4 * b:].reshape(b, self.t_buf),
                    (flat[2 * b:3 * b], flat[3 * b:4 * b]))
        return (flat[:b].astype(bool), flat[b:2 * b],
                flat[2 * b:].reshape(b, self.t_buf), None)

    # ------------------------------------------------------------- admit
    @torch.no_grad()
    def admit(self, mels, prompts: List[List[int]],
              budgets: List[int], use_ts: List[bool],
              lanes: List[int], temps: Optional[List[float]] = None,
              top_ks: Optional[List[int]] = None,
              seeds: Optional[List[int]] = None) -> None:
        """Admit ``len(lanes)`` requests (30 s mel windows [A, n_mels,
        3000] + prompts) into the given free lanes: encode and prefill the
        admitted rows, then write them into the lane rows of the state.  In
        speculative mode the draft is admitted alongside, on the teacher's
        encoder states when the widths match.  ``temps``/``top_ks``/
        ``seeds`` set per-lane sampling (greedy engine only; temperature 0
        = greedy, the default).  Under a mesh each rank admits the rows
        whose lanes it holds."""
        if not (len(lanes) == len(prompts) == len(budgets) == len(use_ts)
                == len(mels)):
            raise ValueError("admit: one mel, prompt, budget, timestamp flag "
                             "and lane per request")
        if self.spec and temps and any(t > 0 for t in temps):
            raise ValueError("sampled lanes are fallback-routed under a "
                             "speculative engine")
        mine = [i for i, lane in enumerate(lanes)
                if self.lane0 <= lane < self.lane0 + self.local]
        if not mine:
            return
        if len(mine) < len(lanes):
            def pick(xs):
                return None if xs is None else [xs[i] for i in mine]
            mels = mels[mine]
            prompts, budgets, use_ts = (pick(prompts), pick(budgets),
                                        pick(use_ts))
            lanes, temps, top_ks, seeds = (pick(lanes), pick(temps),
                                           pick(top_ks), pick(seeds))
        lanes = [lane - self.lane0 for lane in lanes]
        a = len(lanes)
        cfg, dev, dtype, s = self.cfg, self.device, self.dtype, self._state
        params = self.pipe.params
        prom = np.full((a, self.p_max), cfg.pad_token_id, np.int64)
        for i, p in enumerate(prompts):
            prom[i, :len(p)] = p
        prom_t = torch.as_tensor(prom, device=dev)
        plens = torch.as_tensor([len(p) for p in prompts], dtype=torch.long,
                                device=dev)
        lanes_t = torch.as_tensor(lanes, dtype=torch.long, device=dev)
        mels = mels.to(dev, dtype)

        enc = encode(params["encoder"], cfg, mels, dtype=dtype)
        cross_new = cross_kv(params["decoder"], cfg, enc)
        cache_new = init_cache(cfg, a, dtype=dtype, max_len=self.t_buf,
                               device=dev, width=kv_width(params["decoder"]))
        lg, _ = decode(params["decoder"], cfg, prom_t, cross=cross_new,
                       cache=cache_new, pos_offset=0, dtype=dtype)
        last = lg[torch.arange(a, device=dev), plens - 1].float()
        ns_id = self.opts.no_speech_token_id
        no_speech = (torch.softmax(lg[:, 0].float(), dim=-1)[:, ns_id]
                     if ns_id is not None
                     else torch.zeros((a,), device=dev))
        _scatter_lanes(s["cache"], cache_new, lanes_t)
        _scatter_lanes(s["cross"], cross_new, lanes_t)
        s["tokens"][lanes_t] = cfg.pad_token_id
        s["tokens"][lanes_t, :self.p_max] = prom_t
        s["last_logits"][lanes_t] = last
        s["ts"].prev[lanes_t] = -1
        s["ts"].prevprev[lanes_t] = -1
        s["ts"].last_ts[lanes_t] = 0
        s["use_ts"][lanes_t] = torch.as_tensor(use_ts, dtype=torch.bool,
                                               device=dev)
        s["prompt_len"][lanes_t] = plens
        s["budget"][lanes_t] = torch.minimum(
            torch.as_tensor(budgets, dtype=torch.long, device=dev),
            self.t_store - plens)
        s["pos"][lanes_t] = plens
        s["finished"][lanes_t] = False
        s["sum_logprobs"][lanes_t] = 0.0
        s["no_speech_prob"][lanes_t] = no_speech
        if self.spec:
            s["drafted"][lanes_t] = 0
            s["accepted"][lanes_t] = 0
        else:
            seeds = [int(x) & 0xFFFFFFFFFFFFFFFF for x in (seeds or [0] * a)]
            s["temp"][lanes_t] = torch.as_tensor(
                temps or [0.0] * a, dtype=torch.float32, device=dev)
            s["topk"][lanes_t] = torch.as_tensor(
                top_ks or [0] * a, dtype=torch.long, device=dev)
            s["seed_lo"][lanes_t] = torch.as_tensor(
                [x & _M32 for x in seeds], dtype=torch.long, device=dev)
            s["seed_hi"][lanes_t] = torch.as_tensor(
                [x >> 32 for x in seeds], dtype=torch.long, device=dev)
        if self.assistant is not None:
            d_params, d_cfg = self.assistant
            d_enc = (enc if d_cfg.d_model == cfg.d_model
                     else encode(d_params["encoder"], d_cfg, mels,
                                 dtype=dtype))
            d_cross_new = cross_kv(d_params["decoder"], d_cfg, d_enc)
            d_cache_new = init_cache(d_cfg, a, dtype=dtype,
                                     max_len=self.t_buf, device=dev,
                                     width=kv_width(d_params["decoder"]))
            decode(d_params["decoder"], d_cfg, prom_t, cross=d_cross_new,
                   cache=d_cache_new, pos_offset=0, dtype=dtype)
            _scatter_lanes(s["d_cache"], d_cache_new, lanes_t)
            _scatter_lanes(s["d_cross"], d_cross_new, lanes_t)


@dataclass
class _EngineRequest:
    audio: np.ndarray
    language: Optional[str]
    task: str
    return_timestamps: Any                  # False | True | "word"
    max_new_tokens: Optional[int]
    done: threading.Event
    mode: str = "chunked"                   # or "sequential" (long-form)
    num_beams: int = 1                      # beam search width (1 = greedy)
    temperature: float = 0.0                # 0 = greedy; >0 = sampling
    top_k: int = 0                          # 0 = full vocab (sampling only)
    seed: Optional[int] = None              # sampling seed
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    # set by the client thread when it stops waiting (timeout / stream
    # disconnect): pending copies are dropped at admission and inflight
    # lanes are reclaimed between blocks (admission writes fresh state over
    # every per-lane field, so an orphaned lane still decoding is harmless)
    cancelled: bool = False
    _plen: int = 0                 # prompt length, for the tokens_out stat
    # streaming: partial results are pushed here once per step block;
    # a ``{"final": True}`` entry (or None after an error) terminates
    stream: Optional["queue.Queue"] = None
    _last_partial: str = ""
    # long-form: a >30 s request is split into strided 30 s windows that
    # ride lanes like any short request; children carry
    # ``parent``/``chunk_index``, the parent holds the assembly state
    parent: Optional["_EngineRequest"] = None
    chunk_index: int = -1
    _chunk_tokens: Optional[List[Optional[list]]] = None
    _chunk_strides: Optional[List[tuple]] = None
    _chunks_left: int = 0
    _stream_upto: int = 0
    # the window's mel [1, n_mels, 3000] on the device, computed by the
    # featurizer thread so that the step loop never waits on it
    _mel: Any = None


class ContinuousTranscriber(_StatsMixin):
    """Drop-in alternative to :class:`.serving.BatchingTranscriber` backed
    by the continuous-batching engine: the same ``submit()`` contract (so
    :func:`.serving.make_http_server` serves either), but finished lanes
    are refilled from the queue between step blocks.

    Over a meshed pipeline every rank of the job constructs it alike; the
    leader (:attr:`leader`, global rank 0) calls :meth:`start` and serves,
    the others call :meth:`follow`, which replays the leader's device calls
    until :meth:`stop`.
    """

    def __init__(self, pipe, batch_size: Optional[int] = None,
                 default_language=None,
                 max_new_tokens: Optional[int] = None,
                 block_steps: int = 16,
                 max_queue: Optional[int] = None,
                 assistant=None, gamma: int = 5,
                 synthetic_acceptance: Optional[float] = None,
                 adaptive_gamma: bool = False,
                 ngram_speculative: bool = False, max_ngram: int = 3,
                 synthetic_period: Optional[int] = None,
                 draft_cost: Optional[float] = None):
        self.pipe = pipe
        self.default_language = default_language
        self.max_new_tokens = int(max_new_tokens or pipe.max_new_tokens)
        self.engine = ContinuousBatchingEngine(
            pipe, lanes=batch_size or pipe.batch_size,
            block_steps=block_steps, max_new_tokens=self.max_new_tokens,
            assistant=assistant, gamma=gamma,
            synthetic_acceptance=synthetic_acceptance,
            ngram_speculative=ngram_speculative, max_ngram=max_ngram,
            synthetic_period=synthetic_period)
        self.batch_size = self.engine.lanes
        # backlog bound, in 30 s windows waiting for a lane; None -> 8
        # full refills deep.  0 is honoured (shed everything — drain mode).
        self.max_queue = (8 * self.batch_size if max_queue is None
                          else int(max_queue))
        self._q: "queue.Queue[Optional[_EngineRequest]]" = queue.Queue()
        # raw requests (_q) are featurised (mel + language) on a producer
        # thread and land here ready to admit
        self._ready: "queue.Queue[Optional[_EngineRequest]]" = queue.Queue()
        self._featurizer: Optional[threading.Thread] = None
        self._worker: Optional[threading.Thread] = None
        self._crashed: Optional[str] = None
        self._pending: List[_EngineRequest] = []
        self._inflight: Dict[int, _EngineRequest] = {}
        self._free: List[int] = list(range(self.engine.lanes))
        # requests the lanes cannot express run on a fallback thread
        self._fb_q: "queue.Queue[Optional[_EngineRequest]]" = queue.Queue()
        self._fb_worker: Optional[threading.Thread] = None
        self._fb_lock = threading.Lock()
        self._sequential = _SequentialRunner(pipe)
        self._init_stats({"requests": 0, "blocks": 0, "admitted": 0,
                          "long_form": 0, "word_ts": 0, "sequential": 0,
                          "fb_batches": 0, "fb_max_batch": 0, "beam": 0,
                          "max_inflight": 0, "rejected": 0, "cancelled": 0,
                          "tokens_out": 0})
        if self.engine.spec:
            self.stats.update({"drafted": 0, "accepted": 0,
                               "ts_fallback": 0, "sampled_fallback": 0})
            # adaptive draft length over {gamma/2, gamma, 2*gamma}
            self.adaptive_gamma = bool(adaptive_gamma)
            g0 = self.engine.gamma
            self._gamma_levels = list(self.engine.gamma_levels)
            self._gamma_idx = self._gamma_levels.index(g0)
            self._ctrl_d = 0
            self._ctrl_a = 0
            self._est_ema = None
            # draft/teacher decode cost ratio for the rung picker
            # (serving.optimal_gamma): the layer-count proxy, 0 for ngram
            if draft_cost is not None:
                self._draft_cost = float(draft_cost)
            elif self.engine.ngram:
                self._draft_cost = 0.0
            else:
                self._draft_cost = (
                    self.engine.assistant[1].decoder_layers
                    / max(pipe.cfg.decoder_layers, 1))
            self._lane_ctr: Dict[int, tuple] = {}
            self.stats.update({"gamma_current": g0, "gamma_raises": 0,
                               "gamma_drops": 0})
        else:
            self.adaptive_gamma = False
            self.stats["sampled"] = 0
        self._seeds = _SeedCounter()
        # sampled lanes resident (worker-thread-owned): while > 0 the engine
        # runs its sampling block; greedy-only traffic runs the greedy one
        self._sampled_inflight = 0
        # every device call that issues collectives under a mesh, by name
        # (the engine's looked up at call time)
        self._stream = Lockstep({
            "admit": lambda *a, **k: self.engine.admit(*a, **k),
            "step": lambda *a, **k: self.engine.step(*a, **k),
            "detect": pipe.detect_language,
            "words": pipe.transcribe_words_batch, "pipe": pipe,
            "sequential": self._sequential.run,
            "sampled": self._sampled_device}, device=self.engine.device,
            mesh=getattr(pipe, "mesh", None))

    @property
    def leader(self) -> bool:
        """True on the rank that serves (every rank without a mesh)."""
        return self._stream.leader or not self._stream.distributed

    def follow(self) -> None:
        """A follower's part: replay the leader's device calls until it
        stops (raises if one of them fails here)."""
        self.engine.init_state()
        self._stream.follow()

    # ------------------------------------------------------------- client
    def start(self) -> "ContinuousTranscriber":
        self.engine.init_state()
        self._featurizer = threading.Thread(target=self._run_featurizer,
                                            daemon=True,
                                            name="admission-featurizer")
        self._featurizer.start()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="continuous-transcriber")
        self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is not None:
            self._q.put(None)
            if self._featurizer is not None:
                self._featurizer.join(timeout=60)
                self._featurizer = None
            self._worker.join(timeout=60)
            self._worker = None
        with self._fb_lock:
            fb, self._fb_worker = self._fb_worker, None
        if fb is not None:
            self._fb_q.put(None)
            fb.join(timeout=60)
        self._stream.stop()

    def submit(self, audio, language: Optional[str] = None,
               task: str = "transcribe", return_timestamps: bool = False,
               timeout: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               mode: str = "chunked", num_beams: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None) -> Dict[str, Any]:
        req = self._make_request(audio, language, task, return_timestamps,
                                 max_new_tokens, mode, num_beams,
                                 temperature, top_k, seed)
        self._enqueue(req)
        if not req.done.wait(timeout):
            self._cancel(req)
            raise TimeoutError("transcription timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def _make_request(self, audio, language, task, return_timestamps,
                      max_new_tokens, mode, num_beams, temperature, top_k,
                      seed, stream=None) -> _EngineRequest:
        """Shared admission-time validation for both waiting styles."""
        wav = load_audio(audio, self.pipe.cfg.sampling_rate)
        ts = _coerce_timestamps(return_timestamps)
        beams = _coerce_beams(num_beams)
        md = _coerce_mode(mode, ts)
        temp, k = _coerce_sampling(temperature, top_k, beams, md, ts)
        if temp > 0:
            if len(wav) > self.pipe.cfg.n_samples:
                raise ValueError(
                    "sampling (temperature > 0) applies to single-window "
                    "(<=30 s) requests; long-form decoding is greedy/beam "
                    "per the reference protocol")
            if k > self.engine.k_max:
                raise ValueError(
                    f"top_k={k} exceeds this server's maximum "
                    f"{self.engine.k_max} (engine top_k_max)")
        language = language or self.default_language
        check_prompt(self.pipe.tokenizer, language, task)
        return _EngineRequest(wav, language, task,
                              ts, max_new_tokens, threading.Event(),
                              mode=md, num_beams=beams, temperature=temp,
                              top_k=k,
                              seed=None if seed is None else int(seed),
                              stream=stream)

    def _enqueue(self, req: _EngineRequest) -> None:
        if self._crashed is None and self._stream.closed is not None:
            self._crashed = f"the mesh's command stream is closed: " \
                            f"{self._stream.closed}"
        if self._crashed is not None:
            raise RuntimeError(self._crashed)
        # backlog = raw queue + featurised-but-unadmitted windows + windows
        # waiting for a lane + fallback queue (approximate reads of
        # worker-owned lists: load shedding only needs to bound growth)
        if (self._q.qsize() + self._ready.qsize() + len(self._pending)
                + self._fb_q.qsize()) >= self.max_queue:
            self._bump("rejected")
            raise ServerOverloadedError(
                f"request backlog at max_queue={self.max_queue}")
        self._q.put(req)

    def _cancel(self, req: _EngineRequest) -> None:
        if not req.done.is_set() and not req.cancelled:
            req.cancelled = True
            self._bump("cancelled")

    def snapshot(self) -> Dict[str, Any]:
        """Live observability view (GET /v1/stats)."""
        snap = {"scheduler": "continuous",
                "queue_depth": self._q.qsize(),
                "ready_depth": self._ready.qsize(),
                "fallback_depth": self._fb_q.qsize(),
                "pending_windows": len(self._pending),
                "inflight": len(self._inflight),
                "free_lanes": len(self._free),
                "lanes": self.engine.lanes,
                "max_queue": self.max_queue,
                "stats": dict(self.stats)}
        if self.engine.spec:
            snap["speculative"] = {
                "method": "ngram" if self.engine.ngram else "draft",
                "gamma": self.engine.gamma,
                "gamma_current": self.stats["gamma_current"],
                "adaptive": self.adaptive_gamma,
                "acceptance_rate": round(
                    self.stats["accepted"] / self.stats["drafted"], 3)
                if self.stats["drafted"] else None}
            if self.adaptive_gamma:
                snap["speculative"]["draft_cost"] = self._draft_cost
        return snap

    def submit_stream(self, audio, language: Optional[str] = None,
                      task: str = "transcribe",
                      return_timestamps: bool = False,
                      timeout: Optional[float] = None,
                      max_new_tokens: Optional[int] = None,
                      mode: str = "chunked", num_beams: int = 1,
                      temperature: float = 0.0, top_k: int = 0,
                      seed: Optional[int] = None):
        """Streaming transcription: yields ``{"text": ..., "final": False}``
        partials as the lane decodes (once per step block when the text
        grew), then the full result with ``final: True``.

        A plain function (NOT a generator): admission — audio decode,
        argument validation, the backlog bound — runs HERE, before the HTTP
        layer has committed a 200 + ndjson headers, so
        :class:`.serving.ServerOverloadedError` maps to 503 + Retry-After
        exactly like the blocking path."""
        req = self._make_request(audio, language, task, return_timestamps,
                                 max_new_tokens, mode, num_beams,
                                 temperature, top_k, seed,
                                 stream=queue.Queue())
        self._enqueue(req)

        def _gen():
            try:
                while True:
                    try:
                        item = req.stream.get(timeout=timeout)
                    except queue.Empty:
                        raise TimeoutError(
                            "transcription timed out") from None
                    if item is None:  # terminated by error
                        raise RuntimeError(req.error or "stream aborted")
                    yield item
                    if item.get("final"):
                        return
            finally:
                # consumer stopped early (timeout, client disconnect ->
                # generator.close(), or an error): stop decoding for it
                if not req.done.is_set():
                    self._cancel(req)

        return _gen()

    # ---------------------------------------------------- admission producer
    def _run_featurizer(self) -> None:
        """Routing and featurisation off the step loop's thread: requests
        the lanes cannot express go to the fallback thread, long files are
        cut into windows, and each window's mel (the mel kernel on the
        card) and language are computed here."""
        while True:
            req = self._q.get()
            if req is None:
                self._ready.put(None)
                return
            self._bump("requests")
            try:
                if (req.return_timestamps == "word"
                        or req.mode == "sequential"
                        or req.num_beams > 1
                        or (self.engine.spec and req.temperature > 0)):
                    # word timestamps need the cross-attention alignment
                    # pass, sequential long-form is a host-driven window
                    # loop, beams are not lanes, and speculative lanes
                    # verify argmax agreement; segment timestamps ride the
                    # speculative lanes (per-column FSM in the verify)
                    self._bump("word_ts" if req.return_timestamps == "word"
                               else "sequential" if req.mode == "sequential"
                               else "beam" if req.num_beams > 1
                               else "sampled_fallback")
                    self._ensure_fb_worker()
                    self._fb_q.put(req)
                    continue
                children = (self._split_long(req)
                            if len(req.audio) > self.pipe.cfg.n_samples
                            else [req])
                for c in children:
                    if not (c.parent or c).cancelled:
                        self._featurise(c)
                    self._ready.put(c)
            except Exception as e:  # noqa: BLE001 — fail the request
                logger.exception("admission featurisation failed")
                self._finish_req(req, error=f"{type(e).__name__}: {e}")

    def _window_mel(self, audio: np.ndarray) -> torch.Tensor:
        """One zero-padded 30 s window's mel [1, n_mels, 3000] on the
        pipeline's device."""
        cfg = self.pipe.cfg
        wav = np.zeros((1, cfg.n_samples), np.float32)
        wav[0, :len(audio)] = audio[:cfg.n_samples]
        return compute_mel(wav, cfg, device=self.pipe.device)

    @torch.no_grad()
    def _featurise(self, r: _EngineRequest) -> None:
        """Compute the window's mel on the device and resolve its language
        (idempotent: admission calls it again only if ``_mel`` is unset,
        e.g. for requests injected by white-box tests)."""
        if r._mel is None:
            r._mel = self._window_mel(r.audio)
        tok = self.pipe.tokenizer
        if r.language is None and len(tok.lang_to_id) > 1:
            r.language = self._stream.call(
                "detect", r._mel.to(self.pipe.dtype))[0]

    # --------------------------------------------------------------- worker
    def _drain_ready(self, block: bool) -> bool:
        """Move featurised windows into the pending list.  Returns False
        when the shutdown sentinel was seen.  ``block`` waits for the first
        item (the engine is idle — nothing to step)."""
        first = block
        while True:
            try:
                req = self._ready.get() if first else self._ready.get_nowait()
            except queue.Empty:
                return True
            first = False
            if req is None:
                return False
            self._pending.append(req)

    @torch.no_grad()
    def _split_long(self, r: _EngineRequest) -> List[_EngineRequest]:
        """Split a >30 s request into the pipeline's strided windows
        (``pipeline._chunk``), admitted as ordinary lane requests; one
        language for the whole file, detected on the first window."""
        self._bump("long_form")
        tok = self.pipe.tokenizer
        chunks = self.pipe._chunk(r.audio, 30.0, None)
        if r.language is None and len(tok.lang_to_id) > 1:
            mel0 = self._window_mel(chunks[0]["audio"])
            r.language = self._stream.call("detect",
                                           mel0.to(self.pipe.dtype))[0]
        r._chunk_tokens = [None] * len(chunks)
        r._chunk_strides = [c["stride"] for c in chunks]
        r._chunks_left = len(chunks)
        return [_EngineRequest(
            c["audio"], r.language, r.task, r.return_timestamps,
            r.max_new_tokens, threading.Event(), parent=r,
            chunk_index=i) for i, c in enumerate(chunks)]

    def _admit_pending(self) -> None:
        """Admit featurised requests into every free lane at once (the JAX
        engine admits in power-of-two buckets to bound its compiles)."""
        eng, tok = self.engine, self.pipe.tokenizer
        # drop windows whose client stopped waiting before they got a lane
        self._pending = [r for r in self._pending
                         if not (r.parent or r).cancelled]
        a = min(len(self._pending), len(self._free))
        if not a:
            return
        reqs, self._pending = self._pending[:a], self._pending[a:]
        lanes, self._free = self._free[:a], self._free[a:]
        for r in reqs:
            self._featurise(r)  # no-op unless injected unprepared
        mels = torch.cat([r._mel for r in reqs])
        prompts = [tok.prompt_ids(language=r.language, task=r.task,
                                  no_timestamps=not r.return_timestamps)
                   for r in reqs]
        budgets = [_budget(r.max_new_tokens, self.max_new_tokens)
                   for r in reqs]
        use_ts = [bool(r.return_timestamps) for r in reqs]
        # the admitted requests are in flight from here, so that a failed
        # admission errors them out with the rest (_abort_all)
        for lane, r in zip(lanes, reqs):
            self._inflight[lane] = r
        if eng.spec:
            self._stream.call("admit", mels, prompts, budgets, use_ts, lanes)
        else:
            for r in reqs:
                if r.temperature > 0:
                    if r.seed is None:
                        r.seed = self._seeds.take()
                    self._bump("sampled")
                    self._sampled_inflight += 1
            self._stream.call("admit", mels, prompts, budgets, use_ts, lanes,
                              temps=[r.temperature for r in reqs],
                              top_ks=[r.top_k for r in reqs],
                              seeds=[r.seed or 0 for r in reqs])
        for lane, r, p in zip(lanes, reqs, prompts):
            r._plen = len(p)
            r._mel = None  # free the device buffer
            self._inflight[lane] = r
        self._bump("admitted", a)
        self._bump_max("max_inflight", len(self._inflight))

    @staticmethod
    def _finish_req(r: _EngineRequest, result: Optional[Dict[str, Any]] = None,
                    error: Optional[str] = None) -> None:
        """Deliver a request's terminal state to both waiting styles
        (blocking ``submit`` and the ``submit_stream`` queue)."""
        if error is not None:
            r.error = error
            if r.stream is not None:
                r.stream.put(None)
        else:
            r.result = result
            if r.stream is not None:
                r.stream.put({**result, "final": True})
        r.done.set()

    def _complete(self, block_out) -> None:
        """Read a step block's outputs: finish completed lanes and emit
        streaming partials for lanes still running.

        ``block_out`` is ``(packed, snapshot)``, the inflight map when the
        block ran: a lane freed and re-admitted since then is skipped (the
        new request completes from a later block)."""
        tok = self.pipe.tokenizer
        packed, snap = block_out
        finished, pos, tokens, counters = self.engine.unpack(packed)
        if counters is not None and self.adaptive_gamma:
            self._update_gamma_controller(snap, counters)
        for lane, r in list(self._inflight.items()):
            if snap.get(lane) is not r:
                continue  # admitted after this block ran
            ids = tokens[lane][:pos[lane]].tolist()
            if not finished[lane]:
                if r.stream is not None:
                    text = tok.decode(ids, skip_special_tokens=True)
                    if text != r._last_partial:
                        r._last_partial = text
                        r.stream.put({"text": text, "final": False})
                continue
            self._inflight.pop(lane)
            self._free.append(lane)
            if r.temperature > 0:
                self._sampled_inflight -= 1
            self._bump("tokens_out", max(0, int(pos[lane]) - r._plen))
            if counters is not None:
                self._bump("drafted", int(counters[0][lane]))
                self._bump("accepted", int(counters[1][lane]))
                self._lane_ctr.pop(lane, None)
            try:
                if r.parent is not None:
                    self._finish_chunk(r, ids)
                    continue
                self._finish_req(r, _short_result(tok, ids,
                                                  r.return_timestamps))
            except Exception as e:  # noqa: BLE001 — fail the request
                logger.exception("engine request postprocessing failed")
                self._finish_req(r.parent or r,
                                 error=f"{type(e).__name__}: {e}")

    def _finish_chunk(self, r: _EngineRequest, ids: list) -> None:
        """A long-form window completed: record it on the parent; when every
        window is in, merge with the strided ``decode_asr`` (the pipeline's
        multi-chunk branch).  A streaming parent gets a partial merge
        whenever the completed prefix grows."""
        tok = self.pipe.tokenizer
        p = r.parent
        p._chunk_tokens[r.chunk_index] = ids
        p._chunks_left -= 1
        r.done.set()
        if p.error is not None or p.result is not None:
            return  # parent already terminated (a sibling failed)
        if p._chunks_left == 0:
            outputs = [{"tokens": t, "stride": s}
                       for t, s in zip(p._chunk_tokens, p._chunk_strides)]
            text, optional = tok.decode_asr(
                outputs, return_timestamps=p.return_timestamps)
            self._finish_req(p, {"text": text, **optional})
            return
        if p.stream is not None:
            k = 0
            while (k < len(p._chunk_tokens)
                   and p._chunk_tokens[k] is not None):
                k += 1
            if k > p._stream_upto:
                p._stream_upto = k
                outputs = [{"tokens": t, "stride": s}
                           for t, s in zip(p._chunk_tokens[:k],
                                           p._chunk_strides[:k])]
                text, _ = tok.decode_asr(
                    outputs, return_timestamps=p.return_timestamps)
                p.stream.put({"text": text, "final": False})

    def _update_gamma_controller(self, snap, counters) -> None:
        """Walk the gamma ladder on the measured per-draft acceptance.

        Counters are per-lane cumulative since admission; deltas are taken
        per (lane, request) so that admissions (which reset the counters)
        never corrupt the window.  Once the window holds 16 * gamma drafts,
        the per-draft acceptance is recovered (:func:`.serving.
        estimate_accept`),
        smoothed by an EMA over windows, and the level moves one rung toward
        the cost-optimal gamma when that is predicted > 2% better."""
        for lane, r in snap.items():
            if self._inflight.get(lane) is not r:
                continue  # lane re-admitted since: stale counters
            d, a = int(counters[0][lane]), int(counters[1][lane])
            rid, pd, pa = self._lane_ctr.get(lane, (None, 0, 0))
            if rid is not id(r):
                pd, pa = 0, 0
            if d >= pd:
                self._ctrl_d += d - pd
                self._ctrl_a += a - pa
            self._lane_ctr[lane] = (id(r), d, a)
        g = self._gamma_levels[self._gamma_idx]
        if self._ctrl_d < 16 * g:
            return
        est = estimate_accept(self._ctrl_a / self._ctrl_d, g)
        self._ctrl_d = 0
        self._ctrl_a = 0
        self._est_ema = est if self._est_ema is None else (
            0.5 * self._est_ema + 0.5 * est)
        with self._stats_lock:
            self._gamma_idx = _gamma_step(self._est_ema, self._gamma_levels,
                                          self._gamma_idx, self._draft_cost,
                                          self.stats)
            self.stats["gamma_current"] = self._gamma_levels[self._gamma_idx]

    def _ensure_fb_worker(self) -> None:
        with self._fb_lock:
            if self._fb_worker is None:
                self._fb_worker = threading.Thread(
                    target=self._run_fallback, daemon=True,
                    name="continuous-fallback")
                self._fb_worker.start()

    def _run_fallback(self) -> None:
        """Serve requests the lanes cannot express.  Queued single-window
        word-timestamp requests are micro-batched: everything waiting is
        drained and served in shared ``pipe.transcribe_words_batch`` calls
        (a burst costs ceil(K / batch) calls, not K).  Sequential, beam,
        long-form word timestamps and sampling under a speculative engine
        run singly."""
        saw_sentinel = False
        while not saw_sentinel:
            r = self._fb_q.get()
            if r is None:
                return
            batch = [r]
            while len(batch) < max(self.engine.lanes, 8):
                try:
                    nxt = self._fb_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True  # serve what we hold, then exit
                    break
                batch.append(nxt)
            batch = [b for b in batch if not b.cancelled]
            # word-ts singles grouped by (task, budget) -> one batched call;
            # language may vary per row (detected in-batch when missing)
            groups: Dict[Any, List[_EngineRequest]] = {}
            singles: List[_EngineRequest] = []
            for b in batch:
                if (b.return_timestamps == "word" and b.num_beams == 1
                        and len(b.audio) <= self.pipe.cfg.n_samples):
                    max_new = _budget(b.max_new_tokens, self.max_new_tokens)
                    groups.setdefault((b.task, max_new), []).append(b)
                else:
                    singles.append(b)
            for (task, max_new), reqs in groups.items():
                try:
                    results = self._stream.call(
                        "words", [b.audio for b in reqs],
                        languages=[b.language for b in reqs],
                        task=task, max_new_tokens=max_new)
                    self._bump("fb_batches")
                    self._bump_max("fb_max_batch", len(reqs))
                    for b, res in zip(reqs, results):
                        self._finish_req(b, res)
                except Exception as e:  # noqa: BLE001 — fail the group
                    logger.exception("fallback word-ts batch failed")
                    for b in reqs:
                        self._finish_req(b, error=f"{type(e).__name__}: {e}")
            for b in singles:
                self._run_fallback_single(b)

    def _run_fallback_single(self, r: _EngineRequest) -> None:
        try:
            if r.mode == "sequential":
                result = self._stream.call("sequential", r.audio, r.language,
                                           r.task, r.max_new_tokens,
                                           r.num_beams)
            elif r.temperature > 0:
                result = self._run_sampled_single(r)
            else:
                gk = ({"num_beams": r.num_beams} if r.num_beams > 1
                      else None)
                result = self._stream.call(
                    "pipe", r.audio, language=r.language, task=r.task,
                    return_timestamps=r.return_timestamps,
                    max_new_tokens=_budget(r.max_new_tokens,
                                           self.max_new_tokens),
                    generate_kwargs=gk)
            self._finish_req(r, result)
        except Exception as e:  # noqa: BLE001 — fail the request
            logger.exception("fallback request failed")
            self._finish_req(r, error=f"{type(e).__name__}: {e}")

    def _run_sampled_single(self, r: _EngineRequest) -> Dict[str, Any]:
        """Sampled short-form off the lanes (a speculative engine routes
        sampling here — the accept/verify contract is argmax agreement):
        the port's sampled ``generate`` with a generator on the pipeline's
        device seeded from the request."""
        if r.seed is None:
            r.seed = self._seeds.take()
        return self._stream.call(
            "sampled", self._window_mel(r.audio), r.language, r.task,
            r.return_timestamps, r.temperature, r.top_k, r.seed,
            r.max_new_tokens)

    @torch.no_grad()
    def _sampled_device(self, mel: torch.Tensor, language, task: str,
                        return_timestamps, temperature: float, top_k: int,
                        seed: int, max_new_tokens: Optional[int]
                        ) -> Dict[str, Any]:
        """The device part of :meth:`_run_sampled_single` (every rank)."""
        pipe, cfg, tok = self.pipe, self.pipe.cfg, self.pipe.tokenizer
        mel = mel.to(pipe.dtype)
        if language is None and len(tok.lang_to_id) > 1:
            language = pipe.detect_language(mel)[0]
        prompt = tok.prompt_ids(language=language, task=task,
                                no_timestamps=not return_timestamps)
        opts = GenerationOptions.from_config(
            cfg, max_new_tokens=self.max_new_tokens,
            return_timestamps=bool(return_timestamps),
            no_speech_token_id=tok.no_speech, do_sample=True, top_k=top_k)
        enc = encode(pipe.params["encoder"], cfg, mel, dtype=pipe.dtype)
        out = generate(pipe.params["decoder"], cfg, enc,
                       torch.tensor([prompt], device=pipe.device), opts,
                       temperature=float(temperature),
                       generator=torch.Generator(
                           device=pipe.device).manual_seed(seed),
                       dtype=pipe.dtype, graphs=pipe.graphs)
        cut = int(out.seq_len[0])
        if max_new_tokens is not None:
            cut = min(cut, len(prompt) + max(int(max_new_tokens), 0))
        return _short_result(tok, out.sequences[0, :cut].tolist(),
                             return_timestamps)

    def _reclaim_cancelled(self) -> None:
        """Free lanes whose occupant's client stopped waiting.  Safe without
        touching device state: admission writes fresh values over every
        per-lane field."""
        for lane, r in list(self._inflight.items()):
            if (r.parent or r).cancelled:
                self._inflight.pop(lane)
                self._free.append(lane)
                if r.temperature > 0:
                    self._sampled_inflight -= 1

    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — submitters must hear
            logger.exception("continuous-batching worker crashed")
            self._crashed = f"worker crashed: {type(e).__name__}: {e}"
            self._abort_all(self._crashed)

    def _abort_all(self, msg: str) -> None:
        """Error out every waiting submitter (long-form children resolve to
        their parent, which is finished once)."""
        while True:  # include featurised windows not yet drained
            try:
                r = self._ready.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                self._pending.append(r)
        seen = set()
        for r in self._pending + list(self._inflight.values()):
            target = r.parent or r
            if id(target) in seen:
                continue
            seen.add(id(target))
            if target.result is None and target.error is None:
                self._finish_req(target, error=msg)

    def _run_inner(self) -> None:
        shutting_down = False
        while True:
            if not shutting_down:
                idle = not self._inflight and not self._pending
                if not self._drain_ready(block=idle):
                    shutting_down = True
            self._reclaim_cancelled()
            self._admit_pending()
            if self._inflight:
                gamma = (self._gamma_levels[self._gamma_idx]
                         if self.engine.spec else None)
                snap = dict(self._inflight)
                packed = self._stream.call("step",
                                           self._sampled_inflight > 0,
                                           gamma=gamma)
                self._bump("blocks")
                self._complete((packed, snap))
            if shutting_down and not self._inflight and not self._pending:
                return
