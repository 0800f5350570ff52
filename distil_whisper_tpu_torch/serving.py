"""Micro-batching transcription serving and the HTTP front end.

Counterpart of ``distil_whisper_tpu.serving``: the same classes, helpers,
routes and error mapping, on the port's pipeline.

* :class:`BatchingTranscriber` — a worker thread drains a request queue
  into micro-batches (up to ``batch_size`` requests or ``max_wait_ms``,
  whichever first), groups them by generation options and runs each group
  as one batch of windows through the port's functions: ``generate``
  (greedy, or sampled with a ``torch.Generator`` on the pipeline's device),
  ``beam_search``, or speculative decoding (a draft model or n-gram
  lookup).  Audio longer than one 30 s window, and word timestamps with
  beams, go through the whole pipeline; single-window word timestamps
  micro-batch through ``transcribe_words_batch``.
* :func:`make_http_server` — a stdlib ``ThreadingHTTPServer`` exposing
  ``POST /v1/transcribe`` (WAV bytes in, JSON or ndjson out),
  ``GET /healthz`` and ``GET /v1/stats``.  Each HTTP thread blocks on its
  request's completion; the scheduler's threads own the device.

A transcriber built on a CUDA pipeline runs every device call on the card,
on the default stream: a tensor crosses threads only after the call that
produced it has returned, so stream order is issue order.

Over a meshed pipeline (``WhisperPipeline(mesh=)``) every rank constructs
the transcriber; global rank 0 leads (``leader``: it starts the worker and
serves) and the others :meth:`BatchingTranscriber.follow`.  Each
micro-batch's requests (audio and options) are published on the command
stream (``parallel/lockstep.py``) and every rank dispatches the same
groups: a group's rows are split over the data axis and its tokens
gathered (``pipeline.decode_over_data``), the other paths are the meshed
pipeline's.  A failed group ends the worker there, and later submissions
are refused.

JAX compiles one program per group shape and pads a ragged group to the
data-parallel width; the port runs the rows that exist.  The helpers
(validation, the gamma controller's model) are copies of the JAX module's,
which this package does not import.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio import compute_mel
from .audio.io import load_audio
from .device import resolve_device
from .generation import GenerationOptions, beam_search, generate
from .generation.speculative import (ngram_speculative_generate_batched,
                                     prepare_assistant,
                                     speculative_generate_batched)
from .models.whisper import encode
from .parallel.lockstep import REQUEST_ERRORS, Lockstep
from .pipeline import decode_over_data

logger = logging.getLogger("distil_whisper_tpu_torch")


class ServerOverloadedError(RuntimeError):
    """The request backlog is at ``max_queue`` — reject instead of queueing
    unboundedly (the HTTP layer maps this to 503 + Retry-After: a client
    retry against a drained queue beats an ever-growing latency tail)."""


def _coerce_timestamps(return_timestamps):
    """Normalise to the pipeline's contract: False | True | "word".

    Unrecognised strings raise instead of being silently downgraded to
    segment-level (a caller asking for an unsupported granularity must hear
    about it — same contract the HTTP layer applies to ``timestamps=word``).
    """
    if isinstance(return_timestamps, str):
        low = return_timestamps.strip().lower()
        if low == "word":
            return "word"
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(
            f"unsupported timestamps value {return_timestamps!r} "
            "(use true/false for segment-level or 'word')")
    return bool(return_timestamps)


def _coerce_beams(num_beams) -> int:
    b = int(num_beams)
    if b < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams!r}")
    return b


def _coerce_sampling(temperature, top_k, num_beams, mode,
                     return_timestamps) -> "tuple[float, int]":
    """Validate per-request sampling knobs (HF ``do_sample`` semantics:
    temperature-scaled categorical with optional top-k filtering).

    Invalid combinations raise instead of silently downgrading to greedy.
    Sampling composes with segment timestamps (the FSM constrains the
    sampled distribution exactly as it constrains argmax) but not with beam
    search, the sequential ladder (which owns its own fallback
    temperatures), or the word-alignment pass.
    """
    t = float(temperature)
    k = int(top_k)
    if t < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature!r}")
    if k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k!r}")
    if t == 0 and k > 0:
        raise ValueError("top_k requires temperature > 0 (temperature 0 is "
                         "greedy decoding; top-k would be a silent no-op)")
    if t > 0:
        if num_beams > 1:
            raise ValueError("sampling (temperature > 0) cannot be combined "
                             "with beam search")
        if mode == "sequential":
            raise ValueError("mode=sequential owns its own temperature-"
                             "fallback ladder; per-request sampling applies "
                             "to short-form requests")
        if return_timestamps == "word":
            raise ValueError("timestamps=word requires greedy/beam decoding "
                             "(the alignment pass follows the winning "
                             "hypothesis)")
    return t, k


def estimate_accept(ratio: float, gamma: int) -> float:
    """Invert E[accepted]/gamma = a(1-a^g)/(g(1-a)) for the per-draft
    acceptance probability a (monotonic in a; bisection).  The raw
    accepted/drafted ratio understates a: a rejected draft wastes the rest
    of its window.  Shared by both schedulers' gamma controllers."""
    ratio = min(max(ratio, 0.0), 1.0)
    lo, hi = 0.0, 0.999999
    for _ in range(40):
        mid = (lo + hi) / 2
        e = mid * (1 - mid ** gamma) / ((1 - mid) * gamma)
        if e < ratio:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def optimal_gamma(a: float, levels, draft_cost: float,
                  width_cost: float = 0.04) -> int:
    """The rung maximising expected emitted tokens per unit round time.

    A round at draft length g emits ``E(a,g) + 1`` tokens (the accepted
    draft prefix plus the teacher's own choice at the first mismatch) where
    ``E(a,g) = sum_{i=1..g} a^i``, and costs ``g*draft_cost + 1 +
    g*width_cost`` in verify-step units: g draft steps, one verify, and the
    marginal cost of making that verify (g+1) columns wide.  An
    acceptance-threshold walk ("raise when a >= 0.8") ignores the cost
    side: at a = 0.8 doubling gamma 5 -> 10 grows E by only 0.6 token while
    doubling the draft bill.

    ``draft_cost`` is the draft/teacher per-token decode cost ratio; decode
    is weight-read bound, so the decoder layer-count ratio is the default
    proxy (0 for draft-free ngram lookup).  ``width_cost`` is the marginal
    verify column, 4% by default (the JAX package's measured value; the
    card's is not measured)."""
    a = min(max(a, 0.0), 0.999999)
    best, best_v = levels[0], -1.0
    for g in levels:
        emit = a * (1 - a ** g) / (1 - a) + 1.0
        v = emit / (g * draft_cost + 1.0 + g * width_cost)
        if v > best_v:
            best, best_v = g, v
    return best


def _gamma_step(est: float, levels, idx: int, draft_cost: float,
                stats, margin: float = 1.02) -> int:
    """One controller window: move ``idx`` one rung toward the cost-optimal
    gamma if that rung is predicted > ``margin`` better than the current
    one; update the raise/drop counters in ``stats``.  Shared by both
    schedulers' controllers."""

    def tput(g):
        a = min(max(est, 0.0), 0.999999)
        return (a * (1 - a ** g) / (1 - a) + 1.0) / (
            g * draft_cost + 1.0 + 0.04 * g)

    target = optimal_gamma(est, levels, draft_cost)
    cur = levels[idx]
    if target == cur or tput(target) < margin * tput(cur):
        return idx
    if target > cur:
        stats["gamma_raises"] += 1
        return idx + 1
    stats["gamma_drops"] += 1
    return idx - 1


def _coerce_mode(mode, return_timestamps) -> str:
    """Validate the long-form algorithm choice."""
    if mode not in ("chunked", "sequential"):
        raise ValueError(f"unsupported mode {mode!r} "
                         "(use 'chunked' or 'sequential')")
    if mode == "sequential" and return_timestamps == "word":
        raise ValueError("timestamps=word requires the chunked pipeline "
                         "(cross-attention alignment); sequential results "
                         "carry segment-level timestamps in 'segments'")
    return mode


def check_prompt(tok, language: Optional[str], task: str) -> None:
    """Raise ValueError at submission for a prompt the tokenizer cannot
    build (an unknown language), before any device call takes the
    request."""
    if tok is not None and language is not None:
        tok.prompt_ids(language=language, task=task)


def _budget(requested: Optional[int], server_max: int) -> int:
    """A request's token budget, clamped to [1, the server's]."""
    if requested is None:
        return server_max
    return max(1, min(int(requested), server_max))


class _StatsMixin:
    """A stats dict shared by the client, worker and fallback threads:
    ``_bump`` takes a lock, since ``+=`` on a dict entry is not atomic."""

    def _init_stats(self, stats: Dict[str, Any]) -> None:
        self.stats = stats
        self._stats_lock = threading.Lock()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _bump_max(self, key: str, value: int) -> None:
        with self._stats_lock:
            self.stats[key] = max(self.stats[key], value)


class _SeedCounter:
    """Server-derived seeds for sampled requests that pin none."""

    def __init__(self):
        self._next = 0
        self._lock = threading.Lock()

    def take(self) -> int:
        with self._lock:
            seed = self._next
            self._next += 1
        return seed


class _SequentialRunner:
    """Sequential long-form executor shared by both schedulers.

    Per-request ``mode=sequential`` runs the timestamp-driven sliding
    window with the reference's fallback ladder
    (:class:`.generation.sequential.SequentialTranscriber`) instead of the
    chunked pipeline.  One transcriber is cached per (language, task,
    per-window budget, beams) and reused across requests; the whole-file
    features go through ``compute_mel`` on the pipeline's device.
    """

    #: per-window decode budget cap (the SequentialOptions default — the
    #: reference's long-form regime; the server's short-form budget would
    #: starve 30 s windows)
    WINDOW_BUDGET = 224

    def __init__(self, pipe):
        self.pipe = pipe
        self._cache: Dict[Any, Any] = {}
        self._lock = threading.Lock()

    def _transcriber(self, language, task, max_new, num_beams):
        from .generation.sequential import (SequentialOptions,
                                            SequentialTranscriber)
        key = (language, task, max_new, num_beams)
        with self._lock:
            tr = self._cache.get(key)
            if tr is None:
                tr = SequentialTranscriber(
                    self.pipe.params, self.pipe.cfg, self.pipe.tokenizer,
                    SequentialOptions(max_new_tokens=max_new,
                                      num_beams=num_beams),
                    language=language, task=task, batch_size=1,
                    dtype=self.pipe.dtype, device=self.pipe.device)
                self._cache[key] = tr
        return tr

    @torch.no_grad()
    def run(self, audio, language, task,
            max_new_tokens: Optional[int] = None,
            num_beams: int = 1) -> Dict[str, Any]:
        pipe, cfg, tok = self.pipe, self.pipe.cfg, self.pipe.tokenizer
        if language is None and len(tok.lang_to_id) > 1:
            head = compute_mel(audio[:cfg.n_samples], cfg,
                               device=pipe.device).to(pipe.dtype)
            language = pipe.detect_language(head)[0]
        max_new = _budget(max_new_tokens, self.WINDOW_BUDGET)
        feat = compute_mel(audio, cfg, pad_to_chunk=False,
                           device=pipe.device)[0]
        res = self._transcriber(language, task, max_new,
                                num_beams).transcribe([feat])[0]
        return {
            "text": res["text"],
            "language": language,
            "segments": [{
                "start": float(s["start"]), "end": float(s["end"]),
                "text": s["text"], "tokens": [int(t) for t in s["tokens"]],
                "temperature": float(s["temperature"]),
                "avg_logprob": float(s["avg_logprob"]),
                "compression_ratio": float(s["compression_ratio"]),
                "no_speech_prob": float(s["no_speech_prob"]),
            } for s in res["segments"]],
        }


def _short_result(tok, ids: List[int], return_timestamps) -> Dict[str, Any]:
    """One window's tokens as the pipeline's short-form result."""
    result = {"text": tok.decode(ids, skip_special_tokens=True)}
    if return_timestamps:
        _, opt = tok.decode_asr([{"tokens": ids}], return_timestamps=True)
        result.update(opt)
    return result


@dataclass
class _Request:
    audio: np.ndarray                       # float32 mono @ cfg.sampling_rate
    language: Optional[str]
    task: str
    return_timestamps: Any                  # False | True | "word"
    max_new_tokens: Optional[int] = None    # per-request cap (<= server max)
    mode: str = "chunked"                   # or "sequential" (long-form)
    num_beams: int = 1                      # beam search width (1 = greedy)
    temperature: float = 0.0                # 0 = greedy; >0 = sampling
    top_k: int = 0                          # 0 = full vocab (sampling only)
    seed: Optional[int] = None              # generator seed (sampling only)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    # set by the client thread when it stops waiting (timeout / disconnect);
    # the worker drops cancelled requests instead of spending device time on
    # output nobody will read.  Plain bool: a lost race only means the work
    # runs once more, never corruption.
    cancelled: bool = False


# the fields of a request that a micro-batch publishes to the followers
_FIELDS = ("audio", "language", "task", "return_timestamps", "max_new_tokens",
           "mode", "num_beams", "temperature", "top_k", "seed")


class BatchingTranscriber(_StatsMixin):
    """Micro-batching front-end over a :class:`.pipeline.WhisperPipeline`.

    ``submit()`` blocks the calling (HTTP) thread until its request's batch
    has run; the single worker thread owns all device calls.  Over a
    meshed pipeline the leader serves and the other ranks :meth:`follow`.
    """

    def __init__(self, pipe, batch_size: Optional[int] = None,
                 max_wait_ms: float = 50.0, default_language=None,
                 max_new_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 assistant=None, gamma: int = 5,
                 synthetic_acceptance: Optional[float] = None,
                 ngram_speculative: bool = False, max_ngram: int = 3,
                 adaptive_gamma: bool = False,
                 draft_cost: Optional[float] = None):
        resolve_device(pipe.device)     # a missing card fails here
        self.pipe = pipe
        self.batch_size = batch_size or pipe.batch_size
        self.max_wait_s = max_wait_ms / 1e3
        self.default_language = default_language
        self.max_new_tokens = max_new_tokens or pipe.max_new_tokens
        # speculative decoding: ``assistant`` = (draft_params, draft_cfg) —
        # a draft proposes, the served model verifies; token-identical to
        # the served model's greedy decode, timestamped or not
        self.ngram = bool(ngram_speculative)
        if self.ngram and assistant is not None:
            raise ValueError(
                "pick ONE speculation method: assistant draft or ngram lookup")
        self.assistant = prepare_assistant(assistant, pipe.dtype, pipe.device,
                                           getattr(pipe, "mesh", None))
        self.max_ngram = int(max_ngram)
        self.gamma = int(gamma)
        # benchmark only: pin the per-draft accept rate with a
        # position-keyed oracle while both models run their real compute;
        # the output tokens are then synthetic
        self.synthetic_acceptance = synthetic_acceptance
        # backlog bound (requests waiting for a worker slot); None -> 8
        # batches deep.  0 is honoured (shed everything — drain mode).
        self.max_queue = (8 * self.batch_size if max_queue is None
                          else int(max_queue))
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._sequential = _SequentialRunner(pipe)
        self._init_stats({"requests": 0, "batches": 0, "max_batch": 0,
                          "long_form": 0, "word_ts": 0, "word_ts_batches": 0,
                          "word_ts_max_batch": 0, "sequential": 0,
                          "rejected": 0, "cancelled": 0, "sampled": 0})
        self._seeds = _SeedCounter()
        if self.assistant is not None or self.ngram:
            self.stats.update({"speculative_batches": 0, "drafted": 0,
                               "accepted": 0})
        # adaptive draft length: a ladder {gamma/2, gamma, 2*gamma} walked
        # on the measured per-draft acceptance; token identity is
        # gamma-independent, so switching is a throughput knob only
        self.adaptive_gamma = bool(adaptive_gamma) and (
            self.assistant is not None or self.ngram)
        if self.adaptive_gamma:
            g0 = self.gamma
            self._gamma_levels = sorted({max(1, g0 // 2), g0, 2 * g0})
            self._gamma_idx = self._gamma_levels.index(g0)
            self._ctrl_d = 0
            self._ctrl_a = 0
            self._est_ema = None
            # draft/teacher per-token decode cost ratio for the rung
            # picker: the decoder layer-count ratio (ngram drafts are free)
            if draft_cost is not None:
                self._draft_cost = float(draft_cost)
            elif self.ngram:
                self._draft_cost = 0.0
            else:
                self._draft_cost = (self.assistant[1].decoder_layers
                                    / max(pipe.cfg.decoder_layers, 1))
            self.stats.update({"gamma_current": g0, "gamma_raises": 0,
                               "gamma_drops": 0})
        self._crashed: Optional[str] = None
        self._stream = Lockstep(
            {"dispatch": lambda fields: self._dispatch(
                [_Request(**f) for f in fields])},
            device=resolve_device(pipe.device),
            mesh=getattr(pipe, "mesh", None))

    # ------------------------------------------------------------- lifecycle
    @property
    def leader(self) -> bool:
        """True on the rank that serves (every rank without a mesh)."""
        return self._stream.leader or not self._stream.distributed

    def follow(self) -> None:
        """A follower's part: dispatch the leader's micro-batches until it
        stops (raises if one fails here)."""
        self._stream.follow()

    def start(self) -> "BatchingTranscriber":
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="batching-transcriber")
        self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=30)
            self._worker = None
        self._stream.stop()

    # --------------------------------------------------------------- client
    def submit(self, audio, language: Optional[str] = None,
               task: str = "transcribe", return_timestamps: bool = False,
               timeout: Optional[float] = None,
               max_new_tokens: Optional[int] = None,
               mode: str = "chunked", num_beams: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None) -> Dict[str, Any]:
        """Blocking transcription of one audio (any ``load_audio`` source).

        ``max_new_tokens`` caps this request's output (clamped to the server
        budget); greedy and sampled decoding have the prefix property, so a
        short-form group serves it by truncation.  ``mode="sequential"``
        runs the sliding-window ladder; ``num_beams > 1`` beam search (the
        budget is part of the group key: beams are not prefix-stable)."""
        wav = load_audio(audio, self.pipe.cfg.sampling_rate)
        ts = _coerce_timestamps(return_timestamps)
        beams = _coerce_beams(num_beams)
        md = _coerce_mode(mode, ts)
        temp, k = _coerce_sampling(temperature, top_k, beams, md, ts)
        if temp > 0 and len(wav) > self.pipe.cfg.n_samples:
            raise ValueError("sampling (temperature > 0) applies to single-"
                             "window (<=30 s) requests; long-form decoding "
                             "is greedy/beam per the reference protocol")
        language = language or self.default_language
        check_prompt(self.pipe.tokenizer, language, task)
        req = _Request(wav, language, task,
                       ts, max_new_tokens, mode=md, num_beams=beams,
                       temperature=temp, top_k=k,
                       seed=None if seed is None else int(seed))
        self._enqueue(req)
        if not req.done.wait(timeout):
            req.cancelled = True  # worker skips it; nobody reads the result
            self._bump("cancelled")
            raise TimeoutError("transcription timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def _enqueue(self, req: _Request) -> None:
        if self._crashed is not None:
            raise RuntimeError(self._crashed)
        # qsize is approximate under concurrency — fine for load shedding
        if self._q.qsize() >= self.max_queue:
            self._bump("rejected")
            raise ServerOverloadedError(
                f"request backlog at max_queue={self.max_queue}")
        self._q.put(req)

    def snapshot(self) -> Dict[str, Any]:
        """Live observability view (GET /v1/stats)."""
        snap = {"scheduler": "microbatch",
                "queue_depth": self._q.qsize(),
                "max_queue": self.max_queue,
                "batch_size": self.batch_size,
                "stats": dict(self.stats)}
        if self.assistant is not None or self.ngram:
            snap["speculative"] = {
                "method": "ngram" if self.ngram else "draft",
                "gamma": self.gamma,
                "adaptive": self.adaptive_gamma,
                "acceptance_rate": round(
                    self.stats["accepted"] / self.stats["drafted"], 3)
                if self.stats["drafted"] else None}
            if self.adaptive_gamma:
                snap["speculative"]["gamma_current"] = \
                    self.stats["gamma_current"]
                snap["speculative"]["draft_cost"] = self._draft_cost
        return snap

    def _update_gamma_controller(self, drafted: int, accepted: int,
                                 gamma: int) -> None:
        """Walk the gamma ladder on the measured per-draft acceptance: once
        the window holds 16 * gamma drafts, recover the per-draft
        acceptance (:func:`estimate_accept`), smooth it with an EMA over
        windows, and move one rung toward the cost-optimal gamma when it is
        predicted > 2% better (:func:`_gamma_step`).  Worker-thread-owned;
        the next batch uses the new rung."""
        self._ctrl_d += drafted
        self._ctrl_a += accepted
        if self._ctrl_d < 16 * gamma:
            return
        est = estimate_accept(self._ctrl_a / self._ctrl_d, gamma)
        self._ctrl_d = 0
        self._ctrl_a = 0
        self._est_ema = est if self._est_ema is None else (
            0.5 * self._est_ema + 0.5 * est)
        with self._stats_lock:
            self._gamma_idx = _gamma_step(self._est_ema, self._gamma_levels,
                                          self._gamma_idx, self._draft_cost,
                                          self.stats)
            self.stats["gamma_current"] = self._gamma_levels[self._gamma_idx]

    def submit_stream(self, audio, **kw):
        """Streaming facade for API parity with the continuous-batching
        transcriber: whole-batch decoding has no intermediate state to
        stream, so this yields one final result.

        A plain function (NOT a generator): admission errors — backlog full,
        deadline, bad arguments — raise HERE, before the HTTP layer has
        committed a 200 + ndjson headers, so they map to proper status
        codes (503/504/400) exactly like the blocking path."""
        result = self.submit(audio, **kw)

        def _gen():
            yield {**result, "final": True}

        return _gen()

    # --------------------------------------------------------------- worker
    def _run(self) -> None:
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 — only under a mesh
            logger.exception("micro-batch worker stopped")
            self._crashed = f"worker stopped: {type(e).__name__}: {e}"
            while True:
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    return
                if r is not None and not r.done.is_set():
                    r.error = self._crashed
                    r.done.set()

    def _run_inner(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            batch = [req]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._publish_dispatch(batch)
                    return
                batch.append(nxt)
            self._publish_dispatch(batch)

    def _publish_dispatch(self, batch: List[_Request]) -> None:
        """Dispatch a micro-batch on every rank (the followers rebuild its
        requests from their published fields)."""
        batch = [r for r in batch if not r.cancelled]
        if batch:
            self._stream.call(
                "dispatch", [{k: getattr(r, k) for k in _FIELDS}
                             for r in batch],
                run=lambda: self._dispatch(batch))

    def _failed(self, reqs, e: Exception, what: str) -> None:
        """Record a failed group on its requests.  Under a mesh an error
        that is not the request's own (``REQUEST_ERRORS``, raised alike on
        every rank) is raised again, so that the command stream closes and
        the worker ends."""
        logger.exception(what)
        for r in reqs:
            r.error = f"{type(e).__name__}: {e}"
        if self._stream.distributed and not isinstance(e, REQUEST_ERRORS):
            raise e

    def _dispatch(self, batch: List[_Request]) -> None:
        # drop requests whose client stopped waiting (timed out /
        # disconnected) — device time spent on them is pure waste
        batch = [r for r in batch if not r.cancelled]
        if not batch:
            return
        self._bump("requests", len(batch))
        n_samples = self.pipe.cfg.n_samples
        groups: Dict[Any, List[_Request]] = {}
        wts_groups: Dict[Any, List[_Request]] = {}
        for r in batch:
            if r.mode == "sequential":
                self._bump("sequential")
                self._run_one_sequential(r)
                continue
            if (r.return_timestamps == "word" and r.num_beams == 1
                    and len(r.audio) <= n_samples):
                # single-window word timestamps micro-batch through the
                # shared alignment pass (a burst costs ceil(K/batch)
                # device calls, not K)
                self._bump("word_ts")
                max_new = _budget(r.max_new_tokens, self.max_new_tokens)
                wts_groups.setdefault((r.task, max_new), []).append(r)
                continue
            if len(r.audio) > n_samples or r.return_timestamps == "word":
                # long-form (the chunked pipeline batches this file's own
                # windows) and word-ts x beam take the whole pipeline
                self._bump("long_form")
                if r.return_timestamps == "word":
                    self._bump("word_ts")
                self._run_one_pipeline(r)
                continue
            # beam outputs are not prefix-stable, so a beam request's budget
            # is part of its group, not applied by truncation
            beam_budget = None
            if r.num_beams > 1:
                beam_budget = _budget(r.max_new_tokens, self.max_new_tokens)
            # sampled requests group by their exact sampling config (top_k
            # and temperature are batch-wide, the generator is shared by the
            # group); sampled sequences are prefix-stable too, so budgets
            # truncate like greedy
            sample_key = ((round(r.temperature, 6), r.top_k, r.seed)
                          if r.temperature > 0 else None)
            groups.setdefault((r.language, r.task, r.return_timestamps,
                               r.num_beams, beam_budget, sample_key),
                              []).append(r)
        for (task, max_new), reqs in wts_groups.items():
            self._run_word_ts_group(reqs, task, max_new)
        for (lang, task, ts, beams, budget, sample), reqs in groups.items():
            self._run_short_group(reqs, lang, task, ts, beams, budget,
                                  sample)

    def _run_word_ts_group(self, reqs: List[_Request], task: str,
                           max_new: int) -> None:
        try:
            results = self.pipe.transcribe_words_batch(
                [r.audio for r in reqs],
                languages=[r.language for r in reqs],
                task=task, max_new_tokens=max_new)
            self._bump("word_ts_batches")
            self._bump_max("word_ts_max_batch", len(reqs))
            for r, res in zip(reqs, results):
                r.result = res
        except Exception as e:  # noqa: BLE001 — the worker must keep serving
            self._failed(reqs, e, "word-timestamp batch failed")
        finally:
            for r in reqs:
                r.done.set()

    def _run_one_sequential(self, r: _Request) -> None:
        try:
            r.result = self._sequential.run(r.audio, r.language, r.task,
                                            r.max_new_tokens, r.num_beams)
        except Exception as e:  # noqa: BLE001 — the worker must keep serving
            self._failed([r], e, "sequential-path request failed")
        finally:
            r.done.set()

    def _run_one_pipeline(self, r: _Request) -> None:
        try:
            gk = ({"num_beams": r.num_beams} if r.num_beams > 1 else None)
            r.result = self.pipe(
                r.audio, language=r.language, task=r.task,
                return_timestamps=r.return_timestamps,
                max_new_tokens=_budget(r.max_new_tokens, self.max_new_tokens),
                generate_kwargs=gk)
        except Exception as e:  # noqa: BLE001 — the worker must keep serving
            self._failed([r], e, "pipeline-path request failed")
        finally:
            r.done.set()

    def _speculate(self, mels, enc, prompts, opts, gamma: int):
        """Speculative greedy decode of one group (draft or n-gram) in the
        pipeline's graphs on the card; the draft shares the teacher's
        encoder states when the widths match, and each model's cross K/V
        are projected inside the loop's prefill."""
        pipe, cfg = self.pipe, self.pipe.cfg
        dec = pipe.params["decoder"]
        if self.ngram:
            return ngram_speculative_generate_batched(
                dec, cfg, enc, prompts, opts, gamma=gamma,
                max_ngram=self.max_ngram, dtype=pipe.dtype,
                graphs=pipe.graphs)
        d_params, d_cfg = self.assistant
        d_enc = (enc if d_cfg.d_model == cfg.d_model
                 else encode(d_params["encoder"], d_cfg, mels,
                             dtype=pipe.dtype))
        return speculative_generate_batched(
            dec, cfg, d_params["decoder"], d_cfg, enc, d_enc, prompts, opts,
            gamma=gamma, dtype=pipe.dtype,
            synthetic_acceptance=self.synthetic_acceptance,
            graphs=pipe.graphs)

    @torch.no_grad()
    def _run_short_group(self, reqs: List[_Request], language, task: str,
                         return_timestamps: bool, num_beams: int = 1,
                         beam_budget: Optional[int] = None,
                         sample=None) -> None:
        """One batch of up to batch_size single-window requests."""
        pipe, cfg, tok = self.pipe, self.pipe.cfg, self.pipe.tokenizer
        try:
            wavs = np.zeros((len(reqs), cfg.n_samples), np.float32)
            for j, r in enumerate(reqs):
                wavs[j, :len(r.audio)] = r.audio
            mels = compute_mel(wavs, cfg, device=pipe.device).to(pipe.dtype)
            if language is None and len(tok.lang_to_id) > 1:
                language = pipe.detect_language(mels[:1])[0]
            prompt = tok.prompt_ids(language=language, task=task,
                                    no_timestamps=not return_timestamps)
            prompts = torch.tensor([prompt] * len(reqs), dtype=torch.long,
                                   device=pipe.device)
            dec = pipe.params["decoder"]
            opts = GenerationOptions.from_config(
                cfg, max_new_tokens=beam_budget or self.max_new_tokens,
                return_timestamps=return_timestamps,
                no_speech_token_id=tok.no_speech)
            speculate = (num_beams == 1 and sample is None
                         and (self.assistant is not None or self.ngram))
            if sample is not None:
                temp, top_k, seed = sample
                opts = GenerationOptions.from_config(
                    cfg, max_new_tokens=self.max_new_tokens,
                    return_timestamps=return_timestamps,
                    no_speech_token_id=tok.no_speech,
                    do_sample=True, top_k=top_k)
                if seed is None:
                    seed = self._seeds.take()
            if speculate:
                g = (self._gamma_levels[self._gamma_idx]
                     if self.adaptive_gamma else self.gamma)

            def run_rows(rows):
                """The group's rows ``rows`` (this data rank's under a
                mesh): encode, then decode by the group's method."""
                enc = encode(pipe.params["encoder"], cfg, mels[rows],
                             dtype=pipe.dtype)
                counts = (None, None)
                # every decode projects the cross K/V inside its graphs on
                # the card
                if num_beams > 1:
                    out = beam_search(dec, cfg, enc, prompts[rows], opts,
                                      num_beams=num_beams, length_penalty=1.0,
                                      dtype=pipe.dtype, graphs=pipe.graphs)
                elif sample is not None:
                    gen = torch.Generator(device=pipe.device).manual_seed(seed)
                    out = generate(dec, cfg, enc, prompts[rows], opts,
                                   temperature=float(temp), generator=gen,
                                   dtype=pipe.dtype, graphs=pipe.graphs)
                elif speculate:
                    # token-identical to the greedy path; faster whenever
                    # the acceptance earns back the draft's cost
                    out = self._speculate(mels[rows], enc, prompts[rows],
                                          opts, g)
                    counts = (out.drafted.cpu().numpy(),
                              out.accepted.cpu().numpy())
                else:
                    out = generate(dec, cfg, enc, prompts[rows], opts,
                                   dtype=pipe.dtype, graphs=pipe.graphs)
                return (out.sequences.cpu().numpy(),
                        out.seq_len.cpu().numpy(), *counts)

            # a sampled group is not split over 'data': its rows draw from
            # one generator over the whole group, as in one process
            seqs, lens, drafted, accepted = decode_over_data(
                None if sample is not None else getattr(pipe, "mesh", None),
                len(reqs), run_rows)
            if sample is not None:
                self._bump("sampled", len(reqs))
            if speculate:
                d, a = int(drafted.sum()), int(accepted.sum())
                self._bump("speculative_batches")
                self._bump("drafted", d)
                self._bump("accepted", a)
                if self.adaptive_gamma:
                    self._update_gamma_controller(d, a, g)

            self._bump("batches")
            self._bump_max("max_batch", len(reqs))
            for j, r in enumerate(reqs):
                cut = int(lens[j])
                if r.max_new_tokens is not None and num_beams == 1:
                    # greedy and sampled prefix property only; beam budgets
                    # are part of the group (beam_budget)
                    cut = min(cut, len(prompt) + max(int(r.max_new_tokens), 0))
                r.result = _short_result(tok, seqs[j][:cut].tolist(),
                                         return_timestamps)
        except Exception as e:  # noqa: BLE001 — the worker must keep serving
            self._failed(reqs, e, "batched request group failed")
        finally:
            for r in reqs:
                r.done.set()


# ---------------------------------------------------------------- HTTP layer
def make_http_server(transcriber, host: str = "0.0.0.0",
                     port: int = 8000, max_body_mb: float = 100.0):
    """ThreadingHTTPServer: POST /v1/transcribe (WAV body; query params
    ``language``, ``task``, ``timestamps=1`` (or ``word``),
    ``mode=sequential`` — long-form sliding-window algorithm,
    ``beams=N`` — beam search, ``temperature=T``/``top_k=K``/``seed=S`` —
    sampling (temperature 0 = greedy), ``max_tokens=N``, ``timeout_s=S`` —
    server-side deadline, ``stream=1`` — ndjson partials), GET /healthz, and
    GET /v1/stats (live queue/lane/counters snapshot).  Works over any
    transcriber with the ``submit()`` contract (micro-batching or
    continuous-batching).  Error mapping: backlog full -> 503 +
    Retry-After (load shedding), deadline exceeded -> 504 (the request is
    cancelled), bodies over ``max_body_mb`` -> 413 before being read, bad
    arguments -> 400, unknown paths -> 404."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    max_body = int(max_body_mb * 1e6)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "checkpoint": getattr(transcriber.pipe, "_checkpoint",
                                          None),
                    "batch_size": transcriber.batch_size,
                    "stats": dict(transcriber.stats)})
            elif path == "/v1/stats":
                self._json(200, transcriber.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path not in ("/v1/transcribe", "/transcribe"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > max_body:
                    # drain in bounded chunks (never buffered) before
                    # responding — answering mid-upload resets the client's
                    # send and it sees a broken pipe instead of the 413
                    remaining = length
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 16))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._json(413, {"error": f"body {length} bytes exceeds "
                                              f"limit {max_body}"})
                    return
                body = self.rfile.read(length)
                q = parse_qs(url.query)
                max_tok = (q.get("max_tokens") or [None])[0]
                timeout_s = (q.get("timeout_s") or [None])[0]
                ts = (q.get("timestamps") or ["0"])[0]
                kw = dict(
                    language=(q.get("language") or [None])[0],
                    task=(q.get("task") or ["transcribe"])[0],
                    # "word" -> word-level spans via the cross-attention
                    # alignment pass; "1"/"true" -> segment timestamps
                    return_timestamps=("word" if ts == "word"
                                       else ts in ("1", "true")),
                    max_new_tokens=int(max_tok) if max_tok else None,
                    timeout=float(timeout_s) if timeout_s else None,
                    mode=(q.get("mode") or ["chunked"])[0],
                    num_beams=int((q.get("beams") or ["1"])[0]),
                    temperature=float((q.get("temperature") or ["0"])[0]),
                    top_k=int((q.get("top_k") or ["0"])[0]),
                    seed=(int((q.get("seed") or [None])[0])
                          if q.get("seed") else None))
                t0 = time.monotonic()
                if (q.get("stream") or ["0"])[0] in ("1", "true"):
                    # admission (audio decode, backlog bound, argument
                    # validation) runs BEFORE the 200 is committed:
                    # submit_stream enqueues eagerly and returns the
                    # generator, so overload maps to 503 + Retry-After
                    gen = transcriber.submit_stream(body, **kw)
                    # newline-delimited JSON, close-delimited (HTTP/1.0):
                    # one partial line per decode block (continuous
                    # scheduler), then the final result with final=true
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    try:
                        for item in gen:
                            if item.get("final"):
                                item = dict(item)
                                item["latency_ms"] = round(
                                    (time.monotonic() - t0) * 1e3, 1)
                            self.wfile.write(json.dumps(item).encode()
                                             + b"\n")
                            self.wfile.flush()
                    except TimeoutError:
                        # deadline expired mid-stream (TimeoutError is an
                        # OSError subclass — this branch must come first):
                        # the client is still connected; tell it before
                        # closing
                        gen.close()
                        logger.info("streaming request deadline exceeded")
                        try:
                            self.wfile.write(
                                b'{"error": "deadline exceeded"}\n')
                        except OSError:
                            pass  # client already gone
                    except OSError:
                        # client disconnected mid-stream: closing the
                        # generator cancels the in-flight request so the
                        # engine reclaims its lane
                        gen.close()
                        logger.info("streaming client disconnected")
                    except Exception:  # noqa: BLE001 — headers already sent:
                        # emit an error line and close (no second status line)
                        gen.close()
                        logger.exception("streaming request failed")
                        try:
                            self.wfile.write(b'{"error": "stream aborted"}\n')
                        except OSError:
                            pass  # client already gone
                    return
                result = dict(transcriber.submit(body, **kw))
                result["latency_ms"] = round(
                    (time.monotonic() - t0) * 1e3, 1)
                self._json(200, result)
            except ServerOverloadedError as e:
                self._json(503, {"error": str(e)},
                           headers={"Retry-After": "1"})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a bad request is a 400
                logger.exception("request failed")
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet; logging owns output
            logger.debug("http: " + fmt, *args)

    return ThreadingHTTPServer((host, port), Handler)
