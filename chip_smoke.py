#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``distil_whisper_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and prints the build time and the
   ptxas resource report.
2. Holds every kernel against its plain PyTorch version on the card at the
   shapes of the main path (TF32 off), and times kernel, plain version, the
   bound of the card and one PyTorch library call as a yardstick (CUDA
   events around back-to-back launches; for decode attention, around the
   replay of a CUDA graph of 20 calls, since at tens of microseconds the
   host's launch work would be timed).  Encoder attention is held and
   timed both contiguous and as the main path's [B, H, T, 64] views of
   [B, T, 1280] projections, held as the tensor-parallel path's views of
   [B, T, 640] and [B, T, 320] projections, and on ragged shapes (T 1536
   with 1500 live keys; B 3, H 5, T 200, 77 live keys); the int8 MLP also
   at one window (1500 rows) and at the gate's 300 rows; decode attention
   also at T 32 and 8192 and with one mask row for the batch.  Each row
   carries its source's ptxas report.
3. Drives the main path at the full width of distil-large-v3 (random weights
   from a seed, bf16): a ``WhisperPipeline`` transcribes a batch of 16
   synthetic 30 s windows short-form (greedy, 128-token budget), again for
   determinism, then one ~70 s file chunked with segment timestamps.  Kernel
   launch counts are reset before and read after the short-form run; every
   kernel of the path must have launched.  The result is checked: finite
   encoder states of the right shape that agree with the einsum encoder, equal
   tokens on both runs.
4. Drives the int8 path the same way: the same weights with all five
   ``quantize_*`` flags (W8A8 encoder and decoder, int8 self-KV and cross
   K/V, int8 logits).  Launches must be log-mel 1, encoder attention 32,
   int8 MLP 32 (one per encoder layer) and int8 decode attention 0 (unwired,
   as in the JAX package); tokens equal on both runs; the int8 encoder close
   to the bf16 encoder.
5. Drives the long-form paths on the main path's weights (beam search,
   word timestamps, the sequential ladder, the int8 beam run), each path's
   launches counted from 0 around it.
6. Drives the compiled decode loops (``compiled_decode_path``): ``generate``
   replaying CUDA graphs against the plain step loop (``generate_eager``),
   bit for bit, on distil-large-v3 (16 windows, 128 new tokens) in bf16,
   with the five int8 flags, with segment timestamps and sampled under one
   seed, the block length swept over ``GRAPH_BLOCK_SWEEP``; beam search
   on graphs against ``beam_search_eager`` at 16 windows x 5 beams (plain,
   timestamps, the ladder's padded prompts, the int8 lane, an early stop,
   one beam against ``generate``, the same block sweep); the pipeline
   and the sequential ladder (2 files) with the plain loop patched in
   against their graphs (texts and segments equal, kernel launches equal);
   the continuous engine's greedy and sampling blocks, captured against
   eager, over one admission sequence (packed vectors equal); the large-v3
   teacher at 64 tokens (run by ``speculative_path`` on its teacher).  Each
   case prints wall and device ms a step and the idle share before and
   after, host syncs a call, captures, replays, capture seconds and the
   graph pool's bytes.
7. Drives serving (``serving_path``) on the same weights: the continuous
   engine (16 lanes, block 16) and the micro-batch scheduler (batch 16),
   server budget 96, each given 38 concurrent requests — 32 single 30 s
   windows with budgets drawn from 24-96 (8 of them sampled), 2 files of
   70 s and a burst of 4 word-timestamp requests — after a warm-up; launches
   counted from 0 around each run (mel at least one a request on the
   engine and one a device group on the micro-batch scheduler, encoder
   attention 32 an encode), admitted windows 38, at most 16 lanes in
   flight, every sampled request reproduced under its seed; the same on
   the int8 flags (int8 MLP 32 an encode); an HTTP drive over loopback
   (healthz, POST, stream=1, /v1/stats); the engine step loop's device
   idle share and host syncs a block; the near-tie report of every
   greedy request whose text parts from the pipeline's.
8. Drives speculative decoding (``speculative_path``) with large-v3 at full
   width as the teacher (32 + 32 layers, random bf16 weights from seed 0)
   and distil-large-v3's 2-layer decoder as its draft (seed 1, on the
   teacher's encoder states): the teacher's plain greedy and draft
   speculation through ``WhisperPipeline`` on the 16 windows (launches
   log-mel 1, encoder attention 32), then the decode loops alone, each
   on CUDA graphs against the plain loop (``speculate_eager``) bit for
   bit, with wall ms a round and a token (graph and plain), device ms and
   idle share, host syncs, captures and pool bytes: the draft (rounds,
   acceptance, the share of tokens equal to greedy's in bf16, the near-tie
   report of the rows that part), ``synthetic_acceptance`` 0.8 against the
   prefix law and n-gram lookup with ``synthetic_period`` 16 (both
   synthetic tokens); the rounds a block swept over ``SPEC_ROUNDS_SWEEP``;
   the sequential t = 0 rung with the draft on 2 long files against the
   plain rung; the continuous engine's speculative blocks on graphs
   against its eager rounds (packed vectors equal); then the engine
   serving large-v3 (16 requests, 64-token budgets, 16 lanes): plain, the
   draft under ``synthetic_acceptance`` 0.8 and n-gram lookup with
   ``synthetic_period`` 16.
9. A small model on the card agrees with the CPU: fp32 tokens identical,
   bf16 fused encoder close; the same model with the int8 flags (fp32 tokens
   and prefill logits against the CPU; the bf16 int8 encoder, through both
   encoder kernels, close to the fp32 CPU int8 encoder); beam, sequential
   and word-timestamp results; fp32 draft and n-gram speculation on the
   card equal to the CPU greedy tokens, and the speculative sequential
   t = 0 rung equal to the plain CPU rung; the continuous engine (greedy,
   draft and n-gram lanes) and the micro-batch scheduler on the card equal
   to the CPU pipeline.
10. Drives distillation training (``training_path``) through the port's
   CLIs at full width and cut depth: a random teacher of large-v3's widths
   and ``TEACHER_LAYERS`` encoder and decoder layers (seed 0, bf16; the
   training, recipe and multi-rank phases spend their time loading, saving
   and all-reducing weights, which scales with depth) written by
   ``save_pretrained``, ``create_student_model`` to a student of its
   encoder and 2 decoder layers, a JSONL manifest of 48 synthetic
   clips of 5-30 s, ``run_distillation`` at half_mixed with the inference
   teacher (batch 16, labels up to 128 tokens, 4 steps, warmup 2,
   checkpoints every 2 steps, one profiled step, one eval of 16 rows at 32
   new tokens: step times, tokens a second, losses, peak memory, the
   device idle share), one step with the train teacher (step 1's CE and
   KL within bf16 rounding of the inference teacher's), 2 steps with the
   int8 teacher, a resume from checkpoint-2 (step 3's loss equal to the
   uninterrupted run's), ``run_finetuning`` of the distilled checkpoint with
   the encoder unfrozen through the encoder-attention kernel and its
   backward kernel (batch 4, remat; one backward launch a layer a step),
   and ``run_eval`` of the distilled checkpoint; launches counted from 0
   around each run (log-mel, encoder attention, its backward and the int8
   MLP inside ``run_distillation``).  The kernel rows include the
   encoder-attention backward kernel (against its plain version, the
   recompute it replaces and the fp32 gradient, at (2, 20, 1500, 64) bf16,
   as views of [2, 1500, 1280], [2, 1500, 640] and [2, 1500, 320]
   projections and on (3, 5, 200, 64)/77 and (2, 3, 65, 64)/64; two calls
   equal bit for bit;
   timed beside the recompute, the plain version and SDPA's backward).
11. Drives the rest of the recipe (``recipe_path``) through the port's
   CLIs: the random teacher of ``training_path`` pseudo-labels 32 clips of
   two speakers (batch 16, 64 new tokens, two featurizer workers, WER, a
   publish mirror; launches log-mel 1 and encoder attention one a layer a
   batch),
   then one batch with all five int8 flags at 32 tokens (int8 MLP one an
   encoder layer a batch); ``run_distillation --streaming
   --quantize_student w8a8`` trains the student of ``training_path`` on
   that manifest (4 steps of 16,
   half_mixed, beside the same run without QAT for the step time);
   ``run_finetuning --quantize_student w8a8`` with the unfrozen encoder
   (batch 4, remat); ``convert_checkpoint_to_hf`` exports the QAT
   checkpoint, reloaded bit for bit; its fake-quant decoder agrees with
   its int8 decoder projection by projection; the int8 pipeline serves it
   on 16 windows; a tiny fp32 model pseudo-labels on the card as on the
   CPU.
12. Drives data-parallel multi-GPU (``multigpu_path``, after
   ``training_path``, on its teacher, student and manifests) over
   ``max(2, cards)`` spawned ranks (NCCL, a card each; on one card two ranks
   share it over gloo), each running the CLIs with ``--distributed``:
   ``run_distillation`` with the inference and the int8 teacher (2 steps of
   16 rows a rank), ``convert_checkpoint_to_hf``, ``run_eval`` on 16 clips,
   ``run_pseudo_labelling`` of 48 clips at 32 new tokens and the small fp32
   model's eval and pseudo-labelling; launches counted per rank around each
   run (log-mel,
   encoder attention, the int8 MLP in the int8-teacher run).  Here: the
   step-1 losses against one process on the concatenated global batch, the
   one-rank step time and pseudo-labelling rate, the small model's WER and
   pseudo-labels equal to one rank's, ``dryrun_multigpu`` on the card
   (the three multi-rank phases' dry runs run together before
   ``training_path``: ``run_dryruns``).
   Ranks print world size and backend, per-rank step and all-reduce times,
   and summed eval and pseudo-labelling rates in the phase line.
13. Drives tensor parallelism (``tensor_parallel_path``, after
   ``multigpu_path``) over ``max(2, cards)`` spawned ranks on a
   ``(ranks / 2, 2)`` mesh (two ranks sharing one card over gloo; on four
   cards a (2, 2) mesh over NCCL, plus tp 4): the bf16, fp32 and int8
   distil-large-v3 pipelines (encoder cut to ``TP_ENCODER_LAYERS`` layers)
   with ``mesh=`` on 4 windows against one rank's (launches a rank: log-mel
   1, encoder attention and the int8 MLP in its partial mode one a layer;
   texts equal, each parting with its near-tie
   report against the drift of one rank's other numerics (its cached
   step over its einsum encoder's states); the sharded encode against
   one rank's, relative L2, under ``TP_ENCODE_REL_L2``; encode and
   all-reduce times), the partial mode against its plain version bit for
   bit and summed against the unsharded kernel,
   ``run_distillation --distributed --model_parallel 2`` (step-1 loss
   against one process), the small fp32 model's greedy and n-gram tokens
   equal one rank's, ``dryrun_multigpu(world, model_parallel=2)``.
14. Prints each phase's seconds (``{"phase": "seconds", ...}``), the
   kernels line (launches from the int8 path's short-form run, the backward
   kernel's from the fine-tuning run, and per path in
   ``launches_by_path``), the card's name and power limit, and last the
   result line ``{"ok": true, "device": {...}}``.

Any failed phase raises: the script then exits non-zero without a result
line.  It also exits non-zero without a GPU, and outside the repository.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW = 3.35e12          # H100 SXM HBM3, bytes/s
FP32_CUDA_CORE = 67e12    # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_TENSOR = 989e12      # H100 SXM dense bf16 tensor cores, FLOP/s
INT8_TENSOR = 1979e12     # H100 SXM dense int8 tensor cores, OP/s
INT8_FLAGS = dict(quantize_encoder=True, quantize_decoder=True,
                  quantize_lm_head=True, quantize_cross_kv=True,
                  quantize_self_kv=True)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
                     if "phase" in obj else obj), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2, rounds: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps`` calls
    launched back to back, so that the host's launch work overlaps the
    device's, over ``reps``; the median of ``rounds`` such runs, after
    warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cuda_graph_ms(fn, reps: int = 20, rounds: int = 3, setup=None) -> float:
    """Device time of one call of ``fn`` without the host's launch work:
    ``reps`` calls captured in one CUDA graph, the graph replayed between
    CUDA events, over ``reps``; the median of ``rounds`` replays, after
    warm-up.  For kernels of tens of microseconds, where back-to-back
    launches from Python would time the host.  Everything runs on a side
    stream; with ``setup``, ``fn = setup()`` runs there first, so that an
    autograd graph recorded by ``setup`` runs its backward (``fn``) on the
    capturing stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if setup is not None:
            fn = setup()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    torch.cuda.current_stream().wait_stream(side)
    del graph, fn
    return statistics.median(times)


def host_us(fn, calls: int = 20, rounds: int = 5) -> float:
    """Host microseconds a call of ``fn``: a CPU clock around ``calls``
    calls with their device work queued (not synchronised), the median of
    ``rounds`` after warm-up."""
    import torch
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / MEM_BW * 1e3, n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_tokenizer(tmp: Path):
    """A byte-level tokenizer with the large-v3 special-token layout
    (<|notimestamps|> 50364, timestamps from 50365): no download needed.
    The ids past the 256 bytes decode to " w<id>", a word each (a leading
    "Ġ" is the byte-level space), so that word timestamps see many words."""
    from distil_whisper_tpu_torch.tokenizer import LANGUAGES, WhisperTokenizer
    from distil_whisper_tpu_torch.tokenizer.bpe import bytes_to_unicode
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units)}
    vocab.update({f"Ġw{i}": i for i in range(len(units), 50257)})
    added = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258}
    added.update({f"<|{code}|>": 50259 + i for i, code in enumerate(LANGUAGES)})
    nxt = 50259 + len(LANGUAGES)
    for name in ("translate", "transcribe", "startoflm", "startofprev",
                 "nospeech", "notimestamps"):
        added[f"<|{name}|>"] = nxt
        nxt += 1
    (tmp / "vocab.json").write_text(json.dumps(vocab))
    (tmp / "merges.txt").write_text("#version: 0.2\n")
    (tmp / "added_tokens.json").write_text(json.dumps(added))
    return WhisperTokenizer.from_pretrained(str(tmp))


def synthetic_audio(n: int, seconds: float, seed: int):
    """``n`` clips of tones gliding under noise with a syllable-like envelope."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    clips = []
    for _ in range(n):
        f0 = rng.uniform(90, 250)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
        x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h
                for h in range(1, 6))
        clips.append((0.1 * env * x + 0.01 * rng.standard_normal(t.shape))
                     .astype(np.float32))
    return clips


# Where two greedy decodes of the same windows part, and whether the
# reference step there was a near-tie.  Two decodes of one model that round
# differently (bf16 at other batch sizes, the einsum verify window against
# the single-token step, a tensor-parallel sum against one product) may
# choose different tokens only where the reference's top two logits are
# about equal.  For each row whose tokens part from the reference row,
# near_tie_report finds the first differing position and the gap between
# the top two logits of the reference step that chose the token there (a
# teacher-forced pass of the reference tokens), and calls the parting a
# near-tie when the gap is under NEAR_TIE (the int8 tests' 5e-3).  Its
# yardstick of rounding (``drift_logits``) is a second numerics of the
# *reference* model that varies what the decode under test varies (the
# decoder's path, the encoder's), never the decode under test itself
# (whose drift grows with any fault of its own): the largest difference
# of its logits from the teacher-forced pass there is ``logit_drift``, and
# a parting whose gap is under it is explained by rounding; one above it
# points at a fault of the decode that parted.
NEAR_TIE = 5e-3


def first_parting(ref, test, start=0):
    """The first position >= ``start`` where the rows differ (a row that
    ends first differs where it ends), or -1 where they are equal."""
    n = min(len(ref), len(test))
    for j in range(start, n):
        if ref[j] != test[j]:
            return j
    return -1 if len(ref) == len(test) else n


def near_tie_report(dec_params, cfg, cross, ref_rows, test_rows, prompt_len,
                    dtype=None, tol=NEAR_TIE, drift_logits=None,
                    test_logits=None):
    """The parting rows of ``test_rows`` against ``ref_rows`` (token lists
    that start with a prompt of ``prompt_len``; row ``b`` decoded from
    the windows whose cross K/V are ``cross``'s row ``b``), each with its
    first differing position, both tokens, and the top-two gap of the
    reference's logits there (``dec_params``, a teacher-forced pass).
    ``all_near_ties`` is true when every parting is under ``tol``
    (vacuously when no row parts).  ``drift_logits(b, prefix)``: the
    reference model's fp32 logits [V] after the token list ``prefix`` of
    row ``b`` by another path (``cached_step_logits``); each parting then
    carries ``logit_drift`` and ``within_drift`` (its gap under the drift),
    summed up in ``all_within_drift``.  ``test_logits``, the same for the
    decode under test, adds its distance from the reference there
    (``test_drift``) and its own top-two gap for the two tokens
    (``test_top2_gap``).  Every rank of a model group must call it alike
    when either decode is sharded."""
    import torch
    from distil_whisper_tpu_torch.models.whisper import decode
    dtype = torch.float32 if dtype is None else dtype
    parts = []
    for b, (r, t) in enumerate(zip(ref_rows, test_rows)):
        j = first_parting(r, t, prompt_len)
        if 0 < j < len(r):
            parts.append((b, j))
    rows = []
    with torch.no_grad():
        if parts:
            idx = torch.tensor([b for b, _ in parts])
            width = max(j for _, j in parts)
            device = next(iter(cross.values())).device
            # the reference up to each parting (causal: what follows it
            # changes nothing there), padded
            tokens = torch.tensor([ref_rows[b][:j] + [0] * (width - j)
                                   for b, j in parts], device=device)
            sub = {k: v[:, idx.to(v.device)] for k, v in cross.items()}
            logits, _ = decode(dec_params, cfg, tokens, cross=sub,
                               dtype=dtype)
        for k, (b, j) in enumerate(parts):
            ref_logits = logits[k, j - 1].float()
            top = torch.topk(ref_logits, 2).values
            gap = float(top[0] - top[1])
            row = {"row": b, "position": j, "ref_token": int(ref_rows[b][j]),
                   "test_token": (int(test_rows[b][j])
                                  if j < len(test_rows[b]) else None),
                   "top2_gap": gap, "near_tie": gap < tol}
            prefix = ref_rows[b][:j]
            if drift_logits is not None:
                other = drift_logits(b, prefix).float().to(ref_logits.device)
                row["logit_drift"] = float((other - ref_logits).abs().max())
                row["within_drift"] = gap <= row["logit_drift"]
            if test_logits is not None:
                other = test_logits(b, prefix).float().to(ref_logits.device)
                row["test_drift"] = float((other - ref_logits).abs().max())
                if row["test_token"] is not None:
                    row["test_top2_gap"] = float(other[row["ref_token"]]
                                                 - other[row["test_token"]])
            rows.append(row)
    out = {"rows": len(ref_rows), "parting": len(rows), "tol": tol,
           "all_near_ties": all(r["near_tie"] for r in rows),
           "partings": rows}
    if drift_logits is not None:
        out["all_within_drift"] = all(r["within_drift"] for r in rows)
    return out


def teacher_forced_logits(dec_params, cfg, cross, dtype=None):
    """Logits for :func:`near_tie_report` by the reference's own path (a
    teacher-forced pass) over other parameters or cross K/V: another
    tensor-parallel layout, another batch composition."""
    import torch
    from distil_whisper_tpu_torch.models.whisper import decode

    def fn(b, prefix):
        device = next(iter(cross.values())).device
        sub = {k: v[:, b:b + 1] for k, v in cross.items()}
        with torch.no_grad():
            logits, _ = decode(dec_params, cfg,
                               torch.tensor([prefix], device=device),
                               cross=sub, dtype=dtype or torch.float32)
        return logits[0, -1]
    return fn


def cached_step_logits(dec_params, cfg, cross, dtype=None):
    """Logits for :func:`near_tie_report` by the cached single-token step
    that greedy decoding takes (a prefill of all but the prefix's last
    token, then one step), to set beside the teacher-forced pass (the
    multi-token path a speculative verify window takes)."""
    import torch
    from distil_whisper_tpu_torch.models.whisper import (decode, init_cache,
                                                         kv_width)
    dtype = dtype or torch.float32

    def fn(b, prefix):
        device = next(iter(cross.values())).device
        sub = {k: v[:, b:b + 1] for k, v in cross.items()}
        tokens = torch.tensor([prefix], device=device)
        cache = init_cache(cfg, 1, dtype=dtype, max_len=len(prefix),
                           device=device, width=kv_width(dec_params))
        with torch.no_grad():
            decode(dec_params, cfg, tokens[:, :-1], cross=sub, cache=cache,
                   pos_offset=0, dtype=dtype)
            logits, _ = decode(dec_params, cfg, tokens[:, -1:], cross=sub,
                               cache=cache, pos_offset=len(prefix) - 1,
                               dtype=dtype)
        return logits[0, -1]
    return fn


def text_near_ties(pipe, mels, ref_seqs, ref_lens, texts, ref_texts,
                   prompt, budgets):
    """The near-tie report (:func:`near_tie_report`) of the requests whose
    text parts from the reference's, over the reference's tokens
    (``ref_seqs`` rows, cut at each request's budget) and the request's
    tokens read back from its text: the synthetic tokenizer spells each
    token past the bytes as " w<id>", so the word tokens of a text are its
    ids (a byte token is not read back, so a parting there is not seen).
    The drift set beside each gap: a cached single-token step (the
    engine's and greedy's kind of step) against the teacher-forced pass."""
    import re
    from distil_whisper_tpu_torch.models import whisper as W
    p, eot = len(prompt), 50257
    ref, test, rows = [], [], []
    for i, (a, b) in enumerate(zip(texts, ref_texts)):
        if a == b:
            continue
        r = ref_seqs[i][:min(int(ref_lens[i]), p + budgets[i])].tolist()
        words = [j for j in range(p, len(r)) if 256 <= r[j] < eot]
        got = [int(w) for w in re.findall(r" w(\d+)", a)]
        k = next((k for k, (j, w) in enumerate(zip(words, got))
                  if r[j] != w), min(len(words), len(got)))
        if k >= len(words):
            continue       # the reference ends first: no step to read
        j = words[k]
        rows.append(i)
        ref.append(r)
        test.append(r[:j] + ([got[k]] if k < len(got) else []))
    if not rows:
        return {"rows": len(texts), "parting": 0, "all_near_ties": True,
                "partings": []}
    cross = W.cross_kv(pipe.params["decoder"], pipe.cfg, W.encode(
        pipe.params["encoder"], pipe.cfg, mels[rows], dtype=pipe.dtype))
    rep = near_tie_report(pipe.params["decoder"], pipe.cfg, cross, ref, test,
                          p, pipe.dtype, drift_logits=cached_step_logits(
                              pipe.params["decoder"], pipe.cfg, cross,
                              pipe.dtype))
    for r in rep["partings"]:
        r["row"] = rows[r["row"]]
    rep["rows"] = len(texts)
    return rep


def phase_build():
    from distil_whisper_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill", "arning",
                                             "Performance"))]
             for name, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "sources": list(_build.SOURCES), "ptxas": ptxas})


def phase_kernels():
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from distil_whisper_tpu_torch.audio import mel_kernel
    from distil_whisper_tpu_torch.audio.mel import compress, whisper_mel_filters
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def add(row):
        rows.append(row)
        emit({"phase": "kernel", **row})

    # -- fused log-mel: 16 x 30 s windows, 128 mels ------------------------
    b, n, m = 16, 480000, 128
    audio = 0.2 * torch.randn(b, n, generator=gen, device="cuda")
    out = mel_kernel.log10_mel_fused(audio, m)
    ref = mel_kernel.log10_mel_plain(audio, m)
    torch.cuda.synchronize()
    err_raw = (out - ref).abs().max().item()
    # the features the encoder reads, held at the JAX package's own kernel
    # tolerance (fp32 sums in another order; log10 domain)
    err = (compress(out) - compress(ref)).abs().max().item()
    if not (err <= 2e-4 and torch.isfinite(out).all()):
        raise AssertionError(f"mel kernel disagrees: max abs err {err}")
    window = torch.hann_window(400, device="cuda")
    filters = torch.from_numpy(whisper_mel_filters(m)).cuda()

    def library_mel():
        spec = torch.stft(audio, 400, 160, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        power = spec[..., :-1].abs() ** 2
        return torch.log10(torch.clamp(filters.T @ power, min=1e-10))

    # the kernel's work: the folded DFT (201 bins x 199 folded rows, re and
    # im, a frame) and the mel projection over each 8-mel group's band of
    # nonzero filter rows; the dense DFT and dense projection beside it
    frames = n // 160
    bands = mel_kernel.filter_bands(whisper_mel_filters(m))
    band_rows = int((bands[:, 1] - bands[:, 0]).sum())
    ops = b * frames * (2 * 2 * 201 * 199 + 2 * 8 * band_rows)
    ops_dense = b * frames * (2 * 402 * 400 + 2 * 201 * m)
    n_bytes = 4 * (b * n + 2 * 200 * 201 + 201 * m + b * m * frames)
    bound_ms, bound_by = bound(n_bytes, ops, FP32_CUDA_CORE)
    ms = cuda_ms(lambda: mel_kernel.log10_mel_fused(audio, m))
    add({
        "name": "log_mel", "route": "cuda",
        "source": "distil_whisper_tpu_torch/csrc/mel.cu",
        "replaces": "distil_whisper_tpu/audio/mel_pallas.py:34",
        "max_abs_err": err, "max_abs_err_log10": err_raw, "tolerance": 2e-4,
        "ms": ms, "tflops": ops / ms / 1e9,
        "plain_ms": cuda_ms(lambda: mel_kernel.log10_mel_plain(audio, m)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_dense": bound(n_bytes, ops_dense, FP32_CUDA_CORE)[0],
        "library_ms": cuda_ms(library_mel), "shape": [b, n, m],
        "long_file": mel_long_file(gen, m),
        "ptxas": ptxas_report("mel")})
    del audio, out, ref

    add(kernel_row_encoder_attention(gen))
    add(kernel_row_encoder_attention_grad(gen))
    add(kernel_row_int8_mlp(gen))
    add(kernel_row_int8_decode_attention(gen))
    return rows


def mel_long_file(gen, m: int):
    """The mel kernel on whole files, as sequential long-form computes them
    (``compute_mel(..., pad_to_chunk=False)``): one 70 s file (1,120,000
    samples, 7000 frames) and a ragged length that is no multiple of the
    hop, and clips of 160, 170 and 200 samples (one frame, the padding
    reflected more than once, gathered on the card before the kernel),
    held against the plain version on the compressed features (the max - 8
    clamp over the whole file) at the 30 s tolerance, and the 70 s file
    timed against its bound and the ``torch.stft`` composition."""
    import torch
    from distil_whisper_tpu_torch.audio import mel_kernel
    from distil_whisper_tpu_torch.audio.mel import compress, whisper_mel_filters
    rows = []
    for n in (1_120_000, 1_120_000 - 77, 160, 170, 200):
        audio = 0.2 * torch.randn(1, n, generator=gen, device="cuda")
        out = mel_kernel.log10_mel_fused(audio, m)
        ref = mel_kernel.log10_mel_plain(audio, m)
        torch.cuda.synchronize()
        err = (compress(out) - compress(ref)).abs().max().item()
        if not (out.shape == (1, m, n // 160) and err <= 2e-4
                and torch.isfinite(out).all()):
            raise AssertionError(f"mel kernel disagrees on a {n}-sample "
                                 f"file: {tuple(out.shape)}, max abs err {err}")
        rows.append({"samples": n, "frames": n // 160, "max_abs_err": err})
    audio = 0.2 * torch.randn(1, 1_120_000, generator=gen, device="cuda")
    n, frames = audio.shape[1], audio.shape[1] // 160
    window = torch.hann_window(400, device="cuda")
    filters = torch.from_numpy(whisper_mel_filters(m)).cuda()

    def library_mel():
        spec = torch.stft(audio, 400, 160, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        return torch.log10(torch.clamp(filters.T @ (spec[..., :-1].abs() ** 2),
                                       min=1e-10))

    bands = mel_kernel.filter_bands(whisper_mel_filters(m))
    band_rows = int((bands[:, 1] - bands[:, 0]).sum())
    ops = frames * (2 * 2 * 201 * 199 + 2 * 8 * band_rows)
    n_bytes = 4 * (n + 2 * 200 * 201 + 201 * m + m * frames)
    bound_ms, bound_by = bound(n_bytes, ops, FP32_CUDA_CORE)
    return {"held": rows, "tolerance": 2e-4, "timed_shape": [1, n, m],
            "ms": cuda_ms(lambda: mel_kernel.log10_mel_fused(audio, m)),
            "plain_ms": cuda_ms(lambda: mel_kernel.log10_mel_plain(audio, m)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(library_mel)}


def kernel_row_encoder_attention(gen):
    """Encoder attention at (16, 20, 1500, 64) bf16 in two layouts:
    contiguous [B, H, T, 64], and the main path's [B, H, T, 64] views of
    three [B, T, 1280] projections; the tensor-parallel path's views of a
    rank's [B, T, 640] and [B, T, 320] projections (H 10 and 5, tp 2 and
    4) against the plain version at the same tolerance; plus ragged cases
    against the plain
    version (T 1536 with 1500 live keys, as the JAX package pads, and a
    small odd shape), which hold TMA's zero fill and the -inf key mask of
    partial tiles."""
    import torch
    from distil_whisper_tpu_torch.ops import encoder_attention as ea

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def check(q, k, v, t_real):
        out = ea.encoder_attention(q, k, v, t_real)
        ref = ea.encoder_attention_plain(q, k, v, t_real)
        torch.cuda.synchronize()
        # Both round the same fp32 result to bf16, but the kernel's online
        # softmax rounds p to bf16 against a running max and sums in another
        # order: a few bf16 ulps (2^-8 relative) apart, inside atol/rtol 1e-2.
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        err = (out.float() - ref.float()).abs().max().item()
        del out, ref
        torch.cuda.empty_cache()
        return err

    b, h, t, d = 16, 20, 1500, 64
    q, k, v = (rand(b, h, t, d) for _ in range(3))
    err = check(q, k, v, t)
    qm, km, vm = (rand(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                  for _ in range(3))
    err_main = check(qm, km, vm, t)
    # the tensor-parallel layouts: a rank's heads, views of its [B, T,
    # 1280 / tp] projections (rows of 1280 / tp x 2 bytes)
    tp_layouts = []
    for tp in (2, 4):
        ht = h // tp
        qt, kt, vt = (rand(b, t, ht * d).view(b, t, ht, d).transpose(1, 2)
                      for _ in range(3))
        tp_layouts.append({"tp": tp, "shape": [b, ht, t, d],
                           "row_bytes": ht * d * 2,
                           "max_abs_err": check(qt, kt, vt, t)})
        del qt, kt, vt
    ragged = []
    for shape, t_real in (((16, 20, 1536, 64), 1500), ((3, 5, 200, 64), 77)):
        qr, kr, vr = (rand(*shape) for _ in range(3))
        ragged.append({"shape": list(shape), "t_real": t_real,
                       "max_abs_err": check(qr, kr, vr, t_real)})
        del qr, kr, vr

    def sdpa(q, k, v):
        # all 1500 keys are live (t_real == T), so the key mask is all-true
        # and SDPA may take its fastest backend
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    ops = 4 * b * h * t * t * d
    n_bytes = 4 * b * h * t * d * 2
    bound_ms, bound_by = bound(n_bytes, ops, BF16_TENSOR)
    ms = cuda_ms(lambda: ea.encoder_attention(q, k, v, t))
    ms_main = cuda_ms(lambda: ea.encoder_attention(qm, km, vm, t))
    row = {
        "name": "encoder_attention", "route": "cuda",
        "source": "distil_whisper_tpu_torch/csrc/encoder_attention.cu",
        "replaces": "distil_whisper_tpu/ops/encoder_attention.py:57",
        "max_abs_err": err, "tolerance": 1e-2,
        "ms": ms, "tflops": ops / ms / 1e9,
        "plain_ms": cuda_ms(lambda: ea.encoder_attention_plain(q, k, v, t)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: sdpa(q, k, v)),
        "ms_main_layout": ms_main, "tflops_main_layout": ops / ms_main / 1e9,
        "library_ms_main_layout": cuda_ms(lambda: sdpa(qm, km, vm)),
        "max_abs_err_main_layout": err_main, "ragged": ragged,
        "tensor_parallel_layouts": tp_layouts,
        "shape": [b, h, t, d], "ptxas": ptxas_report("encoder_attention")}
    del q, k, v, qm, km, vm
    torch.cuda.empty_cache()
    return row


def sass_report(source: str, lib=None):
    """Each kernel of one source's built library (or of the library at
    ``lib``): the highest register its SASS names and its local-memory
    loads and stores (spills), from ``cuobjdump -sass``.  ptxas reports the
    registers a thread is given at launch; setmaxnreg lets a warpgroup use
    more."""
    import re
    from distil_whisper_tpu_torch.ops import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass",
                           str(lib or _build._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        kernel = re.search(r"([a-z_]+_kernel)E", name)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        out[kernel.group(1) if kernel else name] = {
            "max_register": max(regs) if regs else None,
            "local_stores": len(re.findall(r"\bSTL\b", part)),
            "local_loads": len(re.findall(r"\bLDL\b", part))}
    return out


def ptxas_report(source: str):
    """The ptxas lines (registers, shared memory, spills) of one source's
    build in this process."""
    from distil_whisper_tpu_torch.ops import _build
    return [ln.strip() for ln in _build.build_logs.get(source, "").splitlines()
            if any(w in ln for w in ("registers", "spill", "smem", "arning",
                                     "Performance"))]


def kernel_row_int8_mlp(gen):
    """The fused W8A8 MLP at the encoder's shape (16 x 1500 rows, d 1280,
    ffn 5120, bf16 x, int8 weights quantized by the port), and held on one
    window (1500 rows) and at the gate's minimum (300 rows: ragged to every
    tile)."""
    import torch
    import torch.nn.functional as F
    from distil_whisper_tpu_torch.ops import int8_mlp
    from distil_whisper_tpu_torch.ops.quant import (dense_int8, quantize_acts,
                                                     quantize_dense)
    m, d, f = 16 * 1500, 1280, 5120

    def rand(*shape, std):
        return std * torch.randn(*shape, generator=gen, device="cuda")

    fc1 = quantize_dense({"kernel": rand(d, f, std=0.03), "bias": rand(f, std=0.01)})
    fc2 = quantize_dense({"kernel": rand(f, d, std=0.03), "bias": rand(d, std=0.01)})
    x = rand(m, d, std=1.0).to(torch.bfloat16)

    def check(xr):
        out = int8_mlp.fused_int8_mlp(fc1, fc2, xr)
        ref = int8_mlp.fused_int8_mlp_plain(fc1, fc2, xr)
        torch.cuda.synchronize()
        diff = out.float() - ref.float()
        err, rel = diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()
        # integer products are exact and the fp32 epilogues round as the
        # plain version's; expf's last ulp can still move a requantization
        # quantum, and a moved quantum can move a bf16 rounding of the output
        if not (rel <= 1e-3 and torch.isfinite(out).all()):
            raise AssertionError(f"int8 MLP kernel disagrees at M "
                                 f"{xr.shape[0]}: relative L2 {rel}")
        return err, rel

    err, rel = check(x)
    shapes = [{"m": mr, **dict(zip(("max_abs_err", "rel_l2_err"), check(x[:mr])))}
              for mr in (1500, 300)]

    def library_mlp():
        # the unfused composition the port runs where the kernel does not:
        # torch._int_mm, rescale, gelu, requantize, torch._int_mm
        return dense_int8(fc2, F.gelu(dense_int8(fc1, x)))

    w1 = (fc1["kernel_q"].float() * fc1["kernel_scale"]).T.to(torch.bfloat16).contiguous()
    w2 = (fc2["kernel_q"].float() * fc2["kernel_scale"]).T.to(torch.bfloat16).contiguous()
    b1, b2 = fc1["bias"].to(torch.bfloat16), fc2["bias"].to(torch.bfloat16)
    xq, _ = quantize_acts(x)
    w1_row_major = fc1["kernel_q"].contiguous()
    ops = 4 * m * d * f
    n_bytes = 2 * m * d * 2 + 2 * d * f + 4 * 2 * (f + d)
    bound_ms, bound_by = bound(n_bytes, ops, INT8_TENSOR)
    ms = cuda_ms(lambda: int8_mlp.fused_int8_mlp(fc1, fc2, x))
    row = {
        "name": "int8_mlp", "route": "cuda",
        "source": "distil_whisper_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "distil_whisper_tpu/ops/int8_mlp.py:55",
        "max_abs_err": err, "rel_l2_err": rel, "tolerance": "rel_l2 1e-3",
        "ms": ms, "tops": ops / ms / 1e9, "bound_share": bound_ms / ms,
        "plain_ms": cuda_ms(lambda: int8_mlp.fused_int8_mlp_plain(fc1, fc2, x),
                            reps=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(library_mlp),
        "bf16_linear_gelu_linear_ms": cuda_ms(
            lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)),
        # torch._int_mm at fc1's shape, right operand in either layout
        "int_mm_fc1_ms": {
            "output_major": cuda_ms(lambda: torch._int_mm(xq, fc1["kernel_q"])),
            "row_major": cuda_ms(lambda: torch._int_mm(xq, w1_row_major))},
        "shape": [m, d, f], "other_shapes": shapes,
        "ptxas": ptxas_report("int8_mlp")}
    del x, xq, w1, w2, fc1, fc2, w1_row_major
    torch.cuda.empty_cache()
    return row


def kernel_row_int8_decode_attention(gen):
    """int8 decode attention at the cross-attention shape (B 16, T 1536 with
    1500 live keys, per-head scales) and the self-cache shape (T 448,
    per-token scales, per-row masks), and held at T 32 and T 8192 and with
    one mask row shared by the batch."""
    import torch
    import torch.nn.functional as F
    from distil_whisper_tpu_torch.ops import int8_decode_attention as ida
    b, d, h = 16, 1280, 20

    def case(t, per_head, mask, timed=True):
        q = torch.randn(b, d, generator=gen, device="cuda").to(torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (b, t, d), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        shape = (b, h) if per_head else (b, t)
        ks, vs = (0.01 * (0.5 + torch.rand(shape, generator=gen, device="cuda"))
                  for _ in range(2))
        out = ida.int8_decode_attention(q, kq, ks, vq, vs, h, mask)
        ref = ida.int8_decode_attention_plain(q, kq, ks, vq, vs, h, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        # integer scores and p.V are exact; the softmax sums in another
        # order, which can move one probability quantum: two bf16 ulps of
        # the largest output
        if not err <= 2 ** -7 * scale:
            raise AssertionError(f"int8 decode attention disagrees at T {t}: "
                                 f"max abs err {err} (output scale {scale})")
        row = {"max_abs_err": err, "tolerance": "max abs 2^-7 x max |out|",
               "shape": [b, t, d], "scales": "per_head" if per_head else "per_token",
               "mask_rows": mask.shape[0]}
        if not timed:
            return row

        def dequant(xq, s):
            s = s.repeat_interleave(d // h, dim=1)[:, None] if per_head else s[..., None]
            return (xq.to(torch.bfloat16) * s.to(torch.bfloat16)).view(
                b, t, h, d // h).transpose(1, 2)

        kd, vd = dequant(kq, ks), dequant(vq, vs)
        qh, am = q.view(b, h, 1, d // h), mask.view(mask.shape[0], 1, 1, t)

        def library():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=am)

        n_bytes = 2 * b * t * d + 2 * 2 * b * d + 2 * 4 * ks.numel() + mask.numel()
        bound_ms, bound_by = bound(n_bytes, 4 * b * t * d, INT8_TENSOR)
        # device times from CUDA graphs: at tens of microseconds a call,
        # back-to-back launches from Python time the host (kept beside)
        kernel = lambda: ida.int8_decode_attention(q, kq, ks, vq, vs, h, mask)
        ms = cuda_graph_ms(kernel)
        return {**row, "ms": ms, "gb_per_s": n_bytes / ms / 1e6,
                "bound_share": bound_ms / ms,
                "plain_ms": cuda_graph_ms(lambda: ida.int8_decode_attention_plain(
                    q, kq, ks, vq, vs, h, mask), reps=5),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": cuda_graph_ms(library),
                "ms_host_launched": cuda_ms(kernel, reps=20),
                "library_ms_host_launched": cuda_ms(library, reps=20)}

    def prefix(t, live):
        return torch.arange(t, device="cuda")[None] < live

    cross = case(1536, True, prefix(1536, 1500))
    lens = torch.randint(1, 448, (b, 1), generator=gen, device="cuda")
    self_cache = case(448, False, prefix(448, lens))
    held = [case(32, False, prefix(32, torch.randint(1, 33, (b, 1), generator=gen,
                                                     device="cuda")), timed=False),
            case(8192, True, prefix(8192, 8000)),
            case(448, False, prefix(448, 300), timed=False)]    # shared mask row
    torch.cuda.empty_cache()
    return {"name": "int8_decode_attention", "route": "cuda",
            "source": "distil_whisper_tpu_torch/csrc/int8_decode_attention.cu",
            "replaces": "distil_whisper_tpu/ops/int8_decode_attention.py:70",
            **cross, "self_cache": self_cache, "other_shapes": held,
            "ptxas": ptxas_report("int8_decode_attention")}


def _wrappers():
    from distil_whisper_tpu_torch.audio import mel_kernel
    from distil_whisper_tpu_torch.ops import encoder_attention as ea
    from distil_whisper_tpu_torch.ops import int8_decode_attention as ida
    from distil_whisper_tpu_torch.ops import int8_mlp
    return {"log_mel": mel_kernel.log10_mel_fused,
            "encoder_attention": ea.encoder_attention,
            "encoder_attention_grad": ea.encoder_attention_grad,
            "int8_mlp": int8_mlp.fused_int8_mlp,
            "int8_decode_attention": ida.int8_decode_attention}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_main_path(tok):
    """distil-large-v3 at full width, bf16, through WhisperPipeline."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import GenerationOptions, generate
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    cfg = PRESETS["distil-large-v3"]
    if (tok.no_timestamps, tok.timestamp_begin) != (
            cfg.no_timestamps_token_id, cfg.timestamp_begin):
        raise AssertionError("tokenizer layout disagrees with the config")
    dtype = torch.bfloat16
    params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
    pipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                           max_new_tokens=128, params=params, cfg=cfg,
                           tokenizer=tok, device="cuda")
    clips = synthetic_audio(16, 30.0, seed=1)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = pipe(clips, language="en")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    if (counts["log_mel"] < 1 or counts["encoder_attention"] != cfg.encoder_layers
            or counts["int8_mlp"] or counts["int8_decode_attention"]):
        raise AssertionError(f"main path missed a kernel: {counts}")

    t0 = time.perf_counter()
    second = pipe(clips, language="en")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if first != second:
        raise AssertionError("two runs of the same batch gave other tokens")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # split the warm run: encode, then greedy decode (tokens compared too)
    pcfg = pipe.cfg
    mels = compute_mel(np.stack(clips), pcfg, device="cuda").to(dtype)
    enc_ms = cuda_ms(lambda: W.encode(params["encoder"], pcfg, mels,
                                      dtype=dtype), reps=5, warmup=1)
    enc = W.encode(params["encoder"], pcfg, mels, dtype=dtype)
    if enc.shape != (16, 1500, cfg.d_model) or not torch.isfinite(enc).all():
        raise AssertionError(f"bad encoder states {tuple(enc.shape)}")
    # the kernel encoder against the einsum encoder (fp32 attention logits,
    # no kernel) on two windows: bf16 roundings apart, not more
    ref_cfg = pcfg.replace(use_flash_encoder=False, fast_bf16_attention=False)
    ref = W.encode(params["encoder"], ref_cfg, mels[:2], dtype=dtype).float()
    rel = ((enc[:2].float() - ref).norm() / ref.norm()).item()
    if not rel < 2e-2:
        raise AssertionError(f"kernel encoder vs einsum encoder: rel {rel}")
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=128,
                                         no_speech_token_id=tok.no_speech)
    cross = W.cross_kv(params["decoder"], pcfg, enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params["decoder"], pcfg, cross, prompt, opts, dtype=dtype)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = int(out.seq_len.max()) - prompt.shape[1]
    texts = [tok.decode(out.sequences[j, :out.seq_len[j]].tolist())
             for j in range(16)]
    if texts != [r["text"] for r in first]:
        raise AssertionError("pipeline and generate() disagree")

    # one ~70 s file, chunked (3 windows), with segment timestamps
    long_clip = synthetic_audio(1, 70.0, seed=2)[0]
    reset_counts()
    t0 = time.perf_counter()
    chunked = pipe(long_clip, language="en", return_timestamps=True)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunked_counts = read_counts()
    if chunked_counts["encoder_attention"] != cfg.encoder_layers:
        raise AssertionError(f"chunked path missed a kernel: {chunked_counts}")
    if not isinstance(chunked["text"], str) or "chunks" not in chunked:
        raise AssertionError("chunked result lacks text or chunks")

    metrics = {"audio_s_per_s": 16 * 30.0 / warm_s, "encode_ms": enc_ms,
               "decode_ms_per_step": gen_s * 1e3 / max(steps, 1),
               "peak_mem_gib": peak_gib}
    emit({"phase": "main_path", "model": "distil-large-v3", "dtype": "bf16",
          "batch": 16, "window_s": 30, "max_new_tokens": 128,
          "launches": counts, "chunked_launches": chunked_counts,
          "first_call_s": first_s, "warm_call_s": warm_s, **metrics,
          "decode_steps": steps, "generate_s": gen_s,
          "encoder_rel_err_vs_einsum": rel,
          "chunked_s": chunked_s, "chunked_segments": len(chunked["chunks"]),
          "text_chars": [len(r["text"]) for r in first]})
    return {"params": params, "clips": clips, "long_clip": long_clip,
            "mels": mels, "enc": enc, "metrics": metrics}


def phase_int8_main_path(tok, bf16):
    """The int8 path: the bf16 path's weights with all five int8 flags,
    through WhisperPipeline, short-form twice and the chunked file."""
    import torch
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import GenerationOptions, generate
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    cfg = PRESETS["distil-large-v3"].replace(**INT8_FLAGS)
    dtype = torch.bfloat16
    pipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                           max_new_tokens=128, params=bf16["params"], cfg=cfg,
                           tokenizer=tok, device="cuda")
    clips = bf16["clips"]
    expected = {"log_mel": 1, "encoder_attention": cfg.encoder_layers,
                "encoder_attention_grad": 0,
                "int8_mlp": cfg.encoder_layers, "int8_decode_attention": 0}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first = pipe(clips, language="en")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    if counts != expected:
        raise AssertionError(f"int8 path launches {counts}, expected {expected}")
    t0 = time.perf_counter()
    second = pipe(clips, language="en")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if first != second:
        raise AssertionError("two int8 runs of the same batch gave other tokens")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # encode and decode apart; the int8 encoder against the bf16 encoder:
    # cos > 0.999 as tests/test_quant.py holds the JAX int8 encoder; its
    # relative bound there (3e-2) is for 2 layers, and the error of 32
    # random-weight layers is larger (3.4e-2 measured on the H100), so the
    # relative bound here is 5e-2
    pcfg, qparams, mels = pipe.cfg, pipe.params, bf16["mels"]
    enc_ms = cuda_ms(lambda: W.encode(qparams["encoder"], pcfg, mels,
                                      dtype=dtype), reps=5, warmup=1)
    enc = W.encode(qparams["encoder"], pcfg, mels, dtype=dtype)
    a, b = enc.double().flatten(), bf16["enc"].double().flatten()
    cos = (a @ b / (a.norm() * b.norm())).item()
    rel = ((a - b).norm() / b.norm()).item()
    if not (torch.isfinite(enc).all() and cos > 0.999 and rel < 5e-2):
        raise AssertionError(f"int8 encoder vs bf16 encoder: cos {cos}, "
                             f"rel {rel}")
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=128,
                                         no_speech_token_id=tok.no_speech)
    cross = W.cross_kv(qparams["decoder"], pcfg, enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(qparams["decoder"], pcfg, cross, prompt, opts, dtype=dtype)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = int(out.seq_len.max()) - prompt.shape[1]
    texts = [tok.decode(out.sequences[j, :out.seq_len[j]].tolist())
             for j in range(16)]
    if texts != [r["text"] for r in first]:
        raise AssertionError("int8 pipeline and generate() disagree")

    reset_counts()
    t0 = time.perf_counter()
    chunked = pipe(bf16["long_clip"], language="en", return_timestamps=True)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunked_counts = read_counts()
    if chunked_counts["log_mel"] < 1 or any(
            chunked_counts[k] != v for k, v in expected.items() if k != "log_mel"):
        raise AssertionError(f"int8 chunked path launches {chunked_counts}")
    if not isinstance(chunked["text"], str) or "chunks" not in chunked:
        raise AssertionError("int8 chunked result lacks text or chunks")

    emit({"phase": "int8_main_path", "model": "distil-large-v3",
          "dtype": "bf16", "int8": sorted(INT8_FLAGS), "batch": 16,
          "window_s": 30, "max_new_tokens": 128, "launches": counts,
          "chunked_launches": chunked_counts, "first_call_s": first_s,
          "warm_call_s": warm_s, "audio_s_per_s": 16 * 30.0 / warm_s,
          "encode_ms": enc_ms, "decode_steps": steps,
          "decode_ms_per_step": gen_s * 1e3 / max(steps, 1),
          "generate_s": gen_s, "peak_mem_gib": peak_gib,
          "encoder_vs_bf16": {"cos": cos, "rel_l2": rel},
          "chunked_s": chunked_s, "chunked_segments": len(chunked["chunks"]),
          "bf16_same_run": bf16["metrics"]})
    return counts


def _segment_keys(results):
    return [[(s["tokens"], round(s["start"], 6), round(s["end"], 6),
              s["temperature"]) for s in r["segments"]] for r in results]


def phase_longform_path(tok, bf16):
    """Beam search, word timestamps and sequential long-form at the full
    width of distil-large-v3, on the main path's bf16 weights; then the
    beam run again in the int8 lane.  Each path's launches are counted from
    0 just before it and read just after."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber,
        beam_search, generate)
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    cfg = PRESETS["distil-large-v3"]
    dtype, params, clips = torch.bfloat16, bf16["params"], bf16["clips"]
    pipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                           max_new_tokens=128, params=params, cfg=cfg,
                           tokenizer=tok, device="cuda")
    pcfg, k = pipe.cfg, 5
    launches, report = {}, {}
    bf16_path = {"log_mel": 1, "encoder_attention": cfg.encoder_layers,
                 "encoder_attention_grad": 0, "int8_mlp": 0,
                 "int8_decode_attention": 0}

    # -- 1. beam search: 16 windows x 5 beams = 80 decode rows -------------
    def beam_run(p):
        return p(clips, language="en", generate_kwargs={"num_beams": k})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first = beam_run(pipe)
    torch.cuda.synchronize()
    beam_first_s = time.perf_counter() - t0
    launches["beam"] = read_counts()
    if launches["beam"] != bf16_path:
        raise AssertionError(f"beam path launches {launches['beam']}")
    t0 = time.perf_counter()
    second = beam_run(pipe)
    torch.cuda.synchronize()
    beam_warm_s = time.perf_counter() - t0
    if first != second:
        raise AssertionError("two beam runs of the same batch gave other "
                             "tokens")
    beam_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the decode loop alone, on the main path's cross K/V, in the
    # pipeline's graphs: a warm call timed after the capturing one
    cross = W.cross_kv(params["decoder"], pcfg, bf16["enc"])
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=128,
                                         no_speech_token_id=tok.no_speech)
    beam_search(params["decoder"], pcfg, cross, prompt, opts, num_beams=k,
                dtype=dtype, graphs=pipe.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = beam_search(params["decoder"], pcfg, cross, prompt, opts,
                      num_beams=k, dtype=dtype, graphs=pipe.graphs)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    total = prompt.shape[1] + opts.max_new_tokens
    texts = [tok.decode(out.sequences[j, :out.seq_len[j]].tolist())
             for j in range(16)]
    if texts != [r["text"] for r in first]:
        raise AssertionError("beam pipeline and beam_search() disagree")
    one = beam_search(params["decoder"], pcfg, cross, prompt, opts,
                      num_beams=1, dtype=dtype)
    greedy = generate(params["decoder"], pcfg, cross, prompt, opts,
                      dtype=dtype)
    # one beam follows the argmax path while no row emits EOS (the random
    # model emits none; EOS would end greedy rows and not the beam)
    if (greedy.sequences == pcfg.eos_token_id).any() or not torch.equal(
            one.sequences, greedy.sequences):
        raise AssertionError("beam_search(num_beams=1) differs from "
                             "generate()")
    report["beam"] = {
        "windows": 16, "num_beams": k, "decode_rows": 16 * k,
        "max_new_tokens": 128, "first_call_s": beam_first_s,
        "warm_call_s": beam_warm_s, "audio_s_per_s": 16 * 30.0 / beam_warm_s,
        "search_s": search_s,
        # every hypothesis ran the whole budget, so the loop took 128 steps
        "full_budget": bool((out.seq_len == total).all()),
        "ms_per_beam_step": search_s * 1e3 / opts.max_new_tokens,
        "peak_mem_gib": beam_peak}
    emit({"phase": "longform_path.beam", "launches": launches["beam"],
          **report["beam"]})
    del cross, out, one, greedy

    # -- 2. word timestamps on the ~70 s file ------------------------------
    reset_counts()
    t0 = time.perf_counter()
    words = pipe(bf16["long_clip"], language="en", return_timestamps="word")
    torch.cuda.synchronize()
    words_s = time.perf_counter() - t0
    launches["word_timestamps"] = read_counts()
    if launches["word_timestamps"] != bf16_path:
        raise AssertionError(f"word-timestamp launches "
                             f"{launches['word_timestamps']}")
    spans = [c["timestamp"] for c in words["chunks"]]
    duration = len(bf16["long_clip"]) / 16000
    if len(spans) < 10 or any(
            not 0.0 <= a <= b <= duration + 0.02 for a, b in spans) or any(
            spans[i + 1][0] < spans[i][0] for i in range(len(spans) - 1)):
        raise AssertionError(f"word times out of order or range: {spans[:8]}")
    report["word_timestamps"] = {"audio_s": duration, "seconds": words_s,
                                 "words": len(spans),
                                 "first_words": words["chunks"][:3]}
    emit({"phase": "longform_path.word_timestamps",
          "launches": launches["word_timestamps"],
          **report["word_timestamps"]})

    # -- 3. sequential long-form: the six-rung ladder over 16 files --------
    lengths = [40.0 + 35.0 * i / 15 for i in range(16)]
    files = [a[:int(sec * 16000)] for a, sec in
             zip(synthetic_audio(16, 75.0, seed=7), lengths)]
    audio_s = sum(len(a) for a in files) / 16000
    reset_counts()
    feats = [compute_mel(a, pcfg, pad_to_chunk=False, device="cuda")[0]
             for a in files]
    torch.cuda.synchronize()
    feature_counts = read_counts()
    if feature_counts["log_mel"] != len(files):
        raise AssertionError(f"whole-file features launched the mel kernel "
                             f"{feature_counts['log_mel']} times for "
                             f"{len(files)} files")
    tr = SequentialTranscriber(params, pcfg, tok, SequentialOptions(),
                               language="en", batch_size=16, dtype=dtype,
                               device="cuda")
    calls = []
    run_window = tr._run_window

    def counted(mels, prompts, pads, temperature, generator):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        result = run_window(mels, prompts, pads, temperature, generator)
        calls.append((temperature, len(mels), time.perf_counter() - c0))
        return result

    tr._run_window = counted
    reset_counts()
    t0 = time.perf_counter()
    seq1 = tr.transcribe(feats, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    seq_counts = read_counts()
    encode_calls = len(calls)
    if (seq_counts["encoder_attention"] != cfg.encoder_layers * encode_calls
            or seq_counts["log_mel"] or seq_counts["int8_mlp"]):
        raise AssertionError(f"sequential launches {seq_counts} for "
                             f"{encode_calls} encode calls")
    launches["sequential"] = {
        **seq_counts, "log_mel": feature_counts["log_mel"]}
    rows = {}
    rung_s = {}
    for t, n, sec in calls:
        rows[t] = rows.get(t, 0) + n
        rung_s.setdefault(t, []).append(sec)
    temps = list(SequentialOptions().temperatures)
    accepted = {t: rows.get(t, 0) - rows.get(temps[i + 1], 0)
                if i + 1 < len(temps) else rows.get(t, 0)
                for i, t in enumerate(temps)}
    seq_rerun = tr.transcribe(feats, generator=torch.Generator().manual_seed(0))
    if _segment_keys(seq1) != _segment_keys(seq_rerun):
        raise AssertionError("the same generator seed gave other segments")
    greedy_tr = SequentialTranscriber(
        params, pcfg, tok, SequentialOptions(temperatures=(0.0,)),
        language="en", batch_size=16, dtype=dtype, device="cuda")
    t0 = time.perf_counter()
    g1 = greedy_tr.transcribe(feats)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    if _segment_keys(g1) != _segment_keys(greedy_tr.transcribe(feats)):
        raise AssertionError("temperature 0 gave other segments on a rerun")
    report["sequential"] = {
        "files": len(files), "file_s": [round(x, 3) for x in lengths],
        "audio_s": audio_s, "windows": rows.get(temps[0], 0),
        "encode_calls": encode_calls, "window_rows_per_rung": rows,
        "accepted_windows_by_temperature": accepted,
        "segments": sum(len(r["segments"]) for r in seq1),
        "seconds": seq_s, "audio_s_per_s": audio_s / seq_s,
        "seconds_per_rung": {t: sum(v) / len(v) for t, v in rung_s.items()},
        "greedy_only": {"seconds": greedy_s, "audio_s_per_s": audio_s / greedy_s,
                        "segments": sum(len(r["segments"]) for r in g1)}}
    emit({"phase": "longform_path.sequential",
          "launches": launches["sequential"], **report["sequential"]})
    del feats, tr, greedy_tr

    # -- 4. the int8 lane: the same beam run with the five int8 flags ------
    qpipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                            max_new_tokens=128, params=params,
                            cfg=cfg.replace(**INT8_FLAGS), tokenizer=tok,
                            device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    qfirst = beam_run(qpipe)
    torch.cuda.synchronize()
    qbeam_s = time.perf_counter() - t0
    int8_first = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    qsecond = beam_run(qpipe)
    torch.cuda.synchronize()
    qbeam_warm_s = time.perf_counter() - t0
    launches["int8_beam"] = read_counts()
    # the encoder's 32 layers, and the decoder's prefill, replayed from its
    # graph: 80 rows x 4 prompt tokens pass the kernel's 256-row gate (one
    # launch a decoder layer); the first call also warms the prefill up
    # before its capture (one more launch a decoder layer)
    expected = {**bf16_path,
                "int8_mlp": cfg.encoder_layers + cfg.decoder_layers}
    if launches["int8_beam"] != expected:
        raise AssertionError(f"int8 beam launches {launches['int8_beam']}")
    if int8_first != {**expected, "int8_mlp": expected["int8_mlp"]
                      + cfg.decoder_layers}:
        raise AssertionError(f"int8 beam first-call launches {int8_first}")
    if qsecond != qfirst:
        raise AssertionError("two int8 beam runs gave other tokens")
    del qpipe
    torch.cuda.empty_cache()
    emit({"phase": "longform_path", "model": "distil-large-v3",
          "dtype": "bf16", "launches": launches,
          "int8_beam_first_call_launches": int8_first,
          "int8_beam_first_call_s": qbeam_s,
          "int8_beam_warm_call_s": qbeam_warm_s})
    return launches


def serve_all(tr, requests, timeout: float = 600.0):
    """Submit every request ``(audio, kwargs)`` to a transcriber from its
    own thread, all at once.  Returns (results, per-request latencies in s,
    wall s).  Any error result raises."""
    import threading
    results, latency, errors = [None] * len(requests), [0.0] * len(requests), []

    def post(i, audio, kw):
        t0 = time.perf_counter()
        try:
            results[i] = tr.submit(audio, timeout=timeout, **kw)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append((i, f"{type(e).__name__}: {e}"))
        latency[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=post, args=(i, a, kw))
               for i, (a, kw) in enumerate(requests)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serving errors: {errors[:4]}")
    return results, latency, wall


def _percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def _device_ms(fn, key_averages: bool = False):
    """(wall ms, summed device ms of kernels, copies and fills) of ``fn``
    under the profiler (device activity only).  The raw events are summed:
    building the profiler's event tree costs seconds a 100k launches.
    With ``key_averages`` the host is traced too and a third number comes
    back from the same trace: the self device time of the event tree's
    device entries, the other way to sum it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if key_averages:
        acts.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not key_averages:
        return wall, busy / 1e6
    tree = sum(float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))
               for e in prof.key_averages() if e.device_type.name == "CUDA")
    return wall, busy / 1e6, tree / 1e3


def idle_share(device_ms: float, wall_ms: float) -> float:
    """1 - device / wall, unclamped: below 0 where work on overlapping
    streams summed to more than the wall time."""
    return 1.0 - device_ms / wall_ms


def serving_traffic(clips, long_clips):
    """The serving cell's requests: 32 single windows with budgets drawn
    from 24-96 (seed 0), the last 8 sampled (temperature 0.8, top_k 8,
    seeds 1000+i); 2 files of ~70 s with segment timestamps; a burst of 4
    word-timestamp requests.  Returns (requests, audio seconds)."""
    import numpy as np
    budgets = np.random.default_rng(0).integers(24, 97, size=32)
    reqs = []
    for i, (clip, b) in enumerate(zip(clips, budgets)):
        kw = dict(language="en", max_new_tokens=int(b))
        if i >= 24:
            kw.update(temperature=0.8, top_k=8, seed=1000 + i)
        reqs.append((clip, kw))
    reqs += [(c, dict(language="en", return_timestamps=True))
             for c in long_clips]
    reqs += [(c, dict(language="en", return_timestamps="word"))
             for c in clips[:4]]
    audio_s = sum(len(a) for a, _ in reqs) / 16000
    return reqs, audio_s


def run_scheduler(name, tr, reqs, audio_s, n_greedy, greedy_ref):
    """Drive one started transcriber with the cell's traffic, launches
    counted from 0 around it; returns (report, launches, results)."""
    import torch
    admits, spent = [], {"admit_s": 0.0, "step_s": 0.0, "unpack_s": 0.0}
    if hasattr(tr, "engine"):
        eng = tr.engine
        real = {k: getattr(eng, k) for k in ("admit", "step", "unpack")}

        def timed(key, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[f"{key}_s"] += time.perf_counter() - t0
            return call

        def counted_admit(mels, *a, **k):
            admits.append(len(mels))
            return real["admit"](mels, *a, **k)

        # the worker thread's time: admission (encode, prefill, writes
        # into the lanes), enqueueing blocks, and waiting for each block's
        # packed vector
        eng.admit = timed("admit", counted_admit)
        eng.step = timed("step", real["step"])
        eng.unpack = timed("unpack", real["unpack"])
    before = dict(tr.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results, lat, wall = serve_all(tr, reqs)
    torch.cuda.synchronize()
    launches = read_counts()
    # this run's counts (the max_* entries stay as they are)
    st = {k: v if "max" in k or k == "gamma_current" else v - before[k]
          for k, v in tr.stats.items()}
    if hasattr(tr, "engine"):
        for k, fn in real.items():
            setattr(eng, k, fn)
        encodes = len(admits) + st["fb_batches"]
        windows = st["admitted"]
        if windows != 32 + 3 * 2:
            raise AssertionError(f"{name}: admitted {windows} windows, "
                                 "expected 38 (32 + 2 files of 3)")
        if st["max_inflight"] > tr.batch_size:
            raise AssertionError(f"{name}: max_inflight {st}")
        if launches["log_mel"] < len(reqs):
            raise AssertionError(f"{name}: mel launches {launches} below "
                                 f"one a request ({len(reqs)})")
    else:
        encodes = st["batches"] + st["word_ts_batches"] + st["long_form"]
        if launches["log_mel"] != encodes:
            raise AssertionError(f"{name}: mel launches {launches}, "
                                 f"expected one a device group ({encodes})")
    layers = tr.pipe.cfg.encoder_layers
    if launches["encoder_attention"] != layers * encodes:
        raise AssertionError(f"{name}: attention launches {launches}, "
                             f"expected {layers} x {encodes} encodes")
    for r in results:
        if not isinstance(r.get("text"), str):
            raise AssertionError(f"{name}: a result without text: {r}")
    equal = sum(results[i]["text"] == greedy_ref[i] for i in range(n_greedy))
    report = {"audio_s": audio_s, "wall_s": wall,
              "audio_s_per_s": audio_s / wall,
              "latency_p50_s": _percentile(lat, 50),
              "latency_p95_s": _percentile(lat, 95),
              "requests": len(reqs), "encode_calls": encodes,
              "admission_sizes": admits or None,
              "worker_time": spent if admits else None,
              "greedy_text_equal_to_pipeline": equal / n_greedy,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "stats": st}
    return report, launches, results


def sync_sites(fn):
    """``(fn(), the Python frames of every synchronising CUDA call in it)``
    (``torch.cuda.set_sync_debug_mode``)."""
    import traceback
    import warnings
    import torch
    where = []

    def record(message, category, filename, lineno, *a, **k):
        if "synchronizing CUDA operation" in str(message):
            # the five frames above this one: extracting the whole stack
            # at every sync would weigh on a call that is also timed
            where.append([f"{Path(f.filename).name}:{f.lineno}"
                          for f in traceback.extract_stack(limit=6)[:-1]])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, where


def engine_idle_share(tr, mels, tok, blocks: int = 4):
    """The step loop alone, greedy and sampling blocks: 16 lanes admitted at
    once (96-token budgets; sampled lanes at temperature 0.8, top_k 8),
    ``blocks`` blocks (step + unpack) timed without the profiler, then
    under it for the device time; the idle share is 1 - device / the
    unprofiled wall (as scripts/torch_profile_main_path.py).  Also the
    Python frames of every synchronising CUDA call in one block and in its
    ``unpack`` (``torch.cuda.set_sync_debug_mode``)."""
    import torch
    eng = tr.engine
    prompt = tok.prompt_ids(language="en")
    n = eng.lanes
    syncs = sync_sites
    report = {}
    for sampling in (False, True):
        def admit():
            eng.admit(mels[:n], [prompt] * n, [eng.max_new] * n, [False] * n,
                      list(range(n)), temps=[0.8 * sampling] * n,
                      top_ks=[8 * sampling] * n, seeds=list(range(n)))

        def run():
            for _ in range(blocks):
                eng.unpack(eng.step(sampling))

        admit()
        run()                                     # warm
        admit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        admit()
        prof_wall, busy = _device_ms(run)
        admit()
        torch.cuda.synchronize()
        packed, in_step = syncs(lambda: eng.step(sampling))
        _, in_unpack = syncs(lambda: eng.unpack(packed))
        report["sampling" if sampling else "greedy"] = {
            "wall_ms_per_block": wall_ms / blocks,
            "profiled_wall_ms_per_block": prof_wall / blocks,
            "device_ms_per_block": busy / blocks,
            "idle_share": idle_share(busy, wall_ms),
            "host_syncs_in_step": in_step, "host_syncs_in_unpack": in_unpack}
    return {"blocks": blocks, "block_steps": eng.block_steps, **report}


def http_drive(tr, clip):
    """healthz, one POST, one stream=1 and /v1/stats over loopback."""
    import io
    import threading
    import urllib.request
    import wave
    import numpy as np
    from distil_whisper_tpu_torch.serving import make_http_server
    pcm = (np.clip(clip, -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    body = buf.getvalue()
    httpd = make_http_server(tr, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=120) as r:
            health = json.loads(r.read())
        req = urllib.request.Request(base + "/v1/transcribe?language=en",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            post = json.loads(r.read())
        req = urllib.request.Request(
            base + "/v1/transcribe?language=en&stream=1", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            lines = [json.loads(x) for x in r.read().splitlines() if x]
        with urllib.request.urlopen(base + "/v1/stats", timeout=120) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    if not (health["status"] == "ok" and lines and lines[-1].get("final")
            and lines[-1]["text"] == post["text"] and "stats" in stats):
        raise AssertionError("the HTTP drive failed")
    return {"healthz": health["status"], "post_latency_ms": post["latency_ms"],
            "stream_lines": len(lines),
            "stream_final_latency_ms": lines[-1]["latency_ms"],
            "stats_scheduler": stats["scheduler"]}


# -- the compiled decode loops (CUDA graphs) against the plain step loop ----

GRAPH_BLOCK_SWEEP = (4, 8, 16, 32)   # block lengths timed on distil bf16
LADDER_TOKENS = 32                   # the sequential ladder's budget here
LADDER_FILES_S = (40.0, 50.0)        # its two files, seconds
OWNERLESS_KEPT_BYTES = 128 * 2 ** 20  # what an owner-less generate may leave
#                                      allocated (a library workspace for a
#                                      new stream), against 245 MB of one
#                                      program's cross K/V


def plain_generate():
    """A context in which every caller of ``generate`` takes the plain step
    loop (``generate_eager``): the reference the graphs are held against."""
    import contextlib
    import importlib
    from distil_whisper_tpu_torch import pipeline, serving, serving_engine
    G = importlib.import_module("distil_whisper_tpu_torch.generation.generate")

    def plain(dec, cfg, cross, prompt, opts, temperature=0.0, generator=None,
              pad_len=None, sot_slot=None, dtype=None, graphs=None):
        return G.generate_eager(dec, cfg, cross, prompt, opts, temperature,
                                generator, pad_len, sot_slot, dtype)

    @contextlib.contextmanager
    def patched():
        mods = (G, pipeline, serving, serving_engine)
        saved = [m.generate for m in mods]
        for m in mods:
            m.generate = plain
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.generate = f
    return patched()


def outputs_equal(a, b) -> bool:
    import torch
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def decode_timing(run, repeats: int = 3, cold: bool = False,
                  same=outputs_equal, profile: bool = True):
    """``run()``'s result and its numbers: launches and synchronising calls
    counted around one call (after a first, cold call with ``cold``: a
    capture, whose result must be ``same`` as the warm one's), wall ms
    (host clock to a synchronise, median of ``repeats``; with none, that
    counted call's), and with ``profile`` device ms (the profiler's sum
    over one more call) and the idle share (1 - device / wall)."""
    import torch
    first = run() if cold else None
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, sites = sync_sites(run)
    torch.cuda.synchronize()
    walls = [] if repeats else [(time.perf_counter() - t0) * 1e3]
    launches = read_counts()
    if cold and not same(first, out):
        raise AssertionError("the capturing call and a replay differ")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    busy = _device_ms(run)[1] if profile else None
    return out, {"wall_ms": wall, "device_ms": busy,
                 "idle_share": None if busy is None else idle_share(busy,
                                                                    wall),
                 "host_syncs": len(sites), "launches": launches}


def graph_stats_since(before, owner=None):
    from distil_whisper_tpu_torch.generation import graphs
    now = graphs.read_stats()
    out = {k: now[k] - before[k] for k in now}
    if owner is not None:
        out["pool_bytes"] = graphs.pool_bytes(owner)
    return out


def compare_decode(name, plain_run, graph_run, owner, repeats=3,
                   prompt_len=None, same=outputs_equal, profile_plain=True):
    """One case: the plain loop, then the graphs (the first call captures),
    results ``same`` (bit for bit), launches equal; returns the report,
    with ``prompt_len`` a step's wall and device ms over the plain loop's
    steps (the longest row's generated tokens).  Without
    ``profile_plain`` the plain loop's device ms are not measured."""
    from distil_whisper_tpu_torch.generation import graphs
    plain_out, before = decode_timing(plain_run, repeats, same=same,
                                      profile=profile_plain)
    stats0 = graphs.read_stats()
    graph_out, after = decode_timing(graph_run, repeats, cold=True,
                                     same=same)
    stats = graph_stats_since(stats0, owner)
    if not same(plain_out, graph_out):
        raise AssertionError(f"{name}: graph replay differs from the plain "
                             f"loop")
    if before["launches"] != after["launches"]:
        raise AssertionError(f"{name}: launches {after['launches']} against "
                             f"the plain loop's {before['launches']}")
    report = {"plain": before, "graph": after,
              "captures": stats["captures"],
              "replays_a_call": stats["replays"] / (3 + repeats),
              "capture_s": stats["capture_s"],
              "pool_bytes": stats.get("pool_bytes"), "equal": True}
    if prompt_len is not None:
        steps = int(plain_out.seq_len.max()) - prompt_len
        report["steps"] = steps
        for rep in (before, after):
            rep["wall_ms_per_step"] = rep["wall_ms"] / max(steps, 1)
            if rep["device_ms"] is not None:
                rep["device_ms_per_step"] = rep["device_ms"] / max(steps, 1)
    return report, graph_out


def engine_blocks(eng, mels, prompt, sampling: bool, blocks: int):
    """One admission sequence on ``eng``: 16 lanes admitted (budgets 24-96,
    timestamps on every third lane, on ``sampling`` every other lane at
    temperature 0.8, top-k 8), ``blocks`` blocks, the lanes that finished
    re-admitted after the second and fourth; returns every packed vector
    read on the host."""
    import numpy as np
    n = eng.lanes

    def admit(lanes):
        k = len(lanes)
        eng.admit(mels[[j % len(mels) for j in lanes]], [prompt] * k,
                  [24 + 24 * (j % 4) for j in lanes],
                  [j % 3 == 0 for j in lanes], lanes,
                  temps=[0.8 * (sampling and j % 2 == 0) for j in lanes],
                  top_ks=[8 * sampling] * k, seeds=[100 + j for j in lanes])

    admit(list(range(n)))
    out = []
    for b in range(blocks):
        packed = eng.step(sampling)
        out.append(packed.cpu())
        finished = eng.unpack(packed)[0]
        if b in (1, 3):
            free = [int(j) for j in np.flatnonzero(finished)]
            if free:
                admit(free)
    return out


def engine_block_timing(eng, mels, prompt, sampling: bool, blocks: int = 4):
    """Wall, device ms and idle share of ``blocks`` blocks (step + unpack)
    after 16 lanes were admitted at budget 96; the synchronising calls of
    one step and of its unpack."""
    import torch
    n = eng.lanes

    def admit():
        eng.admit(mels[:n], [prompt] * n, [eng.max_new] * n, [False] * n,
                  list(range(n)), temps=[0.8 * sampling] * n,
                  top_ks=[8 * sampling] * n, seeds=list(range(n)))

    def run():
        for _ in range(blocks):
            eng.unpack(eng.step(sampling))

    admit()
    run()
    admit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    admit()
    _, busy = _device_ms(run)
    admit()
    torch.cuda.synchronize()
    packed, in_step = sync_sites(lambda: eng.step(sampling))
    _, in_unpack = sync_sites(lambda: eng.unpack(packed))
    return {"wall_ms_per_block": wall / blocks,
            "device_ms_per_block": busy / blocks,
            "idle_share": idle_share(busy, wall),
            "host_syncs_in_step": len(in_step),
            "host_syncs_in_unpack": len(in_unpack)}


BEAM_EARLY_EOS_SCALE = -20.0  # the early-stop tree's EOS row factor


def beam_ladder_prompts(tok, n: int, seed: int):
    """``n`` condition-on-prev prompts of the sequential ladder's layout
    ([pad | <|startofprev|> ctx | SOT ...]) with a context of 4 + 3j text
    tokens in row j (seed ``seed``): ``(prompts, pad_len, sot_slot)`` on
    the card."""
    import numpy as np
    import torch
    base = tok.prompt_ids(language="en")
    rng = np.random.default_rng(seed)
    plen = 1 + 4 + 3 * (n - 1) + len(base)
    rows, pads = [], []
    for j in range(n):
        ctx = rng.integers(0, tok.eos, size=4 + 3 * j)
        pad = plen - 1 - len(ctx) - len(base)
        rows.append([0] * pad + [tok.sot_prev] + ctx.tolist() + base)
        pads.append(pad)
    return (torch.tensor(rows, device="cuda"),
            torch.tensor(pads, device="cuda"), plen - len(base))


def compiled_beam_cases(tok, pipe, enc, qpipe, qenc):
    """Beam search on CUDA graphs against ``beam_search_eager``, bit for
    bit with equal launches, on distil-large-v3 at 16 windows x 5 beams x
    128 tokens (80 decode rows): plain, segment timestamps, the ladder's
    left-padded prompts, the int8 lane (the int8 MLP kernel inside the
    captured prefill), every hypothesis finishing early (a copy of the tree
    with the EOS row scaled), and one beam against ``generate``; then the
    block length swept over ``GRAPH_BLOCK_SWEEP``.  Each case reports wall
    and device ms a step (the loop's steps, read from the program's
    cursor), the idle share, host syncs, captures, capture seconds and the
    pool's bytes."""
    import importlib
    import torch
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, beam_search, generate, graphs)
    from distil_whisper_tpu_torch.generation.beam import beam_search_eager
    B = importlib.import_module("distil_whisper_tpu_torch.generation.beam")

    t0 = time.perf_counter()
    dtype, k, pcfg, params = torch.bfloat16, 5, pipe.cfg, pipe.params
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    report = {}

    def opts_of(cfg, **kw):
        return GenerationOptions.from_config(
            cfg, max_new_tokens=128, no_speech_token_id=tok.no_speech, **kw)

    def case(name, dec, cfg, states, prompt_ids, opts, beams=k, repeats=0,
             profile_plain=False, **kw):
        owner = graphs.GraphOwner(f"smoke:{name}")

        def plain():
            return beam_search_eager(dec, cfg, states, prompt_ids, opts,
                                     num_beams=beams, dtype=dtype, **kw)

        def graphed():
            return beam_search(dec, cfg, states, prompt_ids, opts,
                               num_beams=beams, dtype=dtype, graphs=owner,
                               **kw)

        rep, out = compare_decode(name, plain, graphed, owner, repeats,
                                  profile_plain=profile_plain)
        (prog,) = owner.entries.values()
        steps = int(prog.state["cur"][0]) - prompt_ids.shape[1]
        rep.update(steps=steps, rows=prompt_ids.shape[0] * beams,
                   num_beams=beams)
        for side in (rep["plain"], rep["graph"]):
            side["wall_ms_per_step"] = side["wall_ms"] / steps
            if side["device_ms"] is not None:
                side["device_ms_per_step"] = side["device_ms"] / steps
        report[name] = rep
        emit({"phase": f"compiled_decode_path.{name}", **rep})
        del owner, prog
        return out, steps

    # the device cursor's length penalty is the plain loop's, bit for bit
    for lp in (0.5, 1.0, 1.3, 2.0):
        for cur in (5, 37, 132, 448):
            if not torch.equal(
                    B._device_penalty(torch.tensor(cur, device="cuda"), lp),
                    B._penalty(cur, lp, "cuda")):
                raise AssertionError(f"penalty {cur} ** {lp} differs")
    dec = params["decoder"]
    plain_out, steps = case("beam_bf16", dec, pcfg, enc, prompt,
                            opts_of(pcfg), repeats=3, profile_plain=True)
    if steps != 128:
        raise AssertionError(f"the random model's beams stopped after "
                             f"{steps} steps")
    ts_prompt = torch.tensor([tok.prompt_ids(language="en",
                                             no_timestamps=False)] * 16,
                             device="cuda")
    case("beam_timestamps", dec, pcfg, enc, ts_prompt,
         opts_of(pcfg, return_timestamps=True))
    ladder, pads, sot_slot = beam_ladder_prompts(tok, 16, seed=11)
    case("beam_ladder_prompts", dec, pcfg, enc, ladder, opts_of(pcfg),
         pad_len=pads, sot_slot=sot_slot)
    case("beam_int8", qpipe.params["decoder"], qpipe.cfg, qenc, prompt,
         opts_of(qpipe.cfg))
    if report["beam_int8"]["graph"]["launches"]["int8_mlp"] != (
            pcfg.decoder_layers):
        raise AssertionError("the captured int8 beam prefill launched "
                             f"{report['beam_int8']['graph']['launches']}")
    # every hypothesis finishes early: the EOS row of the tied embedding
    # scaled (the graph runs masked steps to the end of its block)
    emb = dec["tok_emb"].clone()
    emb[pcfg.eos_token_id] *= BEAM_EARLY_EOS_SCALE
    _, early = case("beam_early_stop", {**dec, "tok_emb": emb}, pcfg, enc,
                    prompt, opts_of(pcfg))
    del emb
    if not early < 128 - B.BLOCK_STEPS:
        raise AssertionError(f"the early-stop tree ran {early} steps")
    one, _ = case("beam_k1", dec, pcfg, enc, prompt, opts_of(pcfg), beams=1)
    greedy = generate(dec, pcfg, enc, prompt, opts_of(pcfg), dtype=dtype)
    # one beam follows the argmax path while no row emits EOS
    if (greedy.sequences == pcfg.eos_token_id).any() or not torch.equal(
            one.sequences, greedy.sequences):
        raise AssertionError("beam_search(num_beams=1) on graphs differs "
                             "from generate()")
    del one, greedy

    sweep, saved = {}, B.BLOCK_STEPS
    for steps_a_block in GRAPH_BLOCK_SWEEP:
        owner = graphs.GraphOwner(f"smoke:beam_k{steps_a_block}")
        B.BLOCK_STEPS = steps_a_block
        try:
            def run(owner=owner):
                return beam_search(dec, pcfg, enc, prompt, opts_of(pcfg),
                                   num_beams=k, dtype=dtype, graphs=owner)
            ref = run()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1) * 1e3)
        finally:
            B.BLOCK_STEPS = saved
        if not (outputs_equal(ref, out) and outputs_equal(out, plain_out)):
            raise AssertionError(f"beam block length {steps_a_block}: "
                                 "calls differ")
        sweep[steps_a_block] = {"wall_ms": statistics.median(walls),
                                "wall_ms_all": walls}
        del owner
    report["beam_block_sweep"] = sweep
    seconds = time.perf_counter() - t0
    emit({"phase": "compiled_decode_path.beam_block_sweep", "sweep": sweep,
          "beam_cases_s": seconds})
    return report


def phase_compiled_decode_path(tok, bf16):
    """``generate``, beam search, the sequential ladder and the continuous
    engine's blocks as CUDA graphs against the plain step loops, bit for
    bit, at full width (random bf16 weights, seed 0): distil-large-v3 at 16
    windows and 128 new tokens in bf16 and with the five int8 flags, with
    segment timestamps, sampled under one seed; beam search at 5 beams
    (``compiled_beam_cases``); the sequential ladder on 2 files;
    the engine's greedy and sampling blocks over one admission sequence
    (the large-v3 teacher's case runs in ``phase_speculative_path``, on its
    teacher).  Each case reports
    wall and device ms a step and the idle share before (plain) and after
    (graphs), host syncs a call, captures, replays, capture seconds and the
    graph pool's bytes; log-mel, encoder-attention and int8-MLP launches
    around each run equal the plain loop's."""
    import importlib
    import operator
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber,
        generate, generate_eager, graphs)
    from distil_whisper_tpu_torch.generation.generate import BLOCK_STEPS
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving_engine import \
        ContinuousBatchingEngine

    t_phase = time.perf_counter()
    dtype = torch.bfloat16
    cfg = PRESETS["distil-large-v3"]
    pipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                           max_new_tokens=128, params=bf16["params"],
                           cfg=cfg, tokenizer=tok, device="cuda")
    pcfg, params, mels = pipe.cfg, pipe.params, bf16["mels"]
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    ts_prompt = torch.tensor([tok.prompt_ids(language="en",
                                             no_timestamps=False)] * 16,
                             device="cuda")
    report, launches = {}, {}

    def case(name, p_params, p_cfg, enc, prompt_ids, opts, temperature=0.0,
             seed=None, repeats=3):
        owner = graphs.GraphOwner(f"smoke:{name}")

        def gen():
            return (None if seed is None else
                    torch.Generator(device="cuda").manual_seed(seed))

        def plain():
            return generate_eager(p_params["decoder"], p_cfg, enc, prompt_ids,
                                  opts, temperature, gen(), dtype=dtype)

        def graphed():
            return generate(p_params["decoder"], p_cfg, enc, prompt_ids, opts,
                            temperature=temperature, generator=gen(),
                            dtype=dtype, graphs=owner)

        report[name], _ = compare_decode(name, plain, graphed, owner,
                                         repeats, prompt_ids.shape[1])
        del owner
        emit({"phase": f"compiled_decode_path.{name}", **report[name]})

    # 1. distil-large-v3 bf16, greedy, 16 windows x 128 tokens
    enc = W.encode(params["encoder"], pcfg, mels, dtype=dtype)
    greedy = GenerationOptions.from_config(pcfg, max_new_tokens=128,
                                           no_speech_token_id=tok.no_speech)
    case("distil_bf16", params, pcfg, enc, prompt, greedy)
    # one trace summed both ways, on the plain loop and on the graphs: the
    # raw device events (this script's device ms) and the event tree's self
    # device time (32 tokens: the tree costs seconds a 10^4 launches)
    two_sums = {}
    both_owner = graphs.GraphOwner("smoke:two_sums")
    short = GenerationOptions.from_config(pcfg, max_new_tokens=32,
                                          no_speech_token_id=tok.no_speech)
    for label, run in (
            ("plain", lambda: generate_eager(params["decoder"], pcfg, enc,
                                             prompt, short, dtype=dtype)),
            ("graph", lambda: generate(params["decoder"], pcfg, enc, prompt,
                                       short, dtype=dtype,
                                       graphs=both_owner))):
        run()
        wall, raw, tree = _device_ms(run, key_averages=True)
        two_sums[label] = {"wall_ms": wall, "device_ms_raw_events": raw,
                           "device_ms_key_averages": tree}
    del both_owner
    report["device_ms_two_sums"] = two_sums
    emit({"phase": "compiled_decode_path.device_ms_two_sums", **two_sums})
    # a call given no owner captures into one of its own and frees it on
    # return: what it leaves allocated stays far below one program's state
    # (its cross K/V alone are 2 layers x 2 x 16 x 1500 x 1280 x 2 B)
    kept = []
    for _ in range(2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = generate(params["decoder"], pcfg, enc, prompt, greedy,
                       dtype=dtype)
        del out
        torch.cuda.synchronize()
        kept.append(torch.cuda.memory_allocated() - before)
    emit({"phase": "compiled_decode_path.ownerless", "kept_bytes": kept})
    if max(kept) >= OWNERLESS_KEPT_BYTES:
        raise AssertionError(f"a call without an owner kept {kept} bytes")
    report["ownerless_kept_bytes"] = kept
    # the block length: the graph path alone at each K
    sweep = {}
    G = importlib.import_module(
        "distil_whisper_tpu_torch.generation.generate")
    for k in GRAPH_BLOCK_SWEEP:
        owner = graphs.GraphOwner(f"smoke:k{k}")
        G.BLOCK_STEPS = k
        try:
            def run(owner=owner):
                return generate(params["decoder"], pcfg, enc, prompt, greedy,
                                dtype=dtype, graphs=owner)
            ref = run()
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            G.BLOCK_STEPS = BLOCK_STEPS
        if not outputs_equal(ref, out):
            raise AssertionError(f"block length {k}: two calls differ")
        sweep[k] = {"wall_ms": statistics.median(walls),
                    "wall_ms_all": walls}
        del owner
    report["block_sweep"] = sweep
    emit({"phase": "compiled_decode_path.block_sweep", "sweep": sweep})
    # 2. segment timestamps
    ts_opts = GenerationOptions.from_config(
        pcfg, max_new_tokens=128, return_timestamps=True,
        no_speech_token_id=tok.no_speech)
    case("timestamps", params, pcfg, enc, ts_prompt, ts_opts, repeats=0)
    # 3. sampling under one seed (top-k 50, temperature 0.7)
    s_opts = GenerationOptions.from_config(
        pcfg, max_new_tokens=128, do_sample=True, top_k=50,
        no_speech_token_id=tok.no_speech)
    case("sampling", params, pcfg, enc, prompt, s_opts, temperature=0.7,
         seed=0, repeats=0)
    # 4. the int8 lane: the same weights with the five flags
    qpipe = WhisperPipeline(None, dtype=dtype, batch_size=16,
                            max_new_tokens=128, params=bf16["params"],
                            cfg=cfg.replace(**INT8_FLAGS), tokenizer=tok,
                            device="cuda")
    qenc = W.encode(qpipe.params["encoder"], qpipe.cfg, mels, dtype=dtype)
    q_opts = GenerationOptions.from_config(qpipe.cfg, max_new_tokens=128,
                                           no_speech_token_id=tok.no_speech)
    case("distil_int8", qpipe.params, qpipe.cfg, qenc, prompt, q_opts,
         repeats=0)
    # 4b. beam search, 16 windows x 5 beams, bf16 and the int8 lane
    report.update(compiled_beam_cases(tok, pipe, enc, qpipe, qenc))
    del qenc, qpipe

    # 5. through the pipeline: launches of the kernels equal the plain
    # loop's (the encoder launches eagerly; the graphs hold no kernel here)
    clips = bf16["clips"]
    reset_counts()
    with plain_generate():
        plain_texts = pipe(clips, language="en")
    launches["pipeline_plain"] = read_counts()
    reset_counts()
    graph_texts = pipe(clips, language="en")
    launches["pipeline_graph"] = read_counts()
    if plain_texts != graph_texts or (launches["pipeline_plain"]
                                      != launches["pipeline_graph"]):
        raise AssertionError(f"pipeline: texts or launches differ "
                             f"{launches}")

    # 6. the sequential ladder on 2 files (the plain loop patched in)
    files = [a[:int(sec * 16000)] for a, sec in
             zip(synthetic_audio(2, 75.0, seed=7), LADDER_FILES_S)]
    feats = [compute_mel(a, pcfg, pad_to_chunk=False, device="cuda")[0]
             for a in files]
    seq_opts = SequentialOptions(max_new_tokens=LADDER_TOKENS)

    def ladder(tr):
        return tr.transcribe(feats, generator=torch.Generator().manual_seed(0))

    tr = SequentialTranscriber(params, pcfg, tok, seq_opts, language="en",
                               batch_size=16, dtype=dtype, device="cuda")

    def plain_ladder():
        with plain_generate():
            return ladder(tr)

    rep, seq_graph = compare_decode("sequential", plain_ladder,
                                    lambda: ladder(tr), tr.graphs, repeats=0,
                                    same=operator.eq)
    report["sequential"] = {"files": len(files),
                            "max_new_tokens": LADDER_TOKENS, **rep,
                            "segments": sum(len(r["segments"])
                                            for r in seq_graph)}
    emit({"phase": "compiled_decode_path.sequential",
          **report["sequential"]})
    del tr

    # 7. the continuous engine: greedy and sampling blocks, graphs against
    # the eager blocks over one admission sequence
    e_prompt = tok.prompt_ids(language="en")
    engines = {}
    for graphed in (False, True):
        eng = ContinuousBatchingEngine(pipe, lanes=16, block_steps=16,
                                       max_new_tokens=96)
        eng.graphed = graphed
        stats0 = graphs.read_stats()
        t0 = time.perf_counter()
        eng.init_state()
        engines[graphed] = (eng, time.perf_counter() - t0,
                            graph_stats_since(stats0, eng.graphs))
    eng_report = {}
    for sampling in (False, True):
        name = "sampling" if sampling else "greedy"
        seqs = [engine_blocks(engines[g][0], mels, e_prompt, sampling, 6)
                for g in (False, True)]
        if not all(torch.equal(a, b) for a, b in zip(*seqs)):
            raise AssertionError(f"engine {name} blocks: graphs differ from "
                                 f"the eager blocks")
        eng_report[name] = {
            g_name: engine_block_timing(engines[g][0], mels, e_prompt,
                                        sampling)
            for g, g_name in ((False, "plain"), (True, "graph"))}
    eng_report["init_state_s"] = {"plain": engines[False][1],
                                  "graph": engines[True][1]}
    eng_report["captures"] = engines[True][2]["captures"]
    eng_report["capture_s"] = engines[True][2]["capture_s"]
    eng_report["pool_bytes"] = graphs.pool_bytes(engines[True][0].graphs)
    eng_report["equal"] = True
    report["engine"] = eng_report
    emit({"phase": "compiled_decode_path.engine", **eng_report})
    del engines

    seconds = time.perf_counter() - t_phase
    emit({"phase": "compiled_decode_path", "seconds": seconds,
          "block_steps": BLOCK_STEPS, "launches": launches,
          "cases": sorted(report)})
    return {"compiled_decode_pipeline": launches["pipeline_graph"]}


def phase_serving_path(tok, bf16):
    """Both schedulers serving distil-large-v3 at full width on the main
    path's bf16 weights: 16 lanes (continuous, block 16) and batches of 16
    (micro-batch, 50 ms window), server budget 96 tokens, the cell's
    traffic (``serving_traffic``) all at once; then the same traffic on the
    int8 flags; an HTTP drive over loopback; the engine's idle share."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import GenerationOptions
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber

    t_phase = time.perf_counter()
    dtype, lanes, budget = torch.bfloat16, 16, 96
    clips = bf16["clips"] + synthetic_audio(16, 30.0, seed=4)
    longs = synthetic_audio(2, 70.0, seed=5)
    reqs, audio_s = serving_traffic(clips, longs)
    report, launches = {}, {}
    for lane_name, flags in (("bf16", {}), ("int8", INT8_FLAGS)):
        cfg = PRESETS["distil-large-v3"].replace(**flags)
        pipe = WhisperPipeline(None, dtype=dtype, batch_size=lanes,
                               max_new_tokens=budget, params=bf16["params"],
                               cfg=cfg, tokenizer=tok, device="cuda")
        # the greedy requests' reference: the pipeline's batch decode at
        # the server budget, cut at each request's budget (greedy prefix)
        mels = compute_mel(np.stack(clips[:24]), pipe.cfg,
                           device="cuda").to(dtype)
        prompt = tok.prompt_ids(language="en")
        opts = GenerationOptions.from_config(
            pipe.cfg, max_new_tokens=budget, no_speech_token_id=tok.no_speech)
        seqs, lens, _ = pipe._decode_batch(mels, [prompt] * 24, opts, 1, 1.0)
        ref = [tok.decode(seqs[i][:min(int(lens[i]),
                                       len(prompt) + reqs[i][1]["max_new_tokens"])]
                          .tolist()) for i in range(24)]
        for sched in ("continuous", "microbatch"):
            if sched == "continuous":
                tr = ContinuousTranscriber(pipe, batch_size=lanes,
                                           max_new_tokens=budget,
                                           block_steps=16).start()
            else:
                tr = BatchingTranscriber(pipe, batch_size=lanes,
                                         max_wait_ms=50.0,
                                         max_new_tokens=budget).start()
            try:
                serve_all(tr, reqs[:lanes])               # warm-up
                rep, counts, results = run_scheduler(
                    f"{sched}/{lane_name}", tr, reqs, audio_s, 24, ref)
                # the int8 MLP kernel runs in every encoder layer of an
                # encode, and in the decoder's layers in a word-timestamp
                # alignment pass of 256 rows or more
                extra = counts["int8_mlp"] - counts["encoder_attention"]
                dec = pipe.cfg.decoder_layers
                passes = rep["stats"].get("fb_batches",
                                          rep["stats"].get("word_ts_batches"))
                if lane_name == "int8" and not (
                        0 <= extra <= dec * passes and extra % dec == 0):
                    raise AssertionError(f"int8 serving launches {counts}, "
                                         f"{passes} alignment passes")
                if lane_name == "bf16" and counts["int8_mlp"]:
                    raise AssertionError(f"bf16 serving launches {counts}")
                if lane_name == "bf16":
                    # the sampled requests reproduce under their seeds:
                    # each alone, twice; beside the traffic (another
                    # admission batch, so other bf16 roundings in the
                    # encoder) reported
                    sampled = reqs[24:32]
                    again = [serve_all(tr, [r])[0][0]["text"]
                             for r in sampled]
                    twice = [serve_all(tr, [r])[0][0]["text"]
                             for r in sampled]
                    if again != twice:
                        raise AssertionError(f"{sched}: a sampled request "
                                             "did not reproduce")
                    rep["sampled_reproduce_alone"] = True
                    rep["sampled_equal_beside_traffic"] = sum(
                        a == r["text"] for a, r in zip(again, results[24:32]))
                if lane_name == "bf16" and sched == "continuous":
                    rep["http"] = http_drive(tr, clips[0])
                    # where the engine's greedy texts part from the
                    # pipeline's: the reference step's top-two gap
                    rep["near_ties"] = text_near_ties(
                        pipe, mels, seqs, lens,
                        [r["text"] for r in results[:24]], ref, prompt,
                        [reqs[i][1]["max_new_tokens"] for i in range(24)])
            finally:
                tr.stop()
            if lane_name == "bf16" and sched == "continuous":
                rep["step_loop"] = engine_idle_share(tr, mels, tok)
            report[f"{sched}_{lane_name}"] = rep
            rep["launches"] = counts
            emit({"phase": "serving_run", "scheduler": sched,
                  "lane": lane_name, **rep})
            if sched == "continuous":
                launches["serving" if lane_name == "bf16"
                         else "serving_int8"] = counts
            del tr
        del pipe, mels
        torch.cuda.empty_cache()
    for lane_name in ("bf16", "int8"):
        c = report[f"continuous_{lane_name}"]["audio_s_per_s"]
        m = report[f"microbatch_{lane_name}"]["audio_s_per_s"]
        report[f"continuous_over_microbatch_{lane_name}"] = c / m
    emit({"phase": "serving_path", "model": "distil-large-v3",
          "dtype": "bf16", "lanes": lanes, "block_steps": 16,
          "max_new_tokens": budget, "traffic": {
              "single_windows": 32, "sampled": 8, "long_files_s": [70, 70],
              "word_timestamp_burst": 4, "audio_s": audio_s},
          **{k: v for k, v in report.items() if "_over_" in k},
          "seconds": time.perf_counter() - t_phase})
    return launches


def speculative_engines(pipe, draft, clips, greedy_text, gamma, alpha):
    """The continuous engine serving ``pipe``'s model (large-v3): plain
    lanes, the draft under ``synthetic_acceptance`` ``alpha``, and n-gram
    lookup on a period-16 stream (16 requests, 16 lanes, 64-token budgets,
    block 16), each timed on a second drive after a warm-up.  Returns (the
    report, the draft engine's launches)."""
    import torch
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber
    n, e_budget, layers = len(clips), 64, pipe.cfg.encoder_layers
    audio_s = sum(len(c) for c in clips) / 16000
    traffic = [(c, dict(language="en", max_new_tokens=e_budget))
               for c in clips]
    engines, serving_launches = {}, None
    for name, kw in (("plain", {}),
                     ("draft_synthetic_0.8",
                      dict(assistant=draft, synthetic_acceptance=alpha)),
                     ("ngram_synthetic_period_16",
                      dict(ngram_speculative=True, synthetic_period=16))):
        tr = ContinuousTranscriber(pipe, batch_size=n,
                                   max_new_tokens=e_budget, block_steps=16,
                                   gamma=gamma, **kw).start()
        try:
            serve_all(tr, traffic)                        # warm-up
            before = dict(tr.stats)
            reset_counts()
            results, lat, wall = serve_all(tr, traffic)
            torch.cuda.synchronize()
            counts = read_counts()
            st = {k: tr.stats[k] - before[k]
                  for k in ("blocks", "admitted", "tokens_out", "drafted",
                            "accepted") if k in tr.stats}
        finally:
            tr.stop()
        if (counts["log_mel"] != n or counts["int8_mlp"]
                or not counts["encoder_attention"]
                or counts["encoder_attention"] % layers):
            raise AssertionError(f"engine {name} launches {counts}")
        row = {"wall_s": wall, "audio_s_per_s": audio_s / wall,
               "latency_p50_s": _percentile(lat, 50),
               "latency_p95_s": _percentile(lat, 95), **st,
               "launches": counts}
        if name == "plain":
            row["text_equal_to_greedy"] = sum(
                r["text"] == t for r, t in zip(results, greedy_text)) / n
        else:
            # a lane-round that drafted (an n-gram lookup that found no
            # match drafts nothing) proposes gamma tokens
            drafting = st["drafted"] / gamma
            row.update(rounds=st["blocks"] * max(1, 16 // (gamma + 1)),
                       drafting_lane_rounds=drafting,
                       accepted_per_lane_round=st["accepted"]
                       / max(drafting, 1),
                       speedup_over_plain=engines["plain"]["wall_s"] / wall)
            if not st["drafted"]:
                raise AssertionError(f"engine {name} drafted nothing")
        if name.startswith("draft"):
            serving_launches = counts
        engines[name] = row
        del tr
        gc.collect()            # the transcriber's threads hold cycles
        torch.cuda.empty_cache()
    return engines, serving_launches


def speculative_engine_blocks(pipe, draft, mels, prompt, gamma, alpha):
    """The continuous engine's speculative blocks on graphs against the
    eager rounds, bit for bit over one admission sequence
    (:func:`engine_blocks`, 4 blocks at draft length ``gamma``), for the
    draft under ``synthetic_acceptance`` ``alpha`` and for n-gram lookup on
    a period-16 stream (16 lanes, block 16, 64-token budgets), with each
    one's block timing both ways, its captures at ``init_state`` (one
    program a draft length of ``gamma_levels``) and its pool's bytes."""
    import torch
    from distil_whisper_tpu_torch.generation import graphs
    from distil_whisper_tpu_torch.serving_engine import \
        ContinuousBatchingEngine
    report = {}
    for name, kw in (("draft_synthetic_0.8",
                      dict(assistant=draft, synthetic_acceptance=alpha)),
                     ("ngram_synthetic_period_16",
                      dict(ngram_speculative=True, synthetic_period=16))):
        engines = {}
        for graphed in (False, True):
            eng = ContinuousBatchingEngine(pipe, lanes=16, block_steps=16,
                                           max_new_tokens=64, gamma=gamma,
                                           **kw)
            eng.graphed = graphed
            stats0 = graphs.read_stats()
            t0 = time.perf_counter()
            eng.init_state()
            engines[graphed] = (eng, time.perf_counter() - t0,
                                graph_stats_since(stats0, eng.graphs))
        seqs = [engine_blocks(engines[g][0], mels, prompt, False, 4)
                for g in (False, True)]
        if not all(torch.equal(a, b) for a, b in zip(*seqs)):
            raise AssertionError(f"engine {name} blocks: graphs differ from "
                                 f"the eager rounds")
        row = {g_name: engine_block_timing(engines[g][0], mels, prompt,
                                           False, blocks=2)
               for g, g_name in ((False, "plain"), (True, "graph"))}
        eng = engines[True][0]
        row.update(gamma_levels=list(eng.gamma_levels),
                   init_state_s={"plain": engines[False][1],
                                 "graph": engines[True][1]},
                   captures=engines[True][2]["captures"],
                   capture_s=engines[True][2]["capture_s"],
                   pool_bytes=graphs.pool_bytes(eng.graphs), equal=True)
        report[name] = row
        emit({"phase": f"speculative_path.engine_blocks.{name}", **row})
        del engines, eng
        torch.cuda.empty_cache()
    return report


# new tokens of the speculative windows (128 until the multi-GPU phase
# joined the smoke; cut to stay inside the smoke's time)
SPEC_NEW_TOKENS = 64
SPEC_ROUNDS_SWEEP = (1, 2, 4, 8)     # rounds a block timed on large-v3


def phase_speculative_path(tok, bf16):
    """Speculative decoding at full width: large-v3 (32 encoder and 32
    decoder layers) is the teacher, random bf16 weights from seed 0;
    distil-large-v3's 2-layer decoder (seed 1) drafts for it on the
    teacher's encoder states.  On the main path's 16 windows, greedy,
    ``SPEC_NEW_TOKENS`` new tokens (the sequential rung's windows too),
    gamma 5: the teacher's plain greedy,
    draft speculation through ``WhisperPipeline`` (launches counted from 0
    around its first call, which captures), then the decode loops on the
    same encoder states: draft, ``synthetic_acceptance`` 0.8 and n-gram
    lookup with ``synthetic_period`` 16 (both synthetic: their tokens are
    the oracle's, not the model's), each on CUDA graphs against
    ``speculate_eager`` bit for bit, and the synthetic 0.8 loop at each
    of ``SPEC_ROUNDS_SWEEP`` rounds a block; the sequential t = 0 rung
    with the draft on 2 long files, against the plain t = 0 rung; last
    the continuous engine: its speculative blocks on graphs against the
    eager rounds, then serving plain, draft and n-gram traffic."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber, generate,
        generate_eager, graphs)
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    cfg, dcfg = PRESETS["large-v3"], PRESETS["distil-large-v3"]
    dtype, gamma, max_new, n = torch.bfloat16, 5, SPEC_NEW_TOKENS, 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    teacher = init_params(cfg, seed=0, device="cuda", dtype=dtype)
    draft = init_params(dcfg, seed=1, device="cuda", dtype=dtype)
    n_params = sum(x.numel() for x in tree_paths(teacher).values())
    common = dict(dtype=dtype, batch_size=n, max_new_tokens=max_new,
                  params=teacher, cfg=cfg, tokenizer=tok, device="cuda")
    plain = WhisperPipeline(None, **common)
    spec = WhisperPipeline(None, **common, speculative_method="draft",
                           assistant=(draft, dcfg), gamma=gamma)
    clips, audio_s = bf16["clips"], n * 30.0
    bf16_path = {"log_mel": 1, "encoder_attention": cfg.encoder_layers,
                 "encoder_attention_grad": 0, "int8_mlp": 0,
                 "int8_decode_attention": 0}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. the entry point: plain greedy and draft speculation ------------
    stats0 = graphs.read_stats()
    plain(clips, language="en")                # warm-up: captures the decode
    warm_graphs = graph_stats_since(stats0, plain.graphs)
    greedy_text, greedy_s = timed(lambda: plain(clips, language="en"))
    reset_counts()
    stats0 = dict(spec.spec_stats)
    spec_text, spec_first_s = timed(lambda: spec(clips, language="en"))
    launches = read_counts()
    if launches != bf16_path:
        raise AssertionError(f"speculative path launches {launches}, "
                             f"expected {bf16_path}")
    pipe_stats = {k: spec.spec_stats[k] - stats0[k] for k in stats0}
    if pipe_stats["drafted"] <= 0:
        raise AssertionError("the speculative pipeline drafted nothing")
    spec_text2, spec_s = timed(lambda: spec(clips, language="en"))
    if spec_text2 != spec_text:
        raise AssertionError("two speculative runs gave other text")
    text_equal = sum(a["text"] == b["text"]
                     for a, b in zip(spec_text, greedy_text))

    # -- 2. the decode loops on the teacher's encoder states ---------------
    pcfg, dpcfg = spec.cfg, spec.assistant[1]
    mels = compute_mel(np.stack(clips), pcfg, device="cuda").to(dtype)
    enc, encode_s = timed(lambda: W.encode(teacher["encoder"], pcfg, mels,
                                           dtype=dtype))
    if enc.shape != (n, 1500, cfg.d_model) or not torch.isfinite(enc).all():
        raise AssertionError(f"bad teacher encoder states {tuple(enc.shape)}")
    # the teacher's K/V for the near-tie report (the loops project their
    # own inside their graphs)
    t_cross = W.cross_kv(teacher["decoder"], pcfg, enc)
    prompt = torch.tensor([tok.prompt_ids(language="en")] * n, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=max_new,
                                         no_speech_token_id=tok.no_speech)
    p = prompt.shape[1]
    # the plain pipeline's program (captured by its warm-up), on the
    # encoder states: the graph projects the cross K/V itself
    greedy, gen_s = timed(lambda: generate(teacher["decoder"], pcfg, enc,
                                           prompt, opts, dtype=dtype,
                                           graphs=plain.graphs))
    steps = int(greedy.seq_len.max()) - p
    report = {"greedy": {"ms_per_step": gen_s * 1e3 / max(steps, 1),
                         "decode_s": gen_s, "steps": steps,
                         "audio_s_per_s": audio_s / (encode_s + gen_s)}}
    # the teacher's decode as graphs against the plain step loop (the
    # compiled decode loops' large-v3 case; the pipeline's warm-up captured
    # its programs)
    rep, _ = compare_decode(
        "teacher_large_v3",
        lambda: generate_eager(teacher["decoder"], pcfg, enc, prompt, opts,
                               dtype=dtype),
        lambda: generate(teacher["decoder"], pcfg, enc, prompt, opts,
                         dtype=dtype, graphs=plain.graphs),
        plain.graphs, repeats=0, prompt_len=p)
    report["teacher_graphs"] = {**rep, "captured_at_warm_up": warm_graphs}
    emit({"phase": "compiled_decode_path.teacher_large_v3",
          **report["teacher_graphs"]})

    def loop_report(name, out, seconds, synthetic):
        rounds, drafted, accepted = (out.rounds.sum().item(),
                                     out.drafted.sum().item(),
                                     out.accepted.sum().item())
        gen = slice(p, p + max_new)
        share = (out.sequences[:, gen] == greedy.sequences[:, gen]).float()
        row = {"synthetic_tokens": synthetic,
               "rounds_max": int(out.rounds.max()),
               "rounds": rounds, "drafted": drafted, "accepted": accepted,
               "acceptance_rate": accepted / max(drafted, 1),
               "accepted_per_round": accepted / max(rounds, 1),
               "tokens_per_round": (out.seq_len - p - 1).sum().item()
               / max(rounds, 1),
               "decode_s": seconds,
               "ms_per_round": seconds * 1e3 / max(int(out.rounds.max()), 1),
               "audio_s_per_s": audio_s / (encode_s + seconds),
               "share_equal_to_greedy": share.mean().item()}
        if not bool((out.seq_len > p).all()):
            raise AssertionError(f"{name}: a lane emitted nothing")
        if not synthetic:
            # where the tokens part from greedy's: the greedy step's
            # top-two gap there
            row["near_ties"] = near_tie_report(
                teacher["decoder"], pcfg, t_cross,
                [greedy.sequences[b, :int(greedy.seq_len[b])].tolist()
                 for b in range(n)],
                [out.sequences[b, :int(out.seq_len[b])].tolist()
                 for b in range(n)], p, dtype,
                drift_logits=cached_step_logits(teacher["decoder"], pcfg,
                                                t_cross, dtype))
        report[name] = row
        return row

    alpha = 0.8
    # each loop on graphs (an owner of its own, warmed by compare_decode's
    # first call, which captures) against the plain loop, speculate_eager,
    # bit for bit; numbers a round and a token against the greedy graph's
    loops = {
        "draft": (dict(draft=(draft["decoder"], dpcfg, enc)), {}),
        "synthetic_acceptance_0.8": (
            dict(draft=(draft["decoder"], dpcfg, enc),
                 synthetic_acceptance=alpha),
            dict(synthetic_acceptance=alpha)),
        "ngram_synthetic_period_16": (
            dict(max_ngram=3, synthetic_period=16),
            dict(max_ngram=3, synthetic_period=16))}

    def graph_loop(name, owner):
        if name.startswith("ngram"):
            return S.ngram_speculative_generate_batched(
                teacher["decoder"], pcfg, enc, prompt, opts, gamma=gamma,
                dtype=dtype, graphs=owner, **loops[name][1])
        return S.speculative_generate_batched(
            teacher["decoder"], pcfg, draft["decoder"], dpcfg, enc, enc,
            prompt, opts, gamma=gamma, dtype=dtype, graphs=owner,
            **loops[name][1])

    eager_outs = {}
    for name in loops:
        owner = graphs.GraphOwner(f"smoke:{name}")
        rep, out = compare_decode(
            name, lambda: S.speculate_eager(teacher["decoder"], pcfg, enc,
                                            prompt, opts, gamma=gamma,
                                            dtype=dtype, **loops[name][0]),
            lambda: graph_loop(name, owner), owner, repeats=0, prompt_len=p,
            profile_plain=False)
        eager_outs[name] = out
        rounds_max = int(out.rounds.max())
        rep["graph"]["device_ms_per_round"] = (rep["graph"]["device_ms"]
                                               / rounds_max)
        for side in ("plain", "graph"):
            rep[side]["wall_ms_per_round"] = rep[side]["wall_ms"] / rounds_max
            rep[side]["ms_per_token_over_greedy_graph"] = (
                rep[side]["wall_ms_per_step"]
                / report["teacher_graphs"]["graph"]["wall_ms_per_step"])
        rep["rounds_per_block"] = S.ROUNDS_PER_BLOCK
        row = loop_report(name, out, rep["graph"]["wall_ms"] / 1e3,
                          name != "draft")
        row["graphs"] = rep
        emit({"phase": f"speculative_path.{name}", **row})
        del owner
    row = report["synthetic_acceptance_0.8"]
    row["prefix_law_accepted_per_round"] = (alpha * (1 - alpha ** gamma)
                                            / (1 - alpha))
    row["prefix_law_tokens_per_round"] = row[
        "prefix_law_accepted_per_round"] + 1
    # rounds a block, on graphs at each R: the synthetic 0.8 draft loop,
    # and n-gram lookup (period 16) with the main path's distil-large-v3 as
    # the teacher, whose rounds cost a tenth of large-v3's
    sweep_loops = {
        "large_v3_draft_0.8": lambda owner: graph_loop(
            "synthetic_acceptance_0.8", owner),
        "distil_ngram_period_16": lambda owner: (
            S.ngram_speculative_generate_batched(
                bf16["params"]["decoder"], dpcfg, bf16["enc"], prompt, opts,
                gamma=gamma, max_ngram=3, dtype=dtype, synthetic_period=16,
                graphs=owner))}
    sweep, rounds_default = {}, S.ROUNDS_PER_BLOCK
    for loop_name, run in sweep_loops.items():
        ref = eager_outs.get("synthetic_acceptance_0.8"
                             if loop_name.startswith("large") else None)
        sweep[loop_name] = {}
        for r in SPEC_ROUNDS_SWEEP:
            owner = graphs.GraphOwner(f"smoke:r{r}")
            S.ROUNDS_PER_BLOCK = r
            try:
                run(owner)                                  # captures
                walls = []
                for _ in range(2):
                    out, sec = timed(lambda: run(owner))
                    walls.append(sec * 1e3)
            finally:
                S.ROUNDS_PER_BLOCK = rounds_default
            ref = out if ref is None else ref
            if not outputs_equal(out, ref):
                raise AssertionError(f"{loop_name}, {r} rounds a block: "
                                     f"the outputs differ")
            wall = statistics.median(walls)
            sweep[loop_name][r] = {
                "wall_ms": wall, "wall_ms_all": walls,
                "rounds_max": int(out.rounds.max()),
                "ms_per_token": wall / (int(out.seq_len.max()) - p),
                "pool_bytes": graphs.pool_bytes(owner)}
            del owner
    report["rounds_sweep"] = sweep
    emit({"phase": "speculative_path.rounds_sweep", "sweep": sweep})
    del t_cross, enc

    # -- 3. the sequential t = 0 rung with the draft, 2 long files ---------
    # (4 files of 40-75 s before, cut to keep the smoke in its time)
    files = [a[:int(sec * 16000)] for a, sec in
             zip(synthetic_audio(2, 75.0, seed=7), (40.0, 63.0))]
    reset_counts()
    feats = [compute_mel(a, pcfg, pad_to_chunk=False, device="cuda")[0]
             for a in files]
    torch.cuda.synchronize()
    feature_mels = read_counts()["log_mel"]
    # the window budget of the rest of the phase (224 by default; cut to
    # stay inside the smoke's time)
    sopts = SequentialOptions(temperatures=(0.0,), max_new_tokens=max_new)
    seq_plain = SequentialTranscriber(teacher, pcfg, tok, sopts,
                                      language="en", batch_size=n,
                                      dtype=dtype, device="cuda")
    # the raw (params, cfg) pair, as run_eval passes it: the transcriber
    # prepares the draft itself
    seq_spec = SequentialTranscriber(teacher, pcfg, tok, sopts,
                                     language="en", batch_size=n,
                                     dtype=dtype, device="cuda",
                                     speculative_method="draft",
                                     assistant=(draft, dcfg), gamma=gamma)
    a, plain_seq_s = timed(lambda: seq_plain.transcribe(feats))
    reset_counts()
    b, spec_seq_s = timed(lambda: seq_spec.transcribe(feats))
    seq_counts = read_counts()
    if (seq_counts["encoder_attention"] % cfg.encoder_layers
            or not seq_counts["encoder_attention"] or seq_counts["log_mel"]
            or feature_mels != len(files)
            or seq_spec.spec_stats["rounds"] <= 0):
        raise AssertionError(f"sequential speculative launches {seq_counts} "
                             f"(features: mel {feature_mels}), "
                             f"{seq_spec.spec_stats}")
    ka, kb = _segment_keys(a), _segment_keys(b)
    seg_pairs = [(x, y) for ra, rb in zip(ka, kb) for x, y in zip(ra, rb)]
    seq_file_s = sum(len(x) for x in files) / 16000
    report["sequential_t0_draft"] = {
        "files": len(files), "audio_s": seq_file_s,
        "segments": sum(len(r) for r in kb),
        "plain_segments": sum(len(r) for r in ka),
        "segments_equal_to_plain": sum(x == y for x, y in seg_pairs),
        "files_equal_to_plain": sum(ra == rb for ra, rb in zip(ka, kb)),
        "seconds": spec_seq_s, "plain_seconds": plain_seq_s,
        "audio_s_per_s": seq_file_s / spec_seq_s,
        "plain_audio_s_per_s": seq_file_s / plain_seq_s,
        **{k: v for k, v in seq_spec.spec_stats.items()},
        "encode_calls": seq_counts["encoder_attention"] // cfg.encoder_layers}
    # -- 4. the continuous engine serving large-v3 --------------------------
    greedy_text = [tok.decode(greedy.sequences[i, :p + 64].tolist())
                   for i in range(n)]
    report["engine_blocks"] = speculative_engine_blocks(
        plain, (draft, dcfg), mels, tok.prompt_ids(language="en"), gamma,
        alpha)
    engines, serving_launches = speculative_engines(
        plain, (draft, dcfg), clips, greedy_text, gamma, alpha)
    report["serving_engine"] = engines

    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "speculative_path", "teacher": "large-v3",
          "teacher_params": n_params, "draft_model": "distil-large-v3, seed 1",
          "dtype": "bf16", "batch": n, "max_new_tokens": max_new,
          "gamma": gamma, "max_ngram": 3, "launches": launches,
          "pipeline": {"greedy_warm_s": greedy_s,
                       "greedy_audio_s_per_s": audio_s / greedy_s,
                       "draft_first_s": spec_first_s, "draft_warm_s": spec_s,
                       "draft_audio_s_per_s": audio_s / spec_s,
                       "texts_equal_to_greedy": text_equal, **pipe_stats},
          "encode_s": encode_s, **report, "peak_mem_gib": peak})
    del plain, spec, seq_plain, seq_spec, teacher, draft
    torch.cuda.empty_cache()
    return {"speculative": launches,
            "speculative_sequential": {**seq_counts,
                                       "log_mel": feature_mels},
            "serving_speculative": serving_launches}


TRAIN_WORDS = ("the", "cat", "sat", "on", "mat", "a", "dog", "ran", "far",
               "we", "are", "here", "it", "is", "late", "go", "home", "soon",
               "stars", "shine", "bright", "rain", "falls", "slowly", "over",
               "hills", "river", "runs", "deep", "and", "cold", "light")


def training_manifests(root: Path, n: int, n_eval: int, seconds=(5.0, 30.0),
                       seed: int = 20):
    """``n`` synthetic clips of 5-30 s as WAV files under ``root`` and a
    JSONL manifest of them (``audio`` path, ``text``, a pseudo-label
    ``whisper_transcript`` with the special tokens, segment timestamps on
    every other row), plus an eval manifest of the first ``n_eval`` rows
    and a fine-tuning manifest of the first 8.  Texts are 6-14 words, at
    most 100 characters: with the byte-level synthetic tokenizer a label is
    then shorter than 128 tokens."""
    import numpy as np
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli.common import write_jsonl
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        secs = float(rng.uniform(*seconds))
        audio = synthetic_audio(1, secs, seed=seed + i)[0]
        write_wav(str(root / f"clip{i}.wav"), audio, 16000)
        text = " ".join(rng.choice(TRAIN_WORDS, int(rng.integers(6, 15))))[:100]
        body = (f"<|0.00|> {text}<|{secs:.2f}|>" if i % 2
                else f"<|notimestamps|> {text}")
        rows.append({"audio": str(root / f"clip{i}.wav"), "text": text,
                     "whisper_transcript": "<|startoftranscript|><|en|>"
                     f"<|transcribe|>{body}<|endoftext|>"})
    write_jsonl(str(root / "train.jsonl"), rows)
    write_jsonl(str(root / "eval.jsonl"), rows[:n_eval])
    write_jsonl(str(root / "finetune.jsonl"), rows[:8])
    return rows


GRAD_TOL = 1e-2           # atol and rtol of the bf16 gradient comparisons
GRAD_FP32_TOL = 2e-2      # against the fp32 gradient, of its largest value


def kernel_row_encoder_attention_grad(gen):
    """The encoder-attention backward kernel (``csrc/encoder_attention_bwd.cu``,
    behind the ``autograd.Function``: the forward kernel stores its rows'
    log-sum-exp, the backward kernel reads it) at (2, 20, 1500, 64) bf16,
    as the main path's views (H 20) of [2, 1500, 1280] projections, the
    tensor-parallel path's views (H 10 and 5) of [2, 1500, 640] and [2,
    1500, 320] projections, on the ragged (3, 5, 200, 64) with 77 live
    keys and (2, 3, 65, 64) with 64, on one row (1, 1, 1, 64) and on the
    main path's views with 1437 live keys (inside the last 128-key tile, so
    a work item of the persistent schedule is part live, part dead).  Each
    held against ``encoder_attention_bwd_plain`` on the same
    output and lse (the same arithmetic; bf16 casts of P and dS, fp32 sums
    in another order and ``ex2.approx``: a few bf16 ulps, atol/rtol
    ``GRAD_TOL``), against ``encoder_attention_vjp`` (the recompute through
    the plain forward that it replaces, which rounds its gradients to bf16
    at other places: ``GRAD_TOL``) and against the fp32 gradient (bf16
    operands: within ``GRAD_FP32_TOL`` of its largest value); the direct
    call equal bit for bit to the autograd one and to a second call.  Timed
    at the first shape and at the fine-tuning shape (4, 20, 1500, 64): the
    kernel, each pass alone and SDPA's backward in CUDA graphs (the same
    host-free method for all three), both backwards through autograd in a
    graph and back to back from Python, the host microseconds a call; at
    the first shape also the recompute and the plain backward (CUDA events)
    and the extra peak memory of both backwards; the bound."""
    import torch
    from distil_whisper_tpu_torch.ops import encoder_attention as ea

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def heads_view(b, t, h, d):
        return rand(b, t, h * d).view(b, t, h, d).transpose(1, 2)

    def held(qkvg, t_real, label):
        q, k, v, g = qkvg
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        kernel = torch.autograd.grad(ea.encoder_attention(*leaves, t_real),
                                     leaves, g)
        out, lse = ea._launch(q, k, v, t_real, with_lse=True)
        direct = ea.encoder_attention_grad(q, k, v, out, lse, g, t_real)
        again = ea.encoder_attention_grad(q, k, v, out, lse, g, t_real)
        plain = ea.encoder_attention_bwd_plain(q, k, v, out, lse, g, t_real)
        recompute = ea.encoder_attention_vjp(q, k, v, t_real, g)
        f32 = [x.float().requires_grad_(True) for x in (q, k, v)]
        ref = torch.autograd.grad(ea.encoder_attention_plain(*f32, t_real),
                                  f32, g.float())
        torch.cuda.synchronize()
        bits = all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(kernel, direct, again))
        layout = all(x.transpose(1, 2).is_contiguous() for x in direct)
        for name, other in (("plain", plain), ("recompute", recompute)):
            for a, b in zip(kernel, other):
                torch.testing.assert_close(
                    a.float(), b.float(), atol=GRAD_TOL, rtol=GRAD_TOL,
                    msg=lambda m: f"gradient vs {name} at {label}: {m}")
        err = {name: max((a.float() - b.float()).abs().max().item()
                         for a, b in zip(kernel, other))
               for name, other in (("plain", plain), ("recompute", recompute))}
        # relative to each fp32 gradient's largest value; a gradient that
        # is exactly zero in fp32 (dq and dk when T is 1: one key, dS = 0)
        # is held relative to the case's largest fp32 gradient instead
        largest = max(b.abs().max().item() for b in ref)
        rel32 = max((a.float() - b).abs().max().item()
                    / (b.abs().max().item() or largest)
                    for a, b in zip(kernel, ref))
        finite = all(torch.isfinite(x).all() for x in kernel)
        dead = (not kernel[1][:, :, t_real:].any()
                and not kernel[2][:, :, t_real:].any())
        if not (rel32 <= GRAD_FP32_TOL and finite and bits and layout
                and dead):
            raise AssertionError(
                f"encoder attention gradient at {label}: fp32 rel {rel32}, "
                f"finite {finite}, equal bits {bits}, layout {layout}, "
                f"masked keys zero {dead}")
        return {"case": label, "shape": list(q.shape), "t_real": t_real,
                "max_abs_err": err["plain"],
                "max_abs_err_vs_recompute": err["recompute"],
                "max_rel_err_vs_fp32": rel32, "equal_bits_two_calls": bits}

    b, h, t, d = 2, 20, 1500, 64
    q, k, v, g = (rand(b, h, t, d) for _ in range(4))
    cases = [held((q, k, v, g), t, "contiguous")]
    cases.append(held([heads_view(b, t, h, d) for _ in range(4)], t,
                      "views of [2, 1500, 1280] (H 20)"))
    for tp in (2, 4):
        cases.append(held([heads_view(b, t, h // tp, d) for _ in range(4)], t,
                          f"tp {tp}: views of [2, 1500, {h * d // tp}] "
                          f"(H {h // tp})"))
    cases.append(held([rand(3, 5, 200, 64) for _ in range(4)], 77,
                      "ragged (3, 5, 200, 64) / 77"))
    cases.append(held([rand(2, 3, 65, 64) for _ in range(4)], 64,
                      "ragged (2, 3, 65, 64) / 64"))
    cases.append(held([rand(1, 1, 1, 64) for _ in range(4)], 1,
                      "one row (1, 1, 1, 64) / 1"))
    cases.append(held([heads_view(b, t, h, d) for _ in range(4)], 1437,
                      "views of [2, 1500, 1280], 1437 live keys"))
    torch.cuda.empty_cache()

    out, lse = ea._launch(q, k, v, t, with_lse=True)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

    def extra_peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    fn_out = ea.encoder_attention(qg, kg, vg, t)
    extra = extra_peak(lambda: torch.autograd.grad(
        fn_out, (qg, kg, vg), g, retain_graph=True))
    extra_recompute = extra_peak(
        lambda: ea.encoder_attention_vjp(q, k, v, t, g))
    def timings(q, k, v, g):
        """At one shape: the backward, each pass alone (dq alone is the dQ
        pass, which also forms the (lse2, delta) pairs; dk and dv alone are
        that pass without dQ and the dK/dV pass) and SDPA's backward, all
        in CUDA graphs; the backward through the Function's autograd and
        SDPA's, in graphs and back to back from Python."""
        out, lse = ea._launch(q, k, v, t, with_lse=True)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def backward_of(forward):
            def setup():
                y = forward(*leaves)
                return lambda: torch.autograd.grad(y, leaves, g,
                                                   retain_graph=True)
            return setup

        ours = backward_of(lambda *x: ea.encoder_attention(*x, t))
        sdpa = backward_of(torch.nn.functional.scaled_dot_product_attention)
        r = {"ms": cuda_graph_ms(lambda: ea.encoder_attention_grad(
                 q, k, v, out, lse, g, t)),
             "ms_dq_pass": cuda_graph_ms(lambda: ea.encoder_attention_grad(
                 q, k, v, out, lse, g, t, (True, False, False))),
             "ms_dkdv_only": cuda_graph_ms(lambda: ea.encoder_attention_grad(
                 q, k, v, out, lse, g, t, (False, True, True))),
             "library_ms": cuda_graph_ms(None, setup=sdpa),
             "ms_autograd": cuda_graph_ms(None, setup=ours),
             "ms_direct_back_to_back": cuda_ms(
                 lambda: ea.encoder_attention_grad(q, k, v, out, lse, g, t)),
             "ms_autograd_back_to_back": cuda_ms(ours()),
             "library_ms_back_to_back": cuda_ms(sdpa()),
             "host_us_per_call": host_us(lambda: ea.encoder_attention_grad(
                 q, k, v, out, lse, g, t)),
             "host_us_per_autograd_call": host_us(ours())}
        r["ms_vs_library"] = r["ms"] / r["library_ms"]
        return r

    main_times = timings(q, k, v, g)
    ms, library_ms = main_times["ms"], main_times["library_ms"]
    finetune_shape = [4, h, t, d]
    finetune_times = timings(*(heads_view(4, t, h, d) for _ in range(4)))
    recompute_ms = cuda_ms(lambda: ea.encoder_attention_vjp(q, k, v, t, g),
                           reps=5)
    plain_ms = cuda_ms(lambda: ea.encoder_attention_bwd_plain(
        q, k, v, out, lse, g, t), reps=5)
    fwd_lse_ms = cuda_ms(lambda: ea._launch(q, k, v, t, with_lse=True))
    fwd_ms = cuda_ms(lambda: ea._launch(q, k, v, t))
    fwd_bits = torch.equal(ea._launch(q, k, v, t), out)
    if not fwd_bits:
        raise AssertionError("the forward's output changes when it stores lse")
    # the gradient's work: S = QK^T, dV = P^T dO, dP = dO V^T, dQ = dS K,
    # dK = dS^T Q (five T x T x D products; the kernel's dQ pass repeats S
    # and dP: seven); bytes: q, k, v, o, dO and lse read, dq, dk, dv written
    ops = 10 * b * h * t * t * d
    n_bytes = 2 * 8 * b * h * t * d + 4 * b * h * t
    bound_ms, bound_by = bound(n_bytes, ops, BF16_TENSOR)
    row = {"name": "encoder_attention_grad", "route": "cuda",
           "source": "distil_whisper_tpu_torch/csrc/encoder_attention_bwd.cu",
           "replaces": "distil_whisper_tpu/ops/encoder_attention.py:238",
           "max_abs_err": cases[0]["max_abs_err"], "tolerance": GRAD_TOL,
           "max_abs_err_vs_recompute": cases[0]["max_abs_err_vs_recompute"],
           "max_rel_err_vs_fp32": cases[0]["max_rel_err_vs_fp32"],
           "tolerance_vs_fp32": GRAD_FP32_TOL, "held": cases,
           "ms": ms, "tflops": ops / ms / 1e9, **main_times,
           "finetune_shape": finetune_shape, "finetune": finetune_times,
           "recompute_ms": recompute_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_seven_products": bound(n_bytes, 14 * b * h * t * t * d,
                                            BF16_TENSOR)[0],
           "library_ms": library_ms,
           "backward_extra_peak_bytes": extra,
           "backward_extra_peak_mb_per_row": extra / b / 1e6,
           "recompute_extra_peak_mb_per_row": extra_recompute / b / 1e6,
           "forward_ms_lse": fwd_lse_ms, "forward_ms_no_lse": fwd_ms,
           "forward_bits_equal_with_lse": fwd_bits,
           "shape": [b, h, t, d], "ptxas": ptxas_report("encoder_attention_bwd"),
           "sass": sass_report("encoder_attention_bwd"),
           "note": "ms: encoder_attention_grad from a saved forward (the dQ "
                   "and dK/dV launches) in a CUDA graph; ms_autograd: the "
                   "same through the Function's backward; library_ms: "
                   "SDPA's backward, in a graph the same way; *_back_to_back:"
                   " CUDA events around calls from Python; host_us_*: host "
                   "time a call, device work queued; recompute_ms: "
                   "encoder_attention_vjp, the recompute the kernel "
                   "replaced; "
                   "plain_ms: encoder_attention_bwd_plain"}
    del q, k, v, g, qg, kg, vg, out, lse, fn_out
    torch.cuda.empty_cache()
    return row


def range_device_ms(trace: Path, name: str):
    """Summed device time (ms) of a ``record_function`` range in a
    ``torch.profiler`` Chrome trace (its ``gpu_user_annotation`` spans),
    None when the trace has no device timeline."""
    import json
    events = json.loads(trace.read_text()).get("traceEvents", [])
    spans = [e["dur"] for e in events if e.get("name") == name
             and e.get("cat") == "gpu_user_annotation"]
    return sum(spans) / 1e3 if spans else None


def _metrics(out_dir: Path):
    import json
    return [json.loads(line) for line in
            (out_dir / "metrics.jsonl").read_text().splitlines()]


def _train_rows(metrics):
    return [m for m in metrics if "train/loss" in m]


TRAIN_CLIPS = 48      # synthetic clips of 5-30 s in the training manifest
TRAIN_BATCH = 16      # distillation batch, and the eval's
TRAIN_STEPS = 4       # distillation steps
TRAIN_SAVE = 2        # checkpoint every this many steps (resumed from the
#                       first checkpoint)
TRAIN_EVAL_ROWS = 16  # rows of the one eval
FT_BATCH = 4          # fine-tuning batch (unfrozen encoder)
# the inference teacher's encoder states (the kernel) may be no further
# from the fp32 states than this many times the einsum encoder's with the
# same bf16 attention
ENCODER_ROUNDING_FACTOR = 1.1
# step 1's CE and KL under the inference teacher against the train
# teacher's, relative
STEP1_LOSS_TOL = 1e-3


def teacher_encoder_agreement(params, cfg):
    """The teacher's encoder states on four 30 s clips, as each
    ``--teacher_precision`` computes them, against the same encoder in fp32
    (weights and compute, einsum attention): the inference teacher (the
    encoder-attention kernel, bf16 attention), the einsum encoder with the
    same bf16 attention (the control: the size of bf16 rounding with no
    kernel) and the train teacher (einsum, fp32 attention).  Each is the
    relative RMS difference of the final states."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import to_fp32

    enc = params["encoder"]
    mel = compute_mel(np.stack(synthetic_audio(4, 30.0, seed=3)), cfg,
                      device="cuda")

    def states(c, p, dtype):
        with torch.no_grad():
            return W.encode(p, c, mel, dtype=dtype).float()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    bf16 = torch.bfloat16
    fp32 = states(cfg, to_fp32(enc), torch.float32)
    inference = states(cfg.replace(fast_bf16_attention=True,
                                   use_flash_encoder=True), enc, bf16)
    einsum = states(cfg.replace(fast_bf16_attention=True,
                                use_flash_encoder=False), enc, bf16)
    train = states(cfg, enc, bf16)
    return {"clips": 4, "metric": "relative RMS difference of the final "
            "encoder states", "inference_vs_fp32": rel(inference, fp32),
            "einsum_bf16_vs_fp32": rel(einsum, fp32),
            "train_teacher_vs_fp32": rel(train, fp32),
            "kernel_vs_einsum_bf16": rel(inference, einsum),
            "tolerance": f"inference_vs_fp32 <= {ENCODER_ROUNDING_FACTOR} "
                         "x einsum_bf16_vs_fp32"}


def state_differences(a, b, path=""):
    """Paths at which two checkpoint state dicts differ: tensors bit for
    bit (dtype included), every other value by ``==``."""
    import torch
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return [f"{path}: keys"]
        return [d for k in a for d in state_differences(
            a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    return [] if a == b else [path]


TEACHER_LAYERS = 4    # encoder and decoder layers of the training teacher


def training_teacher():
    """The teacher of ``training_path``, ``multigpu_path``,
    ``tensor_parallel_path``, ``param_sharding_path`` and ``recipe_path``:
    large-v3's widths (d_model 1280, 20 heads, 128 mel bins, its vocabulary)
    at ``TEACHER_LAYERS`` encoder and decoder layers.  Every check of those
    phases counts its launches from the config's depth."""
    from distil_whisper_tpu_torch.config import PRESETS
    return PRESETS["large-v3"].replace(encoder_layers=TEACHER_LAYERS,
                                       decoder_layers=TEACHER_LAYERS)


def shared_inputs(teacher_cfg) -> Path:
    """A new directory holding what ``training_path`` leaves there for
    ``multigpu_path`` and ``recipe_path``: the random bf16 teacher (seed
    0) with the synthetic tokenizer, the training manifests and the 2-layer
    student; for running either phase alone.  The caller removes it."""
    import torch
    from distil_whisper_tpu_torch.cli import create_student_model
    from distil_whisper_tpu_torch.models import init_params, save_pretrained
    root = Path(tempfile.mkdtemp(prefix="dw_training_"))
    save_pretrained(init_params(teacher_cfg, seed=0, device="cuda",
                                dtype=torch.bfloat16), teacher_cfg,
                    str(root / "teacher"), dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    synthetic_tokenizer(root / "teacher")
    training_manifests(root, TRAIN_CLIPS, TRAIN_EVAL_ROWS)
    create_student_model.main([
        "--teacher_checkpoint", str(root / "teacher"),
        "--save_dir", str(root / "student"), "--decoder_layers", "2"])
    return root


def phase_training_path(teacher_cfg, root):
    """Distillation through the port's CLIs, at the width of
    ``teacher_cfg`` (``training_teacher``): a random bf16 teacher (seed 0)
    written by ``save_pretrained``, its encoder held with and without the
    encoder-attention kernel; ``create_student_model`` to a 2-layer
    decoder; ``run_distillation`` at half_mixed with the inference teacher
    (``TRAIN_STEPS`` steps of ``TRAIN_BATCH``, warmup 2, checkpoints every
    ``TRAIN_SAVE`` steps, one profiled step, one eval), again for one step
    with the train teacher (step 1's CE and KL against the inference
    teacher's), for 2 steps with the int8 teacher, and resumed from the
    first checkpoint to the end (the later steps and the last checkpoint's
    params, moments and counters equal to the
    uninterrupted run's, bit for bit); ``run_finetuning`` with the unfrozen
    encoder through the encoder-attention kernel and its backward (remat
    on); ``run_eval`` on the distilled checkpoint.  Kernel launches counted
    from 0 around each run.  The phase works in ``root``, where the
    teacher, the student and the manifests stay for ``multigpu_path`` and
    ``recipe_path`` (the caller removes it)."""
    import json
    import logging
    import os
    import shutil
    import statistics
    import tempfile
    import torch
    from distil_whisper_tpu_torch.cli import (create_student_model,
                                              run_distillation, run_eval,
                                              run_finetuning)
    from distil_whisper_tpu_torch.models import init_params, save_pretrained
    from distil_whisper_tpu_torch.models.params import param_count

    logging.basicConfig(level=logging.WARNING)   # the CLIs' INFO stays off
    report = {"teacher": teacher_cfg.d_model,
              "teacher_layers": [teacher_cfg.encoder_layers,
                                 teacher_cfg.decoder_layers],
              # what earlier phases still hold: inside every peak below
              "allocated_before_gib": torch.cuda.memory_allocated() / 2 ** 30}
    try:
        teacher_dir = root / "teacher"
        params = init_params(teacher_cfg, seed=0, device="cuda",
                             dtype=torch.bfloat16)
        report["teacher_params"] = param_count(params)
        report["teacher_encoder_agreement"] = teacher_encoder_agreement(
            params, teacher_cfg)
        t0 = time.perf_counter()
        save_pretrained(params, teacher_cfg, str(teacher_dir),
                        dtype=torch.bfloat16)
        report["save_teacher_s"] = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        synthetic_tokenizer(teacher_dir)
        training_manifests(root, TRAIN_CLIPS, TRAIN_EVAL_ROWS)

        def timed(name, fn, *argv):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(list(argv))
            report[name] = {"s": time.perf_counter() - t0,
                            "launches": read_counts()}
            torch.cuda.empty_cache()
            return out

        student_dir = root / "student"
        timed("create_student", create_student_model.main,
              "--teacher_checkpoint", str(teacher_dir),
              "--save_dir", str(student_dir), "--decoder_layers", "2")

        def distill(out, teacher_precision, max_steps, *extra):
            return ["--teacher_checkpoint", str(teacher_dir),
                    "--student_checkpoint", str(student_dir),
                    "--train_dataset_path", str(root / "train.jsonl"),
                    "--output_dir", str(root / out),
                    "--teacher_precision", teacher_precision,
                    "--precision", "half_mixed",
                    "--per_device_train_batch_size", str(TRAIN_BATCH),
                    "--per_device_eval_batch_size", str(TRAIN_BATCH),
                    "--max_label_length", "128", "--max_steps", str(max_steps),
                    "--warmup_steps", "2", "--learning_rate", "1e-4",
                    "--save_steps", str(TRAIN_SAVE),
                    "--save_total_limit", "2",
                    "--eval_steps", "1000", "--logging_steps", "1",
                    "--language", "en", "--seed", "42",
                    "--wer_threshold", "10", *extra]

        timed("distill_inference", run_distillation.main,
              *distill("inference", "inference", TRAIN_STEPS,
                       "--eval_dataset_path", str(root / "eval.jsonl"),
                       "--eval_max_new_tokens", "32", "--profile_steps", "1"))
        inf = _metrics(root / "inference")
        train = _train_rows(inf)
        times = [m["train/step_time_s"] for m in train]
        tokens = [m["train/label_tokens"] for m in train]
        prof = next(m for m in inf if "profile/device_ms_per_step" in m)
        step_s = statistics.median(times[2:])   # after warm-up
        report["distill_inference"].update({
            "steps": len(train), "batch": TRAIN_BATCH,
            "loss": [m["train/loss"] for m in train],
            "ce": [m["train/ce_loss"] for m in train],
            "kl": [m["train/kl_loss"] for m in train],
            "grad_norm": [m["train/grad_norm"] for m in train],
            "step_time_s": times,
            "step_time_s_median_from_3": step_s,
            "label_tokens_per_step": tokens,
            "label_tokens_per_s": statistics.mean(tokens) / step_s,
            "peak_mem_gib_steps": max(m.get("train/peak_mem_gib", 0)
                                      for m in train),
            "peak_mem_gib_steps_and_eval":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "profiled_step": {k.split("/")[1]: v for k, v in prof.items()
                              if k.startswith("profile/")},
            "idle_share_profiled": 1 - prof["profile/device_ms_per_step"]
            / prof["profile/wall_ms_per_step"],
            "eval": [m for m in inf if "eval/wer" in m],
            "checkpoints": sorted(p.name for p in (root / "inference").iterdir()
                                  if p.name.startswith("checkpoint-"))})

        timed("distill_train_teacher", run_distillation.main,
              *distill("train_teacher", "train", 1))
        ref = _train_rows(_metrics(root / "train_teacher"))[0]
        report["inference_vs_train_teacher_step1"] = {
            "ce": [train[0]["train/ce_loss"], ref["train/ce_loss"]],
            "kl": [train[0]["train/kl_loss"], ref["train/kl_loss"]],
            "ce_rel_diff": abs(train[0]["train/ce_loss"] - ref["train/ce_loss"])
            / ref["train/ce_loss"],
            "kl_rel_diff": abs(train[0]["train/kl_loss"] - ref["train/kl_loss"])
            / ref["train/kl_loss"],
            "tolerance": STEP1_LOSS_TOL}
        shutil.rmtree(root / "train_teacher")

        timed("distill_int8_teacher", run_distillation.main,
              *distill("int8", "int8", 2))
        report["distill_int8_teacher"]["loss"] = [
            m["train/loss"] for m in _train_rows(_metrics(root / "int8"))]
        shutil.rmtree(root / "int8")

        # the resumed run keeps the schedule (the same --max_steps) and runs
        # to the end; hard links, so its rotation cannot touch the original
        resume = root / "resume"
        resume.mkdir()
        shutil.copytree(root / "inference" / f"checkpoint-{TRAIN_SAVE}",
                        resume / f"checkpoint-{TRAIN_SAVE}",
                        copy_function=os.link)
        timed("distill_resume", run_distillation.main,
              *distill("resume", "inference", TRAIN_STEPS,
                       "--resume_from_checkpoint"))
        resumed = _train_rows(_metrics(resume))
        states = [torch.load(d / f"checkpoint-{TRAIN_STEPS}" / "state.pt",
                             map_location="cpu", weights_only=True)
                  for d in (root / "inference", resume)]
        report["resume"] = {
            "steps": [m["step"] for m in resumed],
            "loss": [m["train/loss"] for m in resumed],
            "uninterrupted_loss": [m["train/loss"]
                                   for m in train[TRAIN_SAVE:]],
            "grad_norm": [m["train/grad_norm"] for m in resumed],
            "uninterrupted_grad_norm": [m["train/grad_norm"]
                                        for m in train[TRAIN_SAVE:]],
            "last_checkpoint_moment_tensors": len(states[0]["mu"]),
            "last_checkpoint_differences": state_differences(*states)}
        del states
        shutil.rmtree(resume)

        # fine-tune the distilled checkpoint with the encoder trained through
        # the kernel: its config with the encoder-attention kernel on
        distilled = root / "inference" / "end-of-training-weights"
        ft_src = root / "ft_src"
        ft_src.mkdir()
        for f in distilled.iterdir():
            if f.name != "config.json":
                os.symlink(f, ft_src / f.name)
        cfg_json = json.loads((distilled / "config.json").read_text())
        cfg_json["use_flash_encoder"] = True
        (ft_src / "config.json").write_text(json.dumps(cfg_json))
        timed("finetune", run_finetuning.main,
              "--model_checkpoint", str(ft_src),
              "--train_dataset_path", str(root / "finetune.jsonl"),
              "--output_dir", str(root / "finetune"), "--max_steps", "3",
              "--per_device_train_batch_size", str(FT_BATCH),
              "--warmup_steps", "1", "--learning_rate", "1e-5",
              "--max_label_length", "128", "--language", "en",
              "--logging_steps", "1", "--save_steps", "1000",
              "--gradient_checkpointing", "--profile_steps", "1",
              "--profile_dir", str(root / "ft_trace"))
        ft_metrics = _metrics(root / "finetune")
        ft = _train_rows(ft_metrics)
        ft_prof = next(m for m in ft_metrics
                       if "profile/device_ms_per_step" in m)
        report["finetune"].update({
            "batch": FT_BATCH, "unfrozen_encoder": True, "remat": True,
            "loss": [m["train/loss"] for m in ft],
            "step_time_s": [m["train/step_time_s"] for m in ft],
            "peak_mem_gib_steps": max(m.get("train/peak_mem_gib", 0)
                                      for m in ft),
            "profiled_step": {k.split("/")[1]: v for k, v in ft_prof.items()
                              if k.startswith("profile/")},
            "idle_share_profiled": 1 - ft_prof["profile/device_ms_per_step"]
            / ft_prof["profile/wall_ms_per_step"],
            "attention_backward_device_ms": range_device_ms(
                root / "ft_trace" / "trace.json", "encoder_attention_grad")})
        shutil.rmtree(root / "finetune")

        result = timed("eval", run_eval.main,
                       "--model_checkpoint", str(distilled),
                       "--dataset_path", str(root / "eval.jsonl"),
                       "--mode", "short", "--language", "en",
                       "--batch_size", str(TRAIN_BATCH),
                       "--max_new_tokens", "32", "--dtype", "bfloat16")
        report["eval"]["result"] = result
    finally:   # the inputs stay; the runs' outputs go
        for name in ("inference", "ft_src", "ft_trace", "train_teacher",
                     "int8", "resume", "finetune"):
            shutil.rmtree(root / name, ignore_errors=True)

    emit({"phase": "training_path", **report})
    bad = []
    inf = report["distill_inference"]
    if not all(map(math.isfinite, inf["loss"] + inf["grad_norm"])):
        bad.append("non-finite distillation loss")
    if inf["steps"] != TRAIN_STEPS or inf["checkpoints"] != [
            f"checkpoint-{TRAIN_SAVE}", f"checkpoint-{TRAIN_STEPS}",
            next(n for n in inf["checkpoints"] if "val-wer" in n)]:
        bad.append(f"steps/checkpoints {inf['steps']} {inf['checkpoints']}")
    enc = report["teacher_encoder_agreement"]
    if not enc["inference_vs_fp32"] <= (ENCODER_ROUNDING_FACTOR
                                        * enc["einsum_bf16_vs_fp32"]):
        bad.append(f"the kernel's teacher encoder is off the fp32 one: {enc}")
    agree = report["inference_vs_train_teacher_step1"]
    if not (agree["ce_rel_diff"] <= STEP1_LOSS_TOL
            and agree["kl_rel_diff"] <= STEP1_LOSS_TOL):
        bad.append(f"inference teacher disagrees with the train teacher: "
                   f"{agree}")
    res = report["resume"]
    if (res["steps"] != list(range(TRAIN_SAVE + 1, TRAIN_STEPS + 1))
            or res["loss"] != res["uninterrupted_loss"]
            or res["grad_norm"] != res["uninterrupted_grad_norm"]
            or res["last_checkpoint_differences"]):
        bad.append(f"resume: {res}")
    if not all(map(math.isfinite, report["finetune"]["loss"])):
        bad.append("non-finite fine-tuning loss")
    n_layers = teacher_cfg.encoder_layers
    want = {"distill_inference": dict(
                log_mel=TRAIN_CLIPS + TRAIN_EVAL_ROWS,
                encoder_attention=n_layers * (TRAIN_STEPS + 1), int8_mlp=0),
            # the int8 MLP kernel runs in the teacher's encoder and, at
            # 16 x 127 >= 256 rows, in its decoder too
            "distill_int8_teacher": dict(
                log_mel=TRAIN_CLIPS, encoder_attention=2 * n_layers,
                int8_mlp=2 * (n_layers + teacher_cfg.decoder_layers)),
            "distill_train_teacher": dict(log_mel=TRAIN_CLIPS,
                                          encoder_attention=0, int8_mlp=0),
            "distill_resume": dict(
                log_mel=TRAIN_CLIPS,
                encoder_attention=n_layers * (TRAIN_STEPS - TRAIN_SAVE),
                int8_mlp=0),
            "eval": dict(log_mel=1, encoder_attention=n_layers)}
    for run, counts in want.items():
        got = report[run]["launches"]
        if any(got[k] != v for k, v in counts.items()):
            bad.append(f"{run} launches {got}, want {counts}")
    # three steps under remat: a forward and its recompute a layer a step,
    # and one backward kernel call a layer a step
    ft_launches = report["finetune"]["launches"]
    if (ft_launches["encoder_attention"] != 6 * n_layers
            or ft_launches["encoder_attention_grad"] != 3 * n_layers):
        bad.append(f"finetune launches {ft_launches}")
    if bad:
        raise AssertionError("training path: " + "; ".join(bad))
    return {name: report[name]["launches"] for name in
            ("distill_inference", "distill_int8_teacher", "finetune", "eval")}


RECIPE_CLIPS = 32         # synthetic clips of 5-30 s, two speakers: two
#                           batches of 16, so a steady rate past the first
RECIPE_BATCH = 16         # pseudo-labelling and QAT distillation batch
RECIPE_NEW_TOKENS = 64    # the pseudo-labelling budget (32 on the int8 run;
#                           128 until the multi-GPU phase joined the smoke)
STUDENT_LAYERS = 2        # decoder layers of the student (distil-large-v3)
QAT_STEPS = 4             # QAT distillation steps, and the plain run's
QAT_FT_STEPS = 3          # QAT fine-tuning steps (the third one profiled)
QAT_FT_BATCH = 4
# the w8a8 fake-quant decoder's logits against the int8 decoder's
# (JAX's tests/test_qat.py::test_qat_forward_matches_int8_serving_forward)
QAT_LOGITS_TOL = 1e-3
RECIPE_REF_CLIPS = 6      # the small card-vs-CPU pseudo-labelling reference


def recipe_manifests(root: Path):
    """The pseudo-labelling inputs under ``root``: ``RECIPE_CLIPS`` clips of
    5-30 s (the training manifests' clips) with a speaker column of two
    speakers (``pl.jsonl``), its first ``RECIPE_BATCH`` rows without a
    speaker (``pl_int8.jsonl``) and a small one of ``RECIPE_REF_CLIPS`` clips
    of 8-14 s, so that each speaker's clips pack into two rows, the second
    conditioned on the first (``pl_ref.jsonl``)."""
    from distil_whisper_tpu_torch.cli.common import write_jsonl
    rows = [{"audio": r["audio"], "text": r["text"],
             "speaker_id": f"spk{i % 2}"}
            for i, r in enumerate(training_manifests(root, RECIPE_CLIPS, 0))]
    write_jsonl(str(root / "pl.jsonl"), rows)
    write_jsonl(str(root / "pl_int8.jsonl"),
                [{"audio": r["audio"], "text": r["text"]}
                 for r in rows[:RECIPE_BATCH]])
    ref = root / "ref"
    ref.mkdir()
    ref_rows = training_manifests(ref, RECIPE_REF_CLIPS, 0,
                                  seconds=(8.0, 14.0), seed=40)
    write_jsonl(str(root / "pl_ref.jsonl"),
                [{"audio": r["audio"], "text": r["text"],
                  "speaker_id": f"spk{i % 2}"} for i, r in enumerate(ref_rows)])


def recipe_small_reference(root: Path):
    """A tiny fp32 model (test-tiny with 64-wide heads, seed 3) pseudo-labels
    the small manifest on the card and on the CPU: the manifests'
    ``whisper_transcript`` and ``condition_on_prev`` must be equal."""
    import json
    from distil_whisper_tpu_torch.cli import run_pseudo_labelling

    ckpt = small_checkpoint(root)
    out = {}
    for device in ("cuda", "cpu"):
        manifest = run_pseudo_labelling.main([
            "--model_checkpoint", str(ckpt),
            "--dataset_path", str(root / "pl_ref.jsonl"),
            "--output_dir", str(root / f"ref_{device}"),
            "--speaker_id_column_name", "speaker_id", "--language", "en",
            "--per_device_batch_size", "4", "--max_new_tokens", "24",
            "--dtype", "float32", "--device", device])
        out[device] = [json.loads(line) for line in
                       Path(manifest).read_text().splitlines()]
    keys = ("text", "whisper_transcript", "condition_on_prev")
    same = [all(a[k] == b[k] for k in keys)
            for a, b in zip(out["cuda"], out["cpu"])]
    return {"rows": len(out["cpu"]),
            "rows_equal": sum(same) if len(out["cuda"]) == len(out["cpu"])
            else 0,
            "with_condition_on_prev": sum(bool(r["condition_on_prev"])
                                          for r in out["cpu"])}


def qat_vs_int8_logits(student_dir: Path, root: Path):
    """The converted QAT student (fp32 on the card) on one teacher-forced
    batch (``RECIPE_BATCH`` clips, 64 random tokens), its decoder as the
    w8a8 fake-quant tree and as the int8 tree (``quantize_decoder``).

    Every quantized projection of the int8 pass (cross K/V, self and cross
    q/k/v/out, fc1, fc2 of each layer) is recomputed from the same input
    through the fake-quant tree: each must agree with the int8 product at
    rtol=atol=``QAT_LOGITS_TOL`` (``excess`` <= 0), the claim of JAX's
    tests/test_qat.py that ``x_fq @ w_fq`` is the int8 product up to the
    rounding of the dequantized operands.  End to end the two passes part
    further: an activation within that rounding of a level boundary rounds
    to the other level in one pass, and later layers amplify the step; so
    the logits are reported, and held only to be closer to the int8 pass
    than the fp32 model is."""
    import json
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.audio.io import load_audio
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.ops.qat import fake_quant_student_params
    from distil_whisper_tpu_torch.ops.quant import quantize_decoder_params

    params, cfg = load_params(str(student_dir), device="cuda")
    rows = [json.loads(line) for line in
            (root / "pl_int8.jsonl").read_text().splitlines()]
    audio = np.zeros((len(rows), cfg.n_samples), np.float32)
    for j, r in enumerate(rows):
        a = load_audio(r["audio"])[:cfg.n_samples]
        audio[j, :len(a)] = a
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 50257, (len(rows), 64))).cuda()
    qat = fake_quant_student_params(params, "w8a8")["decoder"]
    int8 = quantize_decoder_params(params["decoder"])

    def decode_recording(dec):
        """Logits, and the (params, input) of every projection in order."""
        calls, dense = [], W.dense

        def recording(p, x, group=None):
            calls.append((p, x))
            return dense(p, x, group)
        W.dense = recording
        try:
            return W.decode(dec, cfg, tokens, enc=enc)[0], calls
        finally:
            W.dense = dense

    with torch.no_grad():
        enc = W.encode(params["encoder"], cfg, compute_mel(audio, cfg,
                                                           device="cuda"))
        l_qat, qat_calls = decode_recording(qat)
        l_int8, int8_calls = decode_recording(int8)
        l_fp32 = W.decode(params["decoder"], cfg, tokens, enc=enc)[0]
        excess = []
        for (pq, _), (pi, x) in zip(qat_calls, int8_calls):
            y_int8 = W.dense(pi, x)
            excess.append(((W.dense(pq, x) - y_int8).abs()
                           - QAT_LOGITS_TOL * (1 + y_int8.abs())).max().item())

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return {"rows": len(rows), "tokens": 64, "dtype": "fp32",
            "projections": len(int8_calls),
            "same_projection_sequence": len(qat_calls) == len(int8_calls),
            "tolerance": f"rtol=atol={QAT_LOGITS_TOL} per projection",
            "excess": max(excess),
            "logits_max_abs_diff": (l_qat - l_int8).abs().max().item(),
            "logits_abs_max": l_int8.abs().max().item(),
            "logits_rel_l2_qat_vs_int8": rel(l_qat, l_int8),
            "logits_rel_l2_fp32_vs_int8": rel(l_fp32, l_int8)}


def phase_recipe_path(teacher_cfg, shared):
    """The rest of the recipe through the port's CLIs, at the width of
    ``teacher_cfg`` (``training_teacher``): a random bf16 teacher (seed 0)
    pseudo-labels ``RECIPE_CLIPS`` clips of two speakers (``RECIPE_BATCH`` a batch,
    ``RECIPE_NEW_TOKENS`` new tokens, two featurizer workers, WER and a
    publish mirror), then one batch with all five int8 flags at 32 tokens;
    the student of ``training_path`` distils from the pseudo-labelled
    manifest (its audio, texts and ``condition_on_prev`` prompts) with
    ``--streaming --quantize_student w8a8`` (``QAT_STEPS`` steps, half_mixed, the inference teacher) and
    again without QAT for the step-time comparison;
    ``run_finetuning --quantize_student w8a8`` trains the QAT student with
    its encoder unfrozen through the encoder-attention kernel and its
    backward kernel (remat); ``convert_checkpoint_to_hf`` exports the QAT
    checkpoint (reloaded bit for bit), whose w8a8 fake-quant decoder agrees
    with its int8 decoder projection by projection, and the port's int8
    pipeline serves it on 16 windows; a tiny model pseudo-labels on the
    card as on the CPU.  Kernel launches counted from 0 around each run.
    The teacher and the student (the same seed and cut) are ``shared``'s,
    the directory of ``training_path`` (or of :func:`shared_inputs`)."""
    import json
    import logging
    import os
    import shutil
    import statistics
    import tempfile
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.cli import (convert_checkpoint_to_hf,
                                              run_distillation, run_finetuning,
                                              run_pseudo_labelling)
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    logging.basicConfig(level=logging.WARNING)   # the CLIs' INFO stays off
    root = Path(tempfile.mkdtemp(prefix="dw_recipe_"))
    report = {"teacher": teacher_cfg.d_model,
              "allocated_before_gib": torch.cuda.memory_allocated() / 2 ** 30}
    try:
        teacher_dir = shared / "teacher"
        tok = synthetic_tokenizer(teacher_dir)
        recipe_manifests(root)

        def timed(name, fn, *argv):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(list(argv))
            torch.cuda.synchronize()
            report[name] = {"s": time.perf_counter() - t0,
                            "launches": read_counts()}
            emit({"phase": "recipe_step", "step": name, **report[name]})
            torch.cuda.empty_cache()
            return out

        def pseudo_label(name, manifest, new_tokens, *extra):
            out_dir = root / name
            path = timed(name, run_pseudo_labelling.main,
                         "--model_checkpoint", str(teacher_dir),
                         "--dataset_path", str(root / manifest),
                         "--output_dir", str(out_dir), "--language", "en",
                         "--per_device_batch_size", str(RECIPE_BATCH),
                         "--max_new_tokens", str(new_tokens),
                         "--logging_steps", "1", *extra)
            stats = json.loads((out_dir / "pl_stats.json").read_text())
            rows = [json.loads(line) for line in
                    Path(path).read_text().splitlines()]
            csv_rows = (out_dir / "transcriptions.csv").read_text().splitlines()
            report[name].update({
                "rows": stats["rows"], "batches": stats["batches"],
                "audio_s": stats["audio_s"],
                "audio_s_per_s_steady": stats["rtfx_steady_state"],
                "audio_s_per_s_wall": stats["audio_s"] / report[name]["s"],
                "generated_tokens_per_row":
                    stats["generated_tokens"] / max(stats["rows"], 1),
                "manifest_rows": len(rows), "csv_rows": len(csv_rows) - 1,
                "with_condition_on_prev":
                    sum(bool(r["condition_on_prev"]) for r in rows),
                "wer_counts": stats["wer_counts"]})
            return path

        manifest = pseudo_label(
            "pseudo_label", "pl.jsonl", RECIPE_NEW_TOKENS,
            "--speaker_id_column_name", "speaker_id", "--compute_wer",
            "--featurizer_workers", "2", "--publish_dir", str(root / "mirror"))
        report["pseudo_label"]["mirror_files"] = sorted(
            p.name for p in (root / "mirror").iterdir())
        pseudo_label("pseudo_label_int8", "pl_int8.jsonl", 32,
                     "--no_concatenate_audio",
                     *[f"--{f}" for f in sorted(INT8_FLAGS)])

        student_dir = shared / "student"

        def distill(name, *extra):
            timed(name, run_distillation.main,
                  "--teacher_checkpoint", str(teacher_dir),
                  "--student_checkpoint", str(student_dir),
                  "--train_dataset_path", manifest,
                  "--output_dir", str(root / name), "--streaming",
                  "--shuffle_buffer_size", "64",
                  "--teacher_precision", "inference",
                  "--precision", "half_mixed",
                  "--per_device_train_batch_size", str(RECIPE_BATCH),
                  # the labels are the texts: the synthetic tokenizer has no
                  # merges, so it encodes a generated word " w12363" again
                  # as its 7 bytes, and 128 generated tokens become ~850
                  # label tokens, past the decoder's 448 positions (the
                  # pseudo-label column is trained on in the CPU tests)
                  "--no_pseudo_labels", "--max_label_length", "256",
                  "--max_steps", str(QAT_STEPS), "--warmup_steps", "1",
                  "--learning_rate", "1e-4", "--save_steps", str(QAT_STEPS),
                  "--logging_steps", "1", "--language", "en", "--seed", "42",
                  *extra)
            train = _train_rows(_metrics(root / name))
            times = [m["train/step_time_s"] for m in train]
            report[name].update({
                "steps": len(train), "batch": RECIPE_BATCH,
                "loss": [m["train/loss"] for m in train],
                "grad_norm": [m["train/grad_norm"] for m in train],
                "step_time_s": times,
                "step_time_s_median_2_to_4": statistics.median(times[1:]),
                "label_tokens_per_step": [m["train/label_tokens"]
                                          for m in train],
                "peak_mem_gib_steps": max(m.get("train/peak_mem_gib", 0)
                                          for m in train)})

        distill("distill_qat", "--quantize_student", "w8a8")
        distill("distill_plain")
        shutil.rmtree(root / "distill_plain")
        report["qat_step_overhead"] = (
            report["distill_qat"]["step_time_s_median_2_to_4"]
            / report["distill_plain"]["step_time_s_median_2_to_4"] - 1)

        # the QAT student fine-tuned with its encoder trained through the
        # kernel: its config with the encoder-attention kernel on
        distilled = root / "distill_qat" / "end-of-training-weights"
        ft_src = root / "ft_src"
        ft_src.mkdir()
        for f in distilled.iterdir():
            if f.name != "config.json":
                os.symlink(f, ft_src / f.name)
        cfg_json = json.loads((distilled / "config.json").read_text())
        cfg_json["use_flash_encoder"] = True
        (ft_src / "config.json").write_text(json.dumps(cfg_json))
        ft_rows = [json.loads(line) for line in
                   Path(manifest).read_text().splitlines()][:8]
        (root / "ft.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in ft_rows))
        timed("finetune_qat", run_finetuning.main,
              "--model_checkpoint", str(ft_src),
              "--train_dataset_path", str(root / "ft.jsonl"),
              "--output_dir", str(root / "finetune_qat"),
              "--quantize_student", "w8a8",
              "--max_steps", str(QAT_FT_STEPS),
              "--per_device_train_batch_size", str(QAT_FT_BATCH),
              "--warmup_steps", "1", "--learning_rate", "1e-5",
              "--max_label_length", "256", "--language", "en",
              "--logging_steps", "1", "--save_steps", "1000",
              "--gradient_checkpointing", "--profile_steps", "1",
              "--profile_dir", str(root / "ft_trace"))
        ft_metrics = _metrics(root / "finetune_qat")
        ft = _train_rows(ft_metrics)
        ft_prof = next(m for m in ft_metrics
                       if "profile/device_ms_per_step" in m)
        report["finetune_qat"].update({
            "batch": QAT_FT_BATCH, "unfrozen_encoder": True, "remat": True,
            "loss": [m["train/loss"] for m in ft],
            "step_time_s": [m["train/step_time_s"] for m in ft],
            "peak_mem_gib_steps": max(m.get("train/peak_mem_gib", 0)
                                      for m in ft),
            "profiled_step": {k.split("/")[1]: v for k, v in ft_prof.items()
                              if k.startswith("profile/")},
            "attention_backward_device_ms": range_device_ms(
                root / "ft_trace" / "trace.json", "encoder_attention_grad")})
        shutil.rmtree(root / "finetune_qat")

        converted = root / "converted"
        timed("convert", convert_checkpoint_to_hf.main,
              "--checkpoint_dir", str(root / "distill_qat"),
              "--base_checkpoint", str(student_dir),
              "--save_dir", str(converted))
        sd = torch.load(root / "distill_qat" / f"checkpoint-{QAT_STEPS}"
                        / "state.pt", map_location="cuda", weights_only=True)
        reloaded = tree_paths(load_params(str(converted), device="cuda")[0])
        report["convert"]["differing_leaves"] = sorted(
            p for p, x in sd["params"].items()
            if not torch.equal(reloaded[p], x.float()))
        report["convert"]["leaves"] = len(sd["params"])
        del sd, reloaded
        report["qat_vs_int8_logits"] = qat_vs_int8_logits(converted, root)
        torch.cuda.empty_cache()

        cfg = WhisperConfig.from_pretrained(str(converted)).replace(
            **INT8_FLAGS)
        pipe = WhisperPipeline(str(converted), dtype=torch.bfloat16,
                               batch_size=16, max_new_tokens=64, cfg=cfg,
                               tokenizer=tok, device="cuda")
        clips = synthetic_audio(16, 30.0, seed=11)
        results = timed("int8_pipeline", lambda _: pipe(clips, language="en"))
        report["int8_pipeline"]["texts_nonempty"] = sum(
            bool(r["text"].strip()) for r in results)
        del pipe
        torch.cuda.empty_cache()

        report["small_reference"] = recipe_small_reference(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    emit({"phase": "recipe_path", **report})
    bad = []
    n_layers = teacher_cfg.encoder_layers
    for name, mlp in (("pseudo_label", 0), ("pseudo_label_int8", n_layers)):
        r = report[name]
        b = r["batches"]
        want = dict(log_mel=b, encoder_attention=n_layers * b,
                    encoder_attention_grad=0, int8_mlp=mlp * b,
                    int8_decode_attention=0)
        if r["launches"] != want:
            bad.append(f"{name} launches {r['launches']}, want {want}")
        if not (b >= 1 and r["rows"] == r["manifest_rows"] == r["csv_rows"]
                and r["generated_tokens_per_row"] > 0):
            bad.append(f"{name}: {r}")
    pl = report["pseudo_label"]
    if pl["batches"] < 2 or not pl["with_condition_on_prev"]:
        bad.append(f"pseudo_label packed nothing or ran one batch: {pl}")
    if not {"transcriptions.csv", "dataset.jsonl",
            "audio"} <= set(pl["mirror_files"]):
        bad.append(f"publish mirror {pl['mirror_files']}")
    if report["pseudo_label_int8"]["batches"] != 1:
        bad.append("the int8 pseudo-labelling run is not one batch")
    for name in ("distill_qat", "distill_plain"):
        r = report[name]
        if r["steps"] != QAT_STEPS or not all(
                map(math.isfinite, r["loss"] + r["grad_norm"])):
            bad.append(f"{name}: {r['steps']} steps, loss {r['loss']}")
        got = r["launches"]
        if (got["encoder_attention"] != n_layers * QAT_STEPS
                or got["log_mel"] < RECIPE_BATCH * QAT_STEPS
                or got["int8_mlp"] != 0):
            bad.append(f"{name} launches {got}")
    ft = report["finetune_qat"]
    if not all(map(math.isfinite, ft["loss"])):
        bad.append(f"non-finite QAT fine-tuning loss {ft['loss']}")
    # remat: a forward and its recompute a layer a step, each one launch,
    # and one backward kernel call a layer a step
    if (ft["launches"]["encoder_attention"] != 2 * n_layers * QAT_FT_STEPS
            or ft["launches"]["encoder_attention_grad"]
            != n_layers * QAT_FT_STEPS):
        bad.append(f"finetune_qat launches {ft['launches']}")
    if report["convert"]["differing_leaves"]:
        bad.append(f"converted weights differ: "
                   f"{report['convert']['differing_leaves'][:5]}")
    qi = report["qat_vs_int8_logits"]
    # a decoder layer: cross K/V, self q/k/v/out, cross q/out, fc1, fc2
    if not (qi["same_projection_sequence"] and qi["projections"]
            == 10 * STUDENT_LAYERS and qi["excess"] <= 0
            and qi["logits_rel_l2_qat_vs_int8"]
            < qi["logits_rel_l2_fp32_vs_int8"]):
        bad.append(f"QAT vs int8: {qi}")
    ip = report["int8_pipeline"]
    if ip["launches"] != {"log_mel": 1, "encoder_attention": n_layers,
                          "encoder_attention_grad": 0,
                          "int8_mlp": n_layers, "int8_decode_attention": 0}:
        bad.append(f"int8 pipeline launches {ip['launches']}")
    ref = report["small_reference"]
    if (not ref["with_condition_on_prev"]
            or ref["rows_equal"] != ref["rows"]):
        bad.append(f"card vs CPU pseudo-labels differ: {ref}")
    if bad:
        raise AssertionError("recipe path: " + "; ".join(bad))
    return {name: report[name]["launches"] for name in
            ("pseudo_label", "pseudo_label_int8", "distill_qat",
             "finetune_qat", "int8_pipeline")}


MG_BATCH = 16         # distillation rows a rank a step (the global batch:
#                       this times the ranks)
MG_STEPS = 2          # data-parallel distillation steps, each teacher
MG_EVAL_CLIPS = 16    # clips of the distributed eval
MG_PL_TOKENS = 32     # pseudo-labelling budget of the full-width runs
MG_PL_BATCH = 4       # its batch: several batches a rank, so that the
#                       steady rate (first batch excluded) exists at 4 ranks
MG_SPEAKER_BLOCK = 12  # consecutive clips a speaker in the PL manifest, so
#                        that 2 or 4 ranks' shards split at speaker changes
MG_LOSS_TOL = 1e-4    # bf16 step-1 losses, data parallel vs one process
#                       (relative): tight enough to see per-rank means
#                       averaged in place of the global token count
MG_TIMEOUT = 900      # seconds the ranks may take together


def small_checkpoint(root: Path) -> Path:
    """test-tiny with 64-wide heads (seed 3) and the synthetic tokenizer,
    saved in fp32: the small model of the card-vs-CPU references."""
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.models import init_params, save_pretrained
    cfg = PRESETS["test-tiny"].replace(d_model=128, encoder_attention_heads=2,
                                       decoder_attention_heads=2)
    ckpt = root / "tiny"
    save_pretrained(init_params(cfg, seed=3, device="cpu"), cfg, str(ckpt))
    synthetic_tokenizer(ckpt)
    return ckpt


# the dry runs (``parallel/dryrun.py``) of multigpu_path,
# tensor_parallel_path and param_sharding_path, by phase, once
# ``run_dryruns`` has run them
_DRYRUNS: dict = {}


def dryrun_args(world: int) -> dict:
    """``dryrun_multigpu``'s arguments for each phase's dry run."""
    return {"multigpu": dict(n_ranks=world),
            "tensor_parallel": dict(n_ranks=world, model_parallel=TP_DEGREE),
            "param_sharding": dict(n_ranks=4, model_parallel=2,
                                   param_sharding="2d")}


def _timed_dryrun(kw: dict) -> dict:
    from distil_whisper_tpu_torch.parallel.dryrun import dryrun_multigpu
    t0 = time.perf_counter()
    report = dryrun_multigpu(**kw)
    report["s"] = time.perf_counter() - t0
    return report


def run_dryruns() -> dict:
    """The three phases' dry runs at once, a thread each: their ranks are
    small spawned processes (eight on one card), mostly start-up, so
    together they take about as long as the longest.  Each raises as
    ``dryrun_multigpu`` does; a phase takes its report from
    :func:`dryrun`.  Returns each run's seconds."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    world = max(2, torch.cuda.device_count())
    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = {name: pool.submit(_timed_dryrun, kw)
                   for name, kw in dryrun_args(world).items()}
        _DRYRUNS.update({name: f.result() for name, f in futures.items()})
    return {name: round(r["s"], 1) for name, r in _DRYRUNS.items()}


def dryrun(name: str, world: int) -> dict:
    """Phase ``name``'s dry run: the report of :func:`run_dryruns`, or
    run here when the phase runs alone."""
    if name in _DRYRUNS:
        return _DRYRUNS.pop(name)
    return _timed_dryrun(dryrun_args(world)[name])


def multigpu_rank(rank: int, world: int, port: int, spec: dict) -> None:
    """One rank of ``multigpu_path``: joins the job from the environment
    torchrun would set, then runs the CLIs with ``--distributed`` in turn,
    each rank's kernel launches counted from 0 around each run; writes
    ``rank{rank}.json`` (and its first distillation batch) to
    ``spec["out"]``."""
    import logging
    import os
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.WARNING)
    from distil_whisper_tpu_torch.cli import (convert_checkpoint_to_hf,
                                              run_distillation, run_eval,
                                              run_pseudo_labelling)
    from distil_whisper_tpu_torch.parallel import maybe_initialize_distributed
    maybe_initialize_distributed(force=True)
    out = Path(spec["out"])
    report = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "cuda_device": torch.cuda.current_device()}

    def timed(name, fn, *argv):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(list(argv) + ["--distributed"])
        torch.cuda.synchronize()
        report[name] = {"s": time.perf_counter() - t0,
                        "launches": read_counts()}
        torch.cuda.empty_cache()
        return result

    # the first step's batch of this rank, for the one-process reference
    original = run_distillation.build_train_step

    def recording_build(*args, **kwargs):
        train_step, eval_step = original(*args, **kwargs)

        def recorded(state, teacher, batch, generator=None):
            path = out / f"batch-rank{rank}.pt"
            if not path.exists():
                torch.save({k: v.cpu() for k, v in batch.items()}, path)
            return train_step(state, teacher, batch, generator)

        recorded.data_parallel = train_step.data_parallel
        return recorded, eval_step

    def distill(name, precision):
        return ["--teacher_checkpoint", spec["teacher"],
                "--student_checkpoint", spec["student"],
                "--train_dataset_path", spec["train"],
                "--output_dir", str(out / name),
                "--teacher_precision", precision, "--precision", "half_mixed",
                "--per_device_train_batch_size", str(MG_BATCH),
                "--max_label_length", "128", "--max_steps", str(MG_STEPS),
                "--warmup_steps", "2", "--learning_rate", "1e-4",
                "--save_steps", str(MG_STEPS), "--eval_steps", "1000",
                "--logging_steps", "1", "--language", "en", "--seed", "42",
                "--wer_threshold", "10"]

    run_distillation.build_train_step = recording_build
    report["checkpoint"] = timed("distill_inference", run_distillation.main,
                                 *distill("inference", "inference"))
    run_distillation.build_train_step = original
    timed("distill_int8_teacher", run_distillation.main,
          *distill("int8", "int8"))
    timed("convert", convert_checkpoint_to_hf.main,
          "--checkpoint_dir", report["checkpoint"],
          "--base_checkpoint", spec["student"], "--save_dir", str(out / "hf"))
    report["eval_result"] = timed(
        "eval", run_eval.main, "--model_checkpoint", str(out / "hf"),
        "--dataset_path", spec["eval"], "--mode", "short", "--language", "en",
        "--batch_size", str(MG_BATCH), "--max_new_tokens", "32",
        "--dtype", "bfloat16")
    timed("pseudo_label", run_pseudo_labelling.main,
          "--model_checkpoint", spec["teacher"], "--dataset_path", spec["pl"],
          "--output_dir", str(out / "pl"), "--per_device_batch_size",
          str(MG_PL_BATCH), "--language", "en", "--max_new_tokens",
          str(MG_PL_TOKENS), "--speaker_id_column_name", "speaker_id")
    report["small_eval_result"] = timed(
        "small_eval", run_eval.main, "--model_checkpoint", spec["small"],
        "--dataset_path", spec["eval"], "--mode", "short", "--language", "en",
        "--batch_size", "8", "--max_new_tokens", "16", "--dtype", "float32")
    timed("small_pseudo_label", run_pseudo_labelling.main,
          "--model_checkpoint", spec["small"], "--dataset_path", spec["pl"],
          "--output_dir", str(out / "small_pl"), "--per_device_batch_size",
          "8", "--language", "en", "--max_new_tokens", "16",
          "--dtype", "float32", "--speaker_id_column_name", "speaker_id")
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(world: int, spec: dict, target=None) -> list:
    """``target`` (``multigpu_rank`` by default) in ``world`` spawned
    processes; their reports in rank order.  A rank that fails, or outlives
    ``MG_TIMEOUT``, fails the phase; every rank is killed on the way out."""
    import torch.multiprocessing as mp
    from distil_whisper_tpu_torch.parallel.dryrun import _free_port
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target or multigpu_rank,
                         args=(r, world, port, spec))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + MG_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{(target or multigpu_rank).__name__}: rank "
                           f"exit codes {codes}")
    return [json.loads((Path(spec["out"]) / f"rank{r}.json").read_text())
            for r in range(world)]


def pl_rows_equal(a_dir: Path, b_dir: Path) -> bool:
    """Whether two pseudo-labelling output directories (every rank's
    manifest, in rank order) hold the same rows: texts, transcripts and
    conditioning equal, stored audio equal sample for sample."""
    import numpy as np
    from distil_whisper_tpu_torch.audio.io import load_audio
    from distil_whisper_tpu_torch.cli.common import load_dataset_any
    a, b = (load_dataset_any(str(d)) for d in (a_dir, b_dir))
    keys = ("text", "whisper_transcript", "condition_on_prev")
    return len(a) == len(b) and all(
        all(x[k] == y[k] for k in keys) and np.array_equal(
            load_audio(x["audio"], 16000), load_audio(y["audio"], 16000))
        for x, y in zip(a, b))


def pad_cat(parts):
    """The ranks' batches as one global batch, the label axis padded to the
    longest (labels -100, mask 0): positions after a row's last label
    change nothing before them in a causal decoder."""
    import torch
    s = max(p["labels"].shape[1] for p in parts)
    fill = {"labels": -100, "decoder_input_ids": 50257,
            "decoder_attention_mask": 0}
    return {k: torch.cat([p[k] if k == "input_features" else
                          torch.nn.functional.pad(
                              p[k], (0, s - p[k].shape[1]), value=fill[k])
                          for p in parts]) for k in parts[0]}


def one_process_reference(teacher_dir: Path, student_dir: Path, batches):
    """One process on the card, as ``run_distillation --teacher_precision
    inference --precision half_mixed`` builds its step: the loss of the
    ranks' concatenated first batches (the data-parallel step-1 loss must
    match it), and the step time at one rank's batch (median of 3 after a
    warm-up)."""
    import torch
    from distil_whisper_tpu_torch.cli.run_distillation import to_compute_dtype
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step)
    from distil_whisper_tpu_torch.utils.profiling import StepTimer
    teacher, tcfg = load_params(str(teacher_dir), device="cuda")
    tcfg = tcfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    teacher = to_compute_dtype(teacher, torch.bfloat16)
    student, scfg = load_params(str(student_dir), device="cuda")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=2,
                          total_steps=MG_STEPS,
                          schedule="constant_with_warmup",
                          precision="half_mixed", frozen_prefixes=("encoder",))
    state = TrainState.create(student, opt)
    del student
    step, eval_step = build_train_step(scfg, tcfg, DistillConfig(), opt)
    cuda = [{k: v.cuda() for k, v in b.items()} for b in batches]
    with torch.no_grad():
        ref = {k: float(v) for k, v in
               eval_step(state.params, teacher, pad_cat(cuda)).items()}
    timer = StepTimer("cuda")
    for i in range(4):
        if i:
            with timer:
                state, _ = step(state, teacher, cuda[0])
        else:
            state, _ = step(state, teacher, cuda[0])
    ref["step_ms_one_rank"] = statistics.median(timer.times) * 1e3
    del state, teacher
    torch.cuda.empty_cache()
    return ref


def phase_multigpu_path(teacher_cfg, root):
    """Data-parallel multi-GPU through the port's CLIs with
    ``--distributed``, at the width of ``teacher_cfg``
    (``training_teacher``), over ``max(2, cards)`` ranks: NCCL when every rank has a card, else two ranks
    sharing one card over gloo.  Each rank: ``run_distillation`` with the
    inference teacher and with the int8 teacher (``MG_STEPS`` steps of
    ``MG_BATCH`` rows a rank, half_mixed), ``convert_checkpoint_to_hf`` of
    the first run's checkpoint (each rank restores, rank 0 writes),
    ``run_eval`` of the converted student on ``MG_EVAL_CLIPS`` clips (bf16),
    ``run_pseudo_labelling`` of ``TRAIN_CLIPS`` clips by the teacher
    (``MG_PL_TOKENS`` new tokens), and the small fp32 model's eval and
    pseudo-labelling; launches counted per rank around each run.  In this
    process: the data-parallel step-1 loss against one process's on the
    concatenated global batch (bf16, ``MG_LOSS_TOL``), the one-rank step
    time, the one-rank pseudo-labelling rate, the small model's one-rank
    eval WER and pseudo-labels (equal to the ranks' summed WER and
    concatenated rows), and ``dryrun_multigpu`` (fp32 parameters after a
    data-parallel step: the summed gradient, the parameters and the loss
    within 1e-5 relative of one process's).  ``root`` holds the teacher, student
    and manifests of ``training_path`` (or of :func:`shared_inputs`)."""
    import logging
    import shutil
    import torch
    from distil_whisper_tpu_torch.cli import run_eval, run_pseudo_labelling
    from distil_whisper_tpu_torch.cli.common import shard_rows, write_jsonl

    logging.basicConfig(level=logging.WARNING)
    cards = torch.cuda.device_count()
    world = max(2, cards)
    report = {"world": world, "cards": cards,
              "backend": "nccl" if cards >= world else "gloo"}
    try:
        rows = [json.loads(line) for line in
                (root / "train.jsonl").read_text().splitlines()]
        mg = root / "multigpu"
        mg.mkdir()
        write_jsonl(str(mg / "eval.jsonl"), rows[:MG_EVAL_CLIPS])
        pl_in = [{"audio": r["audio"], "text": r["text"],
                  "speaker_id": f"s{i // MG_SPEAKER_BLOCK}"}
                 for i, r in enumerate(rows)]
        write_jsonl(str(mg / "pl.jsonl"), pl_in)
        # one rank's rate needs a few batches, not the whole set
        write_jsonl(str(mg / "pl_one.jsonl"), pl_in[:2 * MG_SPEAKER_BLOCK])
        spec = {"teacher": str(root / "teacher"),
                "student": str(root / "student"),
                "train": str(root / "train.jsonl"),
                "eval": str(mg / "eval.jsonl"), "pl": str(mg / "pl.jsonl"),
                "small": str(small_checkpoint(mg)), "out": str(mg / "out")}
        Path(spec["out"]).mkdir()
        t0 = time.perf_counter()
        ranks = run_ranks(world, spec)
        report["ranks_s"] = time.perf_counter() - t0
        out = Path(spec["out"])

        # the ranks' distillation, as rank 0 logged it
        metrics = _train_rows(_metrics(out / "inference"))
        int8 = _train_rows(_metrics(out / "int8"))
        steps = {"loss": [m["train/loss"] for m in metrics],
                 "grad_norm": [m["train/grad_norm"] for m in metrics],
                 "label_tokens": [m["train/label_tokens"] for m in metrics],
                 "step_ms_ranks": [[t * 1e3 for t in m[
                     "train/step_time_s_ranks"]] for m in metrics],
                 "allreduce_ms_ranks": [[t * 1e3 for t in m[
                     "train/allreduce_s_ranks"]] for m in metrics],
                 "int8_teacher_loss": [m["train/loss"] for m in int8],
                 "int8_step_ms_ranks": [[t * 1e3 for t in m[
                     "train/step_time_s_ranks"]] for m in int8]}
        late = steps["step_ms_ranks"][1:]
        steps["step_ms_median_after_first"] = statistics.median(
            max(r) for r in late)
        steps["allreduce_ms_median_after_first"] = statistics.median(
            max(r) for r in steps["allreduce_ms_ranks"][1:])
        steps["allreduce_share"] = (steps["allreduce_ms_median_after_first"]
                                    / steps["step_ms_median_after_first"])
        report["distill"] = steps

        ref = one_process_reference(
            root / "teacher", root / "student",
            [torch.load(out / f"batch-rank{r}.pt", weights_only=True)
             for r in range(world)])
        report["step1_vs_one_process"] = {
            k: [metrics[0][f"train/{k}"], ref[k]]
            for k in ("loss", "ce_loss", "kl_loss")}
        report["step1_rel_diff"] = max(
            abs(a - b) / abs(b)
            for a, b in report["step1_vs_one_process"].values())
        report["step_ms_one_rank"] = ref["step_ms_one_rank"]

        # eval: every rank reports the summed WER
        evals = [r["eval_result"] for r in ranks]
        report["eval"] = {
            "wer_ranks": [e.get("wer") for e in evals],
            "audio_s_per_s_summed": sum(e["rtfx"] for e in evals),
            "samples_ranks": [e["num_samples"] for e in evals]}

        # pseudo-labelling: the ranks' rates summed, against one rank here
        stats = [json.loads((out / "pl" / f"pl_stats-{r}.json").read_text())
                 for r in range(world)]
        t0 = time.perf_counter()
        reset_counts()
        run_pseudo_labelling.main([
            "--model_checkpoint", spec["teacher"], "--dataset_path",
            str(mg / "pl_one.jsonl"), "--output_dir", str(mg / "pl_one"),
            "--per_device_batch_size", str(MG_PL_BATCH), "--language", "en",
            "--max_new_tokens", str(MG_PL_TOKENS),
            "--speaker_id_column_name", "speaker_id"])
        one = json.loads((mg / "pl_one" / "pl_stats.json").read_text())
        report["pseudo_label"] = {
            "rows_ranks": [s["rows"] for s in stats],
            "batches_ranks": [s["batches"] for s in stats],
            "audio_s_ranks": [s["audio_s"] for s in stats],
            "audio_s_per_s_steady_summed": sum(s["rtfx_steady_state"]
                                               for s in stats),
            "audio_s_per_s_wall_summed": sum(
                s["audio_s"] / r["pseudo_label"]["s"]
                for s, r in zip(stats, ranks)),
            "one_rank_audio_s_per_s_steady": one["rtfx_steady_state"],
            "one_rank_audio_s_per_s_wall": one["audio_s"]
            / (time.perf_counter() - t0),
            "one_rank_rows": one["rows"], "one_rank_launches": read_counts()}

        # the small fp32 model: one rank here equals the ranks together
        small_eval = run_eval.main([
            "--model_checkpoint", spec["small"], "--dataset_path",
            spec["eval"], "--mode", "short", "--language", "en",
            "--batch_size", "8", "--max_new_tokens", "16",
            "--dtype", "float32"])
        run_pseudo_labelling.main([
            "--model_checkpoint", spec["small"], "--dataset_path", spec["pl"],
            "--output_dir", str(mg / "small_pl_one"),
            "--per_device_batch_size", "8", "--language", "en",
            "--max_new_tokens", "16", "--dtype", "float32",
            "--speaker_id_column_name", "speaker_id"])
        pl_rows_in = [json.loads(line) for line in
                      Path(spec["pl"]).read_text().splitlines()]
        shard_texts = [" ".join(r["text"] for r in shard_rows(
            sorted(pl_rows_in, key=lambda r: r["speaker_id"]), world, k))
            for k in range(world)]
        report["small"] = {
            "eval_wer_ranks": [r["small_eval_result"].get("wer")
                               for r in ranks],
            "eval_wer_one_rank": small_eval.get("wer"),
            "pl_rows_equal": pl_rows_equal(out / "small_pl",
                                           mg / "small_pl_one"),
            "pl_shards_follow_the_rule": [
                " ".join(json.loads(line)["text"] for line in
                         (out / "small_pl" / f"dataset-{k}.jsonl")
                         .read_text().splitlines()) == shard_texts[k]
                for k in range(world)]}
        report["launches"] = {run: [r[run]["launches"] for r in ranks]
                              for run in ("distill_inference",
                                          "distill_int8_teacher", "eval",
                                          "pseudo_label")}
        report["run_s"] = {run: [round(r[run]["s"], 2) for r in ranks]
                           for run in ("distill_inference",
                                       "distill_int8_teacher", "convert",
                                       "eval", "pseudo_label", "small_eval",
                                       "small_pseudo_label")}
        report["rank_devices"] = [r["cuda_device"] for r in ranks]
        report["rank_backends"] = [r["backend"] for r in ranks]
        report["exported"] = sorted(p.name for p in (out / "hf").iterdir())
        # raises when the step parts from one process's (1e-5 relative)
        dry = dryrun("multigpu", world)
        report["dryrun"] = {k: dry[k] for k in (
            "backend", "grad_err", "param_err", "loss_rel_err", "loss",
            "update_err", "worst_element", "s")}
        shard = [len(shard_rows(rows, world, k)) for k in range(world)]
    finally:
        shutil.rmtree(root / "multigpu", ignore_errors=True)

    emit({"phase": "multigpu_path", **report})
    bad = []
    n_layers = teacher_cfg.encoder_layers
    if report["rank_backends"] != [report["backend"]] * world:
        bad.append(f"backends {report['rank_backends']}")
    if report["backend"] == "nccl" and report["rank_devices"] != list(
            range(world)):
        bad.append(f"ranks on cards {report['rank_devices']}")
    d = report["distill"]
    if len(d["loss"]) != MG_STEPS or len(d["int8_teacher_loss"]) != MG_STEPS \
            or not all(map(math.isfinite, d["loss"] + d["grad_norm"]
                           + d["int8_teacher_loss"])):
        bad.append(f"distillation: {d}")
    if not report["step1_rel_diff"] <= MG_LOSS_TOL:
        bad.append(f"step 1 vs one process: {report['step1_vs_one_process']}")
    for r in range(world):
        want = {"distill_inference": dict(
                    log_mel=shard[r], encoder_attention=n_layers * MG_STEPS,
                    int8_mlp=0),
                "distill_int8_teacher": dict(
                    log_mel=shard[r], encoder_attention=n_layers * MG_STEPS,
                    int8_mlp=MG_STEPS * (n_layers
                                         + teacher_cfg.decoder_layers)),
                "eval": dict(log_mel=1, encoder_attention=n_layers,
                             int8_mlp=0),
                "pseudo_label": dict(
                    log_mel=report["pseudo_label"]["batches_ranks"][r],
                    encoder_attention=n_layers * report[
                        "pseudo_label"]["batches_ranks"][r], int8_mlp=0)}
        for run, counts in want.items():
            got = report["launches"][run][r]
            if any(got[k] != v for k, v in counts.items()):
                bad.append(f"rank {r} {run} launches {got}, want {counts}")
    e = report["eval"]
    if len(set(e["wer_ranks"])) != 1 or e["wer_ranks"][0] is None:
        bad.append(f"eval WER differs over the ranks: {e['wer_ranks']}")
    s = report["small"]
    if not (len(set(s["eval_wer_ranks"])) == 1
            and s["eval_wer_ranks"][0] == s["eval_wer_one_rank"]
            and s["eval_wer_one_rank"] is not None):
        bad.append(f"small eval WER: {s}")
    if not (s["pl_rows_equal"] and all(s["pl_shards_follow_the_rule"])):
        bad.append(f"small pseudo-labels: {s}")
    pl = report["pseudo_label"]
    if (min(pl["batches_ranks"]) < 2
            or pl["one_rank_rows"] < 2 * MG_PL_BATCH):
        bad.append(f"pseudo-labelling ran too few batches for a rate: {pl}")
    if "model.safetensors" not in report["exported"]:
        bad.append(f"converter wrote {report['exported']}")
    if bad:
        raise AssertionError("multigpu path: " + "; ".join(bad))
    return {f"multigpu_{run}_rank{r}": report["launches"][run][r]
            for run in report["launches"] for r in range(world)}


# -- the device collective (csrc/mesh_collective.cu) ----------------------
MC_DECODE_ROWS = (16, 1280)   # a decode step's row-parallel fp32 partials
MC_LAYER_PARAMS = 26_224_640  # a distil-large-v3 decoder layer, gathered
NVLINK_BW = 450e9             # bytes/s each way a card (H100 SXM)
MC_SEEDS = {"sum": 1, "sum_int": 2, "max": 3, "gather": 4}
MC_REPLACES = ("distil_whisper_tpu/pipeline.py:49 (XLA's collectives in "
               "JAX's meshed program; no Pallas kernel)")


def _mc_input(mode: str, numel: int, rank: int):
    """Rank ``rank``'s input of ``mode`` (any rank regenerates any
    rank's): fp32 over six decades, int32 over its range, bf16 to gather."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(
        1000 * MC_SEEDS[mode] + rank)
    if mode == "sum_int":
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (numel,), generator=gen,
                             device="cuda", dtype=torch.int32)
    x = torch.randn(numel, generator=gen, device="cuda")
    if mode == "gather":
        return x.to(torch.bfloat16)
    scale = 10.0 ** (6 * torch.rand(numel, generator=gen, device="cuda") - 3)
    return x * scale


def _mc_digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().view(-1).view(
        __import__("torch").uint8).cpu().numpy().tobytes()).hexdigest()


def _mc_library_ms(mode: str, x, group, calls: int = 5) -> float:
    """torch.distributed's call for the same collective (gloo on one card,
    NCCL a card each): host clock around ``calls`` calls, synchronised."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if mode == "gather":
        x = x.view(torch.uint8)     # the same bytes (gloo takes no bf16)

    def call():
        if mode == "gather":
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
        else:
            op = dist.ReduceOp.MAX if mode == "max" else dist.ReduceOp.SUM
            dist.all_reduce(x.clone(), op=op, group=group)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def mesh_collective_rows(group) -> list:
    """The device collective over ``group`` (every rank of it calls this
    alike), a row a mode: at decode size (``MC_DECODE_ROWS`` fp32 or int32;
    bf16 rows of the same bytes to gather) and at one gathered layer
    (``MC_LAYER_PARAMS`` bf16, the reductions over as many bytes), against
    its plain version (the rank-ordered combine of every rank's input,
    regenerated here from their seeds) with identical bits on every rank
    (sha256 of the result, gathered over the host group); its ms in a CUDA
    graph of 20 calls (bit for bit again after them) and launched back to
    back; the plain combine's ms; the bound (the bytes the function moves:
    a rank reads the n inputs and writes its result, over HBM on one card,
    the remote part over NVLink a card each); torch.distributed's call.
    The group's comm holds a layer in one slot (reserved here, if it is
    not made yet)."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.parallel import device_comm as DC
    from distil_whisper_tpu_torch.parallel.multihost import gather_rows
    DC.reserve(group, 2 * MC_LAYER_PARAMS)
    comm = DC.comm_of(group)
    n = comm.n
    one_card = torch.cuda.device_count() < n
    rows = []
    for mode in ("sum", "sum_int", "max", "gather"):
        row = {"name": f"mesh_collective_{mode}", "route": "cuda",
               "source": "distil_whisper_tpu_torch/csrc/mesh_collective.cu",
               "replaces": MC_REPLACES, "ranks": n, "one_card": one_card}
        sizes = {"decode": MC_DECODE_ROWS[0] * MC_DECODE_ROWS[1],
                 "layer": MC_LAYER_PARAMS // 2}
        for size, numel in sizes.items():
            if mode == "gather":
                numel = 2 * numel // n          # bf16: the same bytes in all
            x = _mc_input(mode, numel, comm.me)
            parts = [_mc_input(mode, numel, r) for r in range(n)]
            plain = DC.combine_plain(parts, mode)

            def run():
                return (DC.all_gather(x, group) if mode == "gather"
                        else DC.all_reduce(x, mode, group))
            got = run()
            torch.cuda.synchronize()
            same = bool(torch.equal(got, plain))
            err = float((got.double() - plain.double()).abs().max())
            digests = gather_rows(np.frombuffer(bytes.fromhex(_mc_digest(
                got)), dtype=np.uint8)[None])
            rec = {"numel": numel, "bytes": x.numel() * x.element_size(),
                   "bit_equal_to_plain": same, "max_abs_err": err,
                   "identical_on_every_rank": bool(
                       (digests == digests[0]).all())}
            rec["pieces"] = len(DC.pieces(rec["bytes"], comm.slot))
            rec["ms"] = cuda_graph_ms(run)
            again = run()
            torch.cuda.synchronize()
            rec["graph_bit_equal"] = bool(torch.equal(again, plain))
            rec["launched_ms"] = cuda_ms(run)
            rec["plain_ms"] = cuda_ms(lambda: DC.combine_plain(parts, mode))
            # what the function must move: each rank reads the n inputs of
            # b bytes and writes its result (b, or n b gathered), (n - 1) b
            # of the reads a peer's; the copy into the slot is the design's
            b = rec["bytes"]
            moved = 2 * n * b if mode == "gather" else (n + 1) * b
            remote = (n - 1) * b
            rec["bound_ms"] = (n * moved / MEM_BW * 1e3 if one_card else
                               max(moved / MEM_BW, remote / NVLINK_BW) * 1e3)
            rec["bound_by"] = "bytes"
            rec["library_ms"] = _mc_library_ms(mode, x, group)
            rec["library"] = ("gloo" if one_card else "nccl") + (
                " all_gather" if mode == "gather" else " all_reduce")
            row[size] = rec
            del x, parts, plain, got
        dec = row["decode"]
        row.update({k: dec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def check_mesh_collective_rows(rows) -> list:
    """What fails the phase in ``mesh_collective_rows``' rows."""
    bad = []
    for row in rows:
        for size in ("decode", "layer"):
            rec = row[size]
            if not (rec["bit_equal_to_plain"]
                    and rec["identical_on_every_rank"]
                    and rec["graph_bit_equal"] and rec["pieces"] == 1):
                bad.append(f"{row['name']} at {size}: {rec}")
    return bad


# the device collective's kernel rows (tensor_parallel_path) and its
# launches by mode on each meshed path, rank 0's, for the kernels line
_MESH: dict = {}

# -- meshed decodes on CUDA graphs (tensor_parallel_path, param_sharding_path)
MESH_WINDOWS = 16       # windows of the meshed graph cases (over the data axis)
MESH_NEW_TOKENS = 128   # their budget (generate, timestamps, beam)
MESH_BEAMS = 5
MESH_SPEC_TOKENS = 64   # the draft speculation's budget
MESH_2D_NEW_TOKENS = 64  # the 2-D case's budget: on one card its two ranks
#                         gather every layer each step, time-sliced
MESH_EOS_SCALE = 3000.0  # the EOS-bound encoder states' norm


def mesh_counts():
    from distil_whisper_tpu_torch.parallel import device_comm
    return {m: f.launches for m, f in device_comm.COUNTERS.items()}


def reset_mesh_counts():
    from distil_whisper_tpu_torch.parallel import device_comm
    for f in device_comm.COUNTERS.values():
        f.launches = 0


def eos_states(dec, cfg, scale: float):
    """Encoder states [1500, d] that drive ``dec`` to EOS within its first
    steps: one direction through every layer's cross-attention V and
    out-projections, solved (fp64) so that the residual stream it adds lies
    along the EOS row of the tied embedding over the final LayerNorm's
    scale, times ``scale`` (tests/torch_mp_worker.py's ``eos_states``)."""
    import torch
    lay = dec["layers"]["cross_attn"]
    m = sum(lay["v"]["kernel"][i].double() @ lay["out"]["kernel"][i].double()
            for i in range(cfg.decoder_layers))
    target = (dec["tok_emb"][cfg.eos_token_id].double()
              / dec["ln"]["scale"].double())
    u = torch.linalg.solve(m.T, target - target.mean())
    return (scale * u / u.norm()).float().expand(1500, -1).contiguous()


def meshed_graph_cases(full, cfg, mesh, tok, rules=None, eos_rank=None,
                       new_tokens=MESH_NEW_TOKENS, full_set=True):
    """Meshed decodes of ``full`` (bf16, sharded here over ``mesh`` by
    ``rules``) on CUDA graphs against their plain loops on the same ranks
    (every rank of the mesh calls it alike), on ``MESH_WINDOWS`` windows
    split over the data axis: ``generate`` with and without timestamps,
    and with ``full_set`` beam search (``MESH_BEAMS``), draft
    speculation (a 1-layer draft from the same weights, sharded alike) and
    an engine block (16 lanes, block 16, graphed against eager).  Every
    output equal bit for bit (``compare_decode``: wall and device ms, idle
    share, host syncs, captures, pool bytes); greedy texts against one
    rank's with the near-tie report.  With ``eos_rank``, that data rank's
    encoder states are ``eos_states``: its rows end steps before the
    others', and the stop is agreed over the data group.  Returns the
    report; the device collective's launches by mode around the cases."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, generate, generate_eager)
    from distil_whisper_tpu_torch.generation import beam as B
    from distil_whisper_tpu_torch.generation import graphs as G
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.parallel.mesh import (DEFAULT_RULES,
                                                        coordinates,
                                                        shard_params)
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving_engine import \
        ContinuousBatchingEngine
    from distil_whisper_tpu_torch.training import init_student_from_teacher
    dtype = torch.bfloat16
    cfgb = cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    tree = shard_params(full, mesh, rules or DEFAULT_RULES, cfg=cfg)
    dec, one_dec = tree["decoder"], full["decoder"]
    d, n_data, _, n_model = coordinates(mesh)
    per = MESH_WINDOWS // n_data
    clips = synthetic_audio(MESH_WINDOWS, 30.0, seed=21)
    mels = compute_mel(np.stack(clips), cfgb, device="cuda").to(dtype)
    mels = mels[d * per:(d + 1) * per].contiguous()
    report = {"mesh": [n_data, n_model], "rows": per,
              "new_tokens": new_tokens}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = W.encode(tree["encoder"], cfgb, mels, dtype=dtype)
    torch.cuda.synchronize()
    report["encode_s"] = time.perf_counter() - t0
    one_enc = W.encode(full["encoder"], cfgb, mels, dtype=dtype)
    if eos_rank is not None and d == eos_rank:
        enc = one_enc = eos_states(one_dec, cfgb, MESH_EOS_SCALE).to(
            dtype).expand(per, -1, -1).contiguous()
    prompt_ids = tok.prompt_ids(language="en")
    ts_ids = tok.prompt_ids(language="en", task="transcribe",
                            no_timestamps=False)
    owner, one_owner = G.GraphOwner("meshed"), G.GraphOwner("one_rank")
    one_cross = W.cross_kv(one_dec, cfgb, one_enc)
    reset_mesh_counts()
    t_cases = time.perf_counter()

    def greedy_case(name, ids, opts, profile_plain):
        prompt = torch.tensor([ids] * per, device="cuda")
        rep, out = compare_decode(
            name, lambda: generate_eager(dec, cfgb, enc, prompt, opts,
                                         dtype=dtype),
            lambda: generate(dec, cfgb, enc, prompt, opts, dtype=dtype,
                             graphs=owner), owner, repeats=0,
            prompt_len=len(ids), profile_plain=profile_plain)
        one = generate(one_dec, cfgb, one_enc, prompt, opts, dtype=dtype,
                       graphs=one_owner)
        rows = [[s[j][:int(n[j])].tolist() for j in range(per)]
                for s, n in ((out.sequences, out.seq_len),
                             (one.sequences, one.seq_len))]
        texts = [[tok.decode(r[len(ids):]) for r in rs] for rs in rows]
        rep["seq_len"] = out.seq_len.tolist()
        rep["tokens_equal_to_one_rank"] = rows[0] == rows[1]
        rep["text_equal_to_one_rank"] = sum(
            a == b for a, b in zip(*texts)) / per
        rep["near_ties"] = near_tie_report(one_dec, cfgb, one_cross, rows[1],
                                           rows[0], len(ids), dtype)
        report[name] = rep

    opts = GenerationOptions.from_config(cfgb, max_new_tokens=new_tokens,
                                         no_speech_token_id=tok.no_speech)
    greedy_case("generate", prompt_ids, opts, True)
    greedy_case("generate_timestamps", ts_ids, GenerationOptions.from_config(
        cfgb, max_new_tokens=new_tokens, return_timestamps=True,
        no_speech_token_id=tok.no_speech), False)
    if full_set:
        prompt = torch.tensor([prompt_ids] * per, device="cuda")
        rep, out = compare_decode(
            "beam", lambda: B.beam_search_eager(
                dec, cfgb, enc, prompt, opts, num_beams=MESH_BEAMS,
                dtype=dtype),
            lambda: B.beam_search(dec, cfgb, enc, prompt, opts,
                                  num_beams=MESH_BEAMS, dtype=dtype,
                                  graphs=owner),
            owner, repeats=0, prompt_len=len(prompt_ids),
            profile_plain=False)
        one = B.beam_search(one_dec, cfgb, one_enc, prompt, opts,
                            num_beams=MESH_BEAMS, dtype=dtype,
                            graphs=one_owner)
        rep["tokens_equal_to_one_rank"] = sum(
            torch.equal(a[:int(n)], b[:int(m)]) for a, n, b, m in zip(
                out.sequences, out.seq_len, one.sequences, one.seq_len)) / per
        report["beam"] = rep
        del out, one

        student, scfg = init_student_from_teacher(full, cfg, decoder_layers=1)
        d_dec, dcfg = S.prepare_assistant(
            ({"decoder": student["decoder"],
              "encoder": student["encoder"]}, scfg), dtype,
            torch.device("cuda", torch.cuda.current_device()), mesh)
        d_dec = d_dec["decoder"]
        sopts = GenerationOptions.from_config(
            cfgb, max_new_tokens=MESH_SPEC_TOKENS,
            no_speech_token_id=tok.no_speech)
        rep, out = compare_decode(
            "draft", lambda: S.speculate_eager(
                dec, cfgb, enc, prompt, sopts, gamma=5,
                draft=(d_dec, dcfg, enc), dtype=dtype),
            lambda: S.speculative_generate_batched(
                dec, cfgb, d_dec, dcfg, enc, enc, prompt, sopts, gamma=5,
                dtype=dtype, graphs=owner),
            owner, repeats=0, profile_plain=False)
        rep["rounds"] = int(out.rounds.max())
        rep["accepted"] = int(out.accepted.sum())
        report["draft"] = rep
        del student, d_dec, out

        # an engine block: the graphed engine against the same engine run
        # eagerly, over one admission sequence (packed vectors equal)
        pipe = WhisperPipeline(None, dtype=dtype, batch_size=MESH_WINDOWS,
                               max_new_tokens=96, params=full, cfg=cfg,
                               tokenizer=tok, device="cuda", mesh=mesh)
        engines = []
        for graphed in (True, False):
            eng = ContinuousBatchingEngine(pipe, lanes=MESH_WINDOWS,
                                           block_steps=16, max_new_tokens=96)
            eng.graphed = graphed
            stats0 = G.read_stats()
            eng.init_state()
            engines.append((eng, graph_stats_since(stats0, eng.graphs)))
        all_mels = mels if n_data == 1 else torch.cat([mels] * n_data)
        packed = [engine_blocks(eng, all_mels, prompt_ids, False, 4)
                  for eng, _ in engines]
        same = all(torch.equal(a, b) for a, b in zip(*packed))
        timing = [engine_block_timing(eng, all_mels, prompt_ids, False)
                  for eng, _ in engines]
        report["engine_block"] = {
            "equal": same, "graph": timing[0], "eager": timing[1],
            "captures": engines[0][1]["captures"],
            "capture_s": engines[0][1]["capture_s"],
            "pool_bytes": G.pool_bytes(engines[0][0].graphs)}
        if not same:
            raise AssertionError("meshed engine: graphed blocks part from "
                                 "the eager blocks")
        del pipe, engines, packed
    report["cases_s"] = time.perf_counter() - t_cases
    report["collective_launches"] = mesh_counts()
    report["owner"] = owner.report()
    del owner, one_owner, tree
    torch.cuda.empty_cache()
    return report


def large_tp_encode(full, cfg, mesh) -> dict:
    """A tensor-parallel encode of ``TP_LARGE_WINDOWS`` windows (bf16,
    ``full`` sharded over ``mesh``'s model axis): its fp32 row-parallel
    partials (7.68 MB a window at d_model 1280) run past the comm's slot,
    a slot at a time; finite, within ``TP_ENCODE_REL_L2`` of one rank's
    encode of the same windows; the pieces counted."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.parallel import device_comm, groups
    from distil_whisper_tpu_torch.parallel.mesh import (model_group,
                                                        shard_params)
    dtype = torch.bfloat16
    cfgb = cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    tree = shard_params(full, mesh, cfg=cfg)
    clips = synthetic_audio(TP_LARGE_WINDOWS, 30.0, seed=31)
    mels = compute_mel(np.stack(clips), cfgb, device="cuda").to(dtype)
    before = mesh_counts()["sum"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with groups.timed() as rec:
        enc = W.encode(tree["encoder"], cfgb, mels, dtype=dtype)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = W.encode(full["encoder"], cfgb, mels, dtype=dtype)
    slot = device_comm.comm_of(model_group(mesh)).slot
    partial = TP_LARGE_WINDOWS * 1500 * cfg.d_model * 4
    out = {"windows": TP_LARGE_WINDOWS, "partial_bytes": partial,
           "slot_bytes": slot, "all_reduces": rec.counts["all_reduce"],
           "sum_launches": mesh_counts()["sum"] - before,
           "pieces_a_partial": len(device_comm.pieces(partial, slot)),
           "s": wall, "finite": bool(enc.isfinite().all()),
           "shape": list(enc.shape),
           "rel_l2_vs_one_rank": float((enc.double() - one.double()).norm()
                                       / one.double().norm())}
    del tree, enc, one, mels
    torch.cuda.empty_cache()
    return out


TP_DEGREE = 2         # the model axis of tensor_parallel_path
TP_WINDOWS = 4        # windows of its pipeline runs
TP_ENCODER_LAYERS = 8  # encoder layers of their distil-large-v3 (each
#                        layer's sharded encode all-reduces over gloo on
#                        one card: most of the phase at 32)
TP_NEW_TOKENS = 32    # their budget
TP_LARGE_WINDOWS = 32  # large_tp_encode: run_eval --model_parallel 2
#                        --batch_size 32's encode
TP_BATCH = 4          # distillation rows a data rank a step (each row's
#                       activations cross the model group at every layer)
TP_STEPS = 1          # tensor-parallel distillation steps
TP_MLP_ROWS = 24000   # rows of the int8 MLP partial mode's timing (the
#                       encoder's 16 windows); the ffn is a rank's shard
# the sharded encode of a data rank's windows against one rank's encode
# of them, relative L2, a lane, set over the readings on one H100: bf16
# 1.363e-2 (one rank's einsum encoder lies 1.410e-2 from its kernel
# encoder), int8 2.445e-2, fp32 2.11e-6
TP_ENCODE_REL_L2 = {"bf16": 2e-2, "fp32": 1e-5, "int8": 4e-2}


def _events_ms(fn, calls: int = 3) -> float:
    """Median device time of ``fn`` over ``calls`` calls after one warm-up,
    CUDA events around each (a collective inside may not be replayed the
    hundred times ``cuda_ms`` would: every rank runs the same calls)."""
    import torch
    fn()
    times = []
    for _ in range(calls):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tp_rank(rank: int, world: int, port: int, spec: dict) -> None:
    """One rank of ``tensor_parallel_path`` on a ``(world / TP_DEGREE,
    TP_DEGREE)`` mesh (and, on four cards or more, a ``(1, world)`` one):
    the bf16 and int8 pipelines with ``mesh=`` against one rank's, the
    encode and its all-reduces timed, the int8 MLP's partial mode, the
    tensor-parallel ``run_distillation`` and the small fp32 model's greedy
    and n-gram speculation; writes ``rank{rank}.json``."""
    import logging
    import os
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.WARNING)
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.cli import run_distillation
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                     encode_and_generate)
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import init_params, load_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import layer_slice
    from distil_whisper_tpu_torch.ops.int8_mlp import (fused_int8_mlp,
                                                       fused_int8_mlp_plain)
    from distil_whisper_tpu_torch.ops.quant import maybe_quantize_encoder
    from distil_whisper_tpu_torch.parallel import (
        groups, make_mesh, maybe_initialize_distributed, tensor_parallel as TP)
    from distil_whisper_tpu_torch.parallel.mesh import (coordinates,
                                                        model_group,
                                                        shard_params)
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.tokenizer import WhisperTokenizer
    maybe_initialize_distributed(force=True)
    out = Path(spec["out"])
    tok = WhisperTokenizer.from_pretrained(spec["tok"])
    mesh = make_mesh((world // TP_DEGREE, TP_DEGREE))
    d, n_data, m, tp = coordinates(mesh)
    report = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "mesh": [n_data, tp], "coordinate": [d, m]}
    # the model group's comm sized as WhisperPipeline(batch_size=
    # MESH_WINDOWS, mesh=mesh) sizes it: a data rank's windows' fp32
    # row-parallel partial (mesh.reserve_comms)
    from distil_whisper_tpu_torch.parallel import device_comm
    device_comm.reserve(model_group(mesh), MESH_WINDOWS // n_data * 1500
                        * PRESETS["distil-large-v3"].d_model * 4)
    # the device collective, each mode, against its plain version; then its
    # launches counted from 0 around the meshed pipelines and graph cases
    report["mesh_collective"] = mesh_collective_rows(model_group(mesh))
    reset_mesh_counts()
    encodes = {}    # one rank's encode of this data rank's windows, a lane
    dtype = torch.bfloat16
    tp_cfg = PRESETS["distil-large-v3"].replace(
        encoder_layers=TP_ENCODER_LAYERS)
    full = init_params(tp_cfg, seed=0, device="cuda", dtype=dtype)
    clips = synthetic_audio(TP_WINDOWS, 30.0, seed=1)
    prompt = tok.prompt_ids(language="en")

    def pipelines(flags, mesh_, dtype):
        """(the pipeline on ``mesh_``, one rank's) over ``full``."""
        cfg = tp_cfg.replace(**flags)
        return [WhisperPipeline(None, dtype=dtype, batch_size=TP_WINDOWS,
                                max_new_tokens=TP_NEW_TOKENS, params=full,
                                cfg=cfg, tokenizer=tok, device="cuda",
                                mesh=mm) for mm in (mesh_, None)]

    def drive(name, flags, mesh_, dtype=dtype):
        """The pipeline with ``mesh_`` on the windows, launches and the
        model group's all-reduces counted around it; the share of texts
        equal to one rank's and the near-tie report of the parting rows
        (with the logit drift of the sharded teacher-forced pass from one
        rank's); the encode of this data rank's windows timed, sharded
        and whole."""
        pipe, one = pipelines(flags, mesh_, dtype)
        group = model_group(mesh_)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with groups.timed() as rec:
            texts = [r["text"] for r in pipe(clips, language="en")]
        torch.cuda.synchronize()
        row = {"s": time.perf_counter() - t0, "launches": read_counts(),
               "all_reduce_count": rec.counts["all_reduce"],
               "all_reduce_ms": rec.ms(), "all_reduce_host_ms": rec.host_ms}
        ref = [r["text"] for r in one(clips, language="en")]
        row["text_equal_to_one_rank"] = sum(
            a == b for a, b in zip(texts, ref)) / len(ref)
        mels = compute_mel(np.stack(clips), one.cfg, device="cuda").to(dtype)
        if row["text_equal_to_one_rank"] < 1:
            opts = GenerationOptions.from_config(
                one.cfg, max_new_tokens=TP_NEW_TOKENS,
                no_speech_token_id=tok.no_speech)
            seqs = [p._decode_batch(mels, [prompt] * len(clips), opts, 1,
                                    1.0) for p in (pipe, one)]
            rows = [[s[j][:int(n[j])].tolist() for j in range(len(clips))]
                    for s, n, _ in seqs]
            enc, enc_tp, enc_alt = (W.encode(
                p.params["encoder"], c, mels, dtype=dtype) for p, c in (
                    (one, one.cfg), (pipe, pipe.cfg),
                    (one, one.cfg.replace(use_flash_encoder=False))))
            dec, dec_tp = one.params["decoder"], pipe.params["decoder"]
            cross, cross_alt = (W.cross_kv(dec, one.cfg, e)
                                for e in (enc, enc_alt))
            # the yardstick: one rank's decode by its other numerics on
            # both sides, as the sharded decode differs on both (the
            # cached single-token step over its einsum encoder's states,
            # against the teacher-forced pass over the kernel encoder's);
            # the sharded teacher-forced pass beside it
            rep = near_tie_report(
                dec, one.cfg, cross, rows[1], rows[0], len(prompt), dtype,
                drift_logits=cached_step_logits(dec, one.cfg, cross_alt,
                                                dtype),
                test_logits=teacher_forced_logits(
                    dec_tp, pipe.cfg, W.cross_kv(dec_tp, pipe.cfg, enc_tp),
                    dtype))
            # each share apart at each parting, from one rank's
            # teacher-forced pass: the decoder's numerics (the cached
            # step, same states), the encoder's (the einsum states), the
            # sharded decoder over one rank's states
            base = teacher_forced_logits(dec, one.cfg, cross, dtype)
            shares = {
                "decoder_drift": cached_step_logits(dec, one.cfg, cross,
                                                    dtype),
                "encoder_drift": teacher_forced_logits(dec, one.cfg,
                                                       cross_alt, dtype),
                "tp_decoder_share": teacher_forced_logits(
                    dec_tp, pipe.cfg, W.cross_kv(dec_tp, pipe.cfg, enc),
                    dtype)}
            for part in rep["partings"]:
                b_, prefix = part["row"], rows[1][part["row"]][
                    :part["position"]]
                ref_l = base(b_, prefix).float()
                for k, fn in shares.items():
                    part[k] = float((fn(b_, prefix).float() - ref_l)
                                    .abs().max())
            row["near_ties"] = rep
            del enc, enc_tp, enc_alt, cross, cross_alt
        d_, n_d, _, _ = coordinates(mesh_)
        mine = mels[d_ * len(clips) // n_d:(d_ + 1) * len(clips) // n_d]
        # the sharded encode of this data rank's windows against one
        # rank's on the same mels
        a, b, alt = (W.encode(p.params["encoder"], c, mine,
                              dtype=dtype).double() for p, c in (
            (pipe, pipe.cfg), (one, one.cfg),
            (one, one.cfg.replace(use_flash_encoder=False))))
        row["encode_rel_l2_vs_one_rank"] = float((a - b).norm() / b.norm())
        # two numerics of the unsharded encoder: the einsum attention
        # against the kernel (0 in fp32, where both are the einsum)
        row["encode_rel_l2_einsum_vs_kernel_one_rank"] = float(
            (alt - b).norm() / b.norm())
        encodes[name] = b.float()
        del a, b, alt
        with groups.timed() as enc_rec:
            row["encode_ms"] = _events_ms(lambda: W.encode(
                pipe.params["encoder"], pipe.cfg, mine, dtype=dtype))
        calls = 4     # _events_ms: a warm-up and three timed
        row["encode_all_reduces"] = enc_rec.counts["all_reduce"] // calls
        row["all_reduce_ms_per_layer"] = enc_rec.ms() / calls / \
            pipe.cfg.encoder_layers
        row["all_reduce_host_ms_per_layer"] = enc_rec.host_ms / calls / \
            pipe.cfg.encoder_layers
        row["encode_ms_one_rank"] = _events_ms(lambda: W.encode(
            one.params["encoder"], one.cfg, mine, dtype=dtype))
        row["encode_windows"] = int(mine.shape[0])
        row["model_ranks"] = TP.size(group)
        report[name] = row
        return pipe, one

    drive("bf16", {}, mesh)
    # the same weights in fp32 (einsum encoder): whether tensor
    # parallelism alone parts the texts at full width
    drive("fp32", {}, mesh, torch.float32)
    torch.cuda.empty_cache()
    pipe8, one8 = drive("int8", INT8_FLAGS, mesh)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    # the yardsticks of the encodes' agreement: one rank's bf16 against
    # its fp32 (bf16 rounding), its int8 against its bf16
    report["encode_yardsticks"] = {
        "bf16_vs_fp32_one_rank": rel(encodes["bf16"], encodes["fp32"]),
        "int8_vs_bf16_one_rank": rel(encodes["int8"], encodes["bf16"])}
    encodes.clear()

    # the int8 MLP's partial mode on this rank's shard of layer 0: against
    # its plain version bit for bit; summed over the model group plus the
    # bias, against the unsharded kernel
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((3000, 1280), generator=gen, device="cuda").to(dtype)
    lp = layer_slice(pipe8.params["encoder"]["layers"], 0)
    lp1 = layer_slice(one8.params["encoder"]["layers"], 0)
    part = fused_int8_mlp(lp["fc1"], lp["fc2"], x, partial=True)
    plain = fused_int8_mlp_plain(lp["fc1"], lp["fc2"], x, partial=True)
    summed = TP.reduce_sum(part, model_group(mesh)) + lp["fc2"]["bias"].float()
    whole = fused_int8_mlp(lp1["fc1"], lp1["fc2"], x).float()
    report["int8_mlp_partial"] = {
        "rows": x.shape[0], "ffn_shard": int(lp["fc1"]["kernel_q"].shape[-1]),
        "bit_equal_to_plain": bool(torch.equal(part, plain)),
        "max_abs_err_plain": float((part - plain).abs().max()),
        "sum_max_abs_err_vs_unsharded": float(
            (summed.to(dtype).float() - whole).abs().max()),
        "unsharded_max_abs": float(whole.abs().max())}
    if rank == 0:
        xl = torch.randn((TP_MLP_ROWS, 1280), generator=gen,
                         device="cuda").to(dtype)
        report["int8_mlp_partial"].update(
            timing_rows=TP_MLP_ROWS,
            partial_ms=cuda_ms(lambda: fused_int8_mlp(
                lp["fc1"], lp["fc2"], xl, partial=True)),
            full_mode_ms=cuda_ms(lambda: fused_int8_mlp(
                lp["fc1"], lp["fc2"], xl)),
            unsharded_ms=cuda_ms(lambda: fused_int8_mlp(
                lp1["fc1"], lp1["fc2"], xl)))
        del xl
    del pipe8, one8, lp, lp1, x, part, plain, summed, whole
    report["drive_collective_launches"] = mesh_counts()
    # every decode of the sharded tree on CUDA graphs against its plain loop
    report["graphs"] = meshed_graph_cases(full, tp_cfg, mesh, tok)
    report["large_encode"] = large_tp_encode(full, tp_cfg, mesh)
    if world >= 4:
        # every card on the model axis: tp = world, bf16
        drive(f"bf16_tp{world}", {}, make_mesh((1, world)))
    del full
    torch.cuda.empty_cache()

    # tensor-parallel distillation through the CLI; the first batch of
    # this rank recorded for the one-process reference
    original = run_distillation.build_train_step

    def recording_build(*args, **kwargs):
        train_step, eval_step = original(*args, **kwargs)

        def recorded(state, teacher, batch, generator=None):
            path = out / f"tp-batch-rank{rank}.pt"
            if not path.exists():
                torch.save({k: v.cpu() for k, v in batch.items()}, path)
            return train_step(state, teacher, batch, generator)

        recorded.data_parallel = train_step.data_parallel
        return recorded, eval_step

    run_distillation.build_train_step = recording_build
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_distillation.main([
        "--teacher_checkpoint", spec["teacher"],
        "--student_checkpoint", spec["student"],
        "--train_dataset_path", spec["train"],
        "--output_dir", str(out / "distill"),
        "--teacher_precision", "inference", "--precision", "half_mixed",
        "--per_device_train_batch_size", str(TP_BATCH),
        "--max_label_length", "128", "--max_steps", str(TP_STEPS),
        "--warmup_steps", "2", "--learning_rate", "1e-4",
        "--save_steps", str(TP_STEPS), "--eval_steps", "1000",
        "--logging_steps", "1", "--language", "en", "--seed", "42",
        "--wer_threshold", "10", "--distributed",
        "--model_parallel", str(TP_DEGREE)])
    torch.cuda.synchronize()
    run_distillation.build_train_step = original
    report["distill"] = {"s": time.perf_counter() - t0,
                         "launches": read_counts()}
    torch.cuda.empty_cache()

    # the small fp32 model: greedy and n-gram speculation on the shards,
    # token for token one rank's greedy
    small, scfg = load_params(spec["small"], device="cuda")
    sharded = shard_params(small, mesh, cfg=scfg)
    wavs = np.zeros((2, scfg.n_samples), np.float32)
    for j, c in enumerate(synthetic_audio(2, 10.0, seed=7)):
        wavs[j, :len(c)] = c
    mel = compute_mel(wavs, scfg, device="cuda")
    sprompt = torch.tensor([prompt] * 2, device="cuda")
    opts = GenerationOptions.from_config(scfg, max_new_tokens=16)
    one = encode_and_generate(small, scfg, mel, sprompt, opts,
                              device="cuda").sequences
    greedy = encode_and_generate(sharded, scfg, mel, sprompt, opts,
                                 device="cuda").sequences
    cross = W.cross_kv(sharded["decoder"], scfg,
                       W.encode(sharded["encoder"], scfg, mel))
    ngram = S.ngram_speculative_generate_batched(
        sharded["decoder"], scfg, cross, sprompt, opts, gamma=5,
        max_ngram=3).sequences
    report["small"] = {"greedy_equal": bool(torch.equal(greedy, one)),
                       "ngram_equal": bool(torch.equal(ngram, one))}
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def phase_tensor_parallel_path(teacher_cfg, root):
    """Tensor parallelism over the mesh's 'model' axis (``TP_DEGREE``)
    across ``max(2, cards)`` spawned ranks: NCCL when every rank has a
    card (a (2, 2) mesh on four cards), else two ranks sharing one card
    over gloo (a (1, 2) mesh).  Each rank (``tp_rank``): the bf16 and int8
    distil-large-v3 pipelines (``TP_ENCODER_LAYERS`` encoder layers) with
    ``mesh=`` on ``TP_WINDOWS`` windows (launches a rank: log-mel 1,
    encoder attention and, on the int8 flags, the int8 MLP one a layer;
    texts against one rank's, with the near-tie report of
    every parting row; the encode of the rank's windows and its
    all-reduces timed), the int8 MLP's partial mode (bit for bit its plain
    version; summed plus the bias against the unsharded kernel),
    ``run_distillation --distributed --model_parallel`` with the
    ``training_teacher`` (``TP_STEPS`` steps of ``TP_BATCH`` rows a data rank), the
    small fp32 model's greedy and n-gram speculation.  On four cards, also
    the bf16 pipeline at tp 4.  Here: the step-1 loss against one process
    on the data ranks' concatenated batches (``MG_LOSS_TOL``) and
    ``dryrun_multigpu(world, model_parallel=TP_DEGREE)``.  ``root`` holds
    the teacher, student and manifests of ``training_path``."""
    import logging
    import shutil
    import torch

    logging.basicConfig(level=logging.WARNING)
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    world = max(2, cards)
    report = {"world": world, "cards": cards,
              "mesh": [world // TP_DEGREE, TP_DEGREE],
              "backend": "nccl" if cards >= world else "gloo"}
    tp_dir = root / "tensor_parallel"
    try:
        tp_dir.mkdir()
        synthetic_tokenizer(tp_dir)
        spec = {"teacher": str(root / "teacher"),
                "student": str(root / "student"),
                "train": str(root / "train.jsonl"), "tok": str(tp_dir),
                "small": str(small_checkpoint(tp_dir)),
                "out": str(tp_dir / "out")}
        Path(spec["out"]).mkdir()
        t0 = time.perf_counter()
        ranks = run_ranks(world, spec, tp_rank)
        report["ranks_s"] = time.perf_counter() - t0
        out = Path(spec["out"])
        for key in ("bf16", "fp32", "int8", f"bf16_tp{world}"):
            if key in ranks[0]:
                report[key] = [r[key] for r in ranks]
        report["int8_mlp_partial"] = [r["int8_mlp_partial"] for r in ranks]
        report["encode_yardsticks"] = [r["encode_yardsticks"] for r in ranks]
        report["graphs"] = [r["graphs"] for r in ranks]
        report["large_encode"] = [r["large_encode"] for r in ranks]
        report["drive_collective_launches"] = [
            r["drive_collective_launches"] for r in ranks]
        report["mesh_collective"] = ranks[0]["mesh_collective"]
        _MESH["rows"] = ranks[0]["mesh_collective"]
        _MESH["tensor_parallel_rank0"] = {
            m: ranks[0]["drive_collective_launches"][m]
            + ranks[0]["graphs"]["collective_launches"][m]
            for m in ranks[0]["drive_collective_launches"]}
        report["small"] = [r["small"] for r in ranks]
        metrics = _train_rows(_metrics(out / "distill"))
        report["distill"] = {
            "loss": [m["train/loss"] for m in metrics],
            "grad_norm": [m["train/grad_norm"] for m in metrics],
            "step_ms_ranks": [[t * 1e3 for t in m["train/step_time_s_ranks"]]
                              for m in metrics],
            "label_tokens": [m["train/label_tokens"] for m in metrics],
            "launches": [r["distill"]["launches"] for r in ranks],
            "s": [round(r["distill"]["s"], 2) for r in ranks]}
        # the data ranks' first batches: the first rank of each model group
        ref = one_process_reference(
            root / "teacher", root / "student",
            [torch.load(out / f"tp-batch-rank{r}.pt", weights_only=True)
             for r in range(0, world, TP_DEGREE)])
        report["step1_vs_one_process"] = {
            k: [metrics[0][f"train/{k}"], ref[k]]
            for k in ("loss", "ce_loss", "kl_loss")}
        report["step1_rel_diff"] = max(
            abs(a - b) / abs(b)
            for a, b in report["step1_vs_one_process"].values())
        report["step_ms_one_process_one_rank_batch"] = ref["step_ms_one_rank"]
        # raises when the step or the tokens part from one process's
        dry = dryrun("tensor_parallel", world)
        report["dryrun"] = {k: dry[k] for k in (
            "backend", "model_parallel", "grad_err", "param_err",
            "loss_rel_err", "update_err", "generate_tokens_equal", "s")}
    finally:
        shutil.rmtree(tp_dir, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "tensor_parallel_path", **report})

    bad = check_mesh_collective_rows(report["mesh_collective"])
    layers = TP_ENCODER_LAYERS
    for r in range(world):
        g = report["graphs"][r]
        if not g["collective_launches"]["sum"]:
            bad.append(f"rank {r}: the meshed graph cases launched no "
                       f"device all-reduce: {g['collective_launches']}")
        big = report["large_encode"][r]
        if not (big["finite"] and big["sum_launches"] > big["all_reduces"]
                and big["rel_l2_vs_one_rank"] <= TP_ENCODE_REL_L2["bf16"]):
            bad.append(f"rank {r}: the {TP_LARGE_WINDOWS}-window encode "
                       f"past the comm's slot: {big}")
        if not report["drive_collective_launches"][r]["max"]:
            bad.append(f"rank {r}: the int8 pipeline launched no device "
                       f"max: {report['drive_collective_launches'][r]}")
        for key, limit in TP_ENCODE_REL_L2.items():
            got = report[key][r]["encode_rel_l2_vs_one_rank"]
            if not got <= limit:
                bad.append(f"rank {r}: the {key} encode is {got} from one "
                           f"rank's (relative L2), over {limit}")
        fp32 = report["fp32"][r]
        if not fp32.get("near_ties", {"all_near_ties": True})[
                "all_near_ties"]:
            bad.append(f"rank {r}: fp32 texts part from one rank's beyond "
                       f"a near-tie: {fp32['near_ties']}")
        for key, mlp in (("bf16", 0), ("int8", layers)):
            got = report[key][r]["launches"]
            want = dict(log_mel=1, encoder_attention=layers,
                        encoder_attention_grad=0, int8_mlp=mlp,
                        int8_decode_attention=0)
            if got != want:
                bad.append(f"rank {r} {key} launches {got}, want {want}")
        p = report["int8_mlp_partial"][r]
        if not p["bit_equal_to_plain"]:
            bad.append(f"rank {r}: partial mode vs plain {p}")
        if not p["sum_max_abs_err_vs_unsharded"] <= \
                2 ** -7 * p["unsharded_max_abs"]:
            bad.append(f"rank {r}: summed partials vs unsharded {p}")
        if not all(report["small"][r].values()):
            bad.append(f"rank {r}: small model {report['small'][r]}")
        got = report["distill"]["launches"][r]
        if got["encoder_attention"] != teacher_cfg.encoder_layers * TP_STEPS:
            bad.append(f"rank {r} distill launches {got}")
    d = report["distill"]
    if len(d["loss"]) != TP_STEPS or not all(
            map(math.isfinite, d["loss"] + d["grad_norm"])):
        bad.append(f"distillation: {d}")
    if not report["step1_rel_diff"] <= MG_LOSS_TOL:
        bad.append(f"step 1 vs one process: {report['step1_vs_one_process']}")
    if bad:
        raise AssertionError("tensor parallel path: " + "; ".join(bad))
    return {f"tp_{key}_rank{r}": report[key][r]["launches"]
            for key in ("bf16", "int8") for r in range(world)} | {
        f"tp_distill_rank{r}": report["distill"]["launches"][r]
        for r in range(world)}

PS_STEPS = 1          # 2-D distillation steps of param_sharding_path
PS_BATCH = 4          # its rows a data rank a step
PS_LANES = 8          # engine lanes / micro-batch rows of its meshed serving
PS_NEW_TOKENS = 32    # their budget (8 requests a scheduler)
# the int8 teacher's step-1 KL term on a model axis, vs one process: its
# fused MLP's partial mode is another rounding of the unsharded kernel, and
# moves the small KL term by 1.24e-4 of itself on four H100s; the bf16
# teacher in its place moves it by 1.34e-3 (PERF.md section 6); the limit
# sits between the two
PS_INT8_KL_TOL = 4e-4
# the meshed schedulers' texts equal to one rank's, at least: one parting
# at a near-tie in 8 rows was seen on one and on four cards
PS_EQUAL_FLOOR = 0.75


def step1_references(teacher_dir: Path, student_dir: Path, runs):
    """One process's step-1 losses for ``runs`` ``{name: (teacher
    precision "inference" | "int8", the data ranks' first batches)}``, as
    ``run_distillation --precision half_mixed`` builds its step, the
    teacher and student loaded once: each rank's batch evaluated alone
    and the terms combined by label tokens, as the ranks sum them (the
    int8 lm head's gate, batch >= 8, sees a rank's rows)."""
    import torch
    from distil_whisper_tpu_torch.cli.run_distillation import to_compute_dtype
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.ops.quant import quantize_teacher_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step)
    full, tcfg = load_params(str(teacher_dir), device="cuda")
    tcfg = tcfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    student, scfg = load_params(str(student_dir), device="cuda")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=2,
                          total_steps=PS_STEPS,
                          schedule="constant_with_warmup",
                          precision="half_mixed", frozen_prefixes=("encoder",))
    state = TrainState.create(student, opt)
    del student
    _, eval_step = build_train_step(scfg, tcfg, DistillConfig(), opt)
    out = {}
    for name, (precision, batches) in runs.items():
        teacher = to_compute_dtype(quantize_teacher_params(full)
                                   if precision == "int8" else full,
                                   torch.bfloat16)
        with torch.no_grad():
            parts = [(int((b["labels"] != -100).sum()),
                      eval_step(state.params, teacher,
                                {k: v.cuda() for k, v in b.items()}))
                     for b in batches]
        n = sum(c for c, _ in parts)
        out[name] = {k: sum(c * float(m[k]) for c, m in parts) / n
                     for k in parts[0][1]}
        del teacher
    del full, state
    torch.cuda.empty_cache()
    return out


def _state_bytes(state):
    """Persistent bytes a rank of a placed TrainState (parameters, AdamW
    moments, accumulated gradient), and what the same state holds with
    no leaf sliced over 'data' (the 1-D placement on the same mesh)."""
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.parallel.mesh import coordinates
    from distil_whisper_tpu_torch.training.state import sharded_axes
    dp = coordinates(state.mesh)[1]
    out = {}
    for name, tree in (("params", tree_paths(state.params)),
                       ("mu", state.mu), ("nu", state.nu)):
        mine = sum(x.numel() * x.element_size() for x in tree.values())
        whole = sum(x.numel() * x.element_size()
                    * (dp if sharded_axes(p, state.mesh, state.rules)[1]
                       else 1) for p, x in tree.items())
        out[name] = {"bytes": mine, "bytes_1d": whole}
    return out


PS_FP32_WINDOWS = 2     # fp32_2d_eval: windows a data rank
PS_FP32_NEW_TOKENS = 16  # and their budget


def fp32_2d_eval(cfg, mesh, tok) -> dict:
    """``encode_and_generate`` of an fp32 tree of ``cfg`` (random weights)
    sharded under ``RULES_2D`` over ``mesh``, as ``run_distillation``'s
    eval runs on fp32 parameters: every layer and the fp32 token embedding
    (132.8 MB a rank at two data ranks and d_model 1280) gathered through
    the device comm, the decode on CUDA graphs; ``PS_FP32_WINDOWS``
    windows a data rank against one rank's ``encode_and_generate`` of the
    whole tree on them: tokens equal (a 2-D gather is exact)."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                     encode_and_generate)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.parallel import RULES_2D, device_comm, fsdp
    from distil_whisper_tpu_torch.parallel.mesh import (coordinates,
                                                        data_group,
                                                        shard_params)
    full = init_params(cfg, seed=3, device="cuda", dtype=torch.float32)
    tree = shard_params(full, mesh, RULES_2D, cfg=cfg)
    d, n_data, _, _ = coordinates(mesh)
    w = PS_FP32_WINDOWS
    clips = synthetic_audio(w * n_data, 20.0, seed=41)
    mels = compute_mel(np.stack(clips), cfg, device="cuda")[d * w:(d + 1) * w]
    prompt = torch.tensor([tok.prompt_ids(language="en")] * w, device="cuda")
    opts = GenerationOptions.from_config(cfg, max_new_tokens=PS_FP32_NEW_TOKENS,
                                         no_speech_token_id=tok.no_speech)
    before = mesh_counts()["gather"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = encode_and_generate(tree, cfg, mels, prompt, opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gathers = mesh_counts()["gather"] - before
    one = encode_and_generate(full, cfg, mels, prompt, opts, device="cuda")
    largest = fsdp.largest_gather(tree)
    slot = device_comm.comm_of(data_group(mesh)).slot
    rep_ = {"windows": w, "new_tokens": PS_FP32_NEW_TOKENS, "s": wall,
            "gather_launches": gathers, "largest_gather_bytes": largest,
            "slot_bytes": slot,
            "pieces_largest": len(device_comm.pieces(largest, slot)),
            "seq_len": out.seq_len.tolist(),
            "tokens_equal_to_one_rank": bool(
                torch.equal(out.sequences, one.sequences)
                and torch.equal(out.seq_len, one.seq_len))}
    del full, tree, out, one
    torch.cuda.empty_cache()
    return rep_


def ps_rank(rank: int, world: int, port: int, spec: dict) -> None:
    """One rank of ``param_sharding_path``: ``run_distillation
    --distributed --param_sharding 2d`` with the bf16 and the int8 teacher
    (the placed state's bytes, the all-gathers and reduce-scatters, the
    peak memory, the first batch recorded), then distil-large-v3 in bf16
    served from a mesh by the continuous engine and the micro-batch
    scheduler (rank 0 leading, the others following), the engine's texts
    against one rank's, and one POST through ``run_server
    --distributed``; writes ``rank{rank}.json``."""
    import logging
    import os
    import urllib.request
    import threading
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.WARNING)
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli import run_distillation, run_server
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import GenerationOptions
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.parallel import (
        RULES_2D, groups, make_mesh, maybe_initialize_distributed)
    from distil_whisper_tpu_torch.parallel.mesh import coordinates
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber
    from distil_whisper_tpu_torch.tokenizer import WhisperTokenizer
    maybe_initialize_distributed(force=True)
    out = Path(spec["out"])
    mp = 1 if world == 2 else 2
    report = {"rank": rank, "world": world, "backend": dist.get_backend()}

    build, place = run_distillation.build_train_step, \
        run_distillation.place_state
    placed = []

    def placing(*args, **kwargs):
        state = place(*args, **kwargs)
        placed.append(_state_bytes(state))
        return state

    def distill(name, precision):
        def recording_build(*args, **kwargs):
            train_step, eval_step = build(*args, **kwargs)

            def recorded(state, teacher, batch, generator=None):
                path = out / f"ps-{name}-batch-rank{rank}.pt"
                if not path.exists():
                    torch.save({k: v.cpu() for k, v in batch.items()}, path)
                return train_step(state, teacher, batch, generator)

            recorded.data_parallel = train_step.data_parallel
            return recorded, eval_step

        run_distillation.build_train_step = recording_build
        run_distillation.place_state = placing
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with groups.timed() as rec:
            run_distillation.main([
                "--teacher_checkpoint", spec["teacher"],
                "--student_checkpoint", spec["student"],
                "--train_dataset_path", spec["train"],
                "--output_dir", str(out / name),
                "--teacher_precision", precision, "--precision", "half_mixed",
                "--per_device_train_batch_size", str(PS_BATCH),
                "--max_label_length", "128", "--max_steps", str(PS_STEPS),
                "--warmup_steps", "2", "--learning_rate", "1e-4",
                "--save_steps", str(PS_STEPS), "--eval_steps", "1000",
                "--logging_steps", "1", "--language", "en", "--seed", "42",
                "--wer_threshold", "10", "--distributed",
                "--model_parallel", str(mp), "--param_sharding", "2d"])
        torch.cuda.synchronize()
        run_distillation.build_train_step = build
        run_distillation.place_state = place
        report[name] = {
            "s": time.perf_counter() - t0, "launches": read_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "state": placed[-1], "all_gathers": rec.counts["all_gather"],
            "reduce_scatters": rec.counts["reduce_scatter"],
            "all_reduces": rec.counts["all_reduce"],
            "collective_ms": rec.ms(), "collective_host_ms": rec.host_ms,
            "received_bytes": rec.bytes["all_gather"]
            + rec.bytes["reduce_scatter"]}
        torch.cuda.empty_cache()

    distill("distill", "inference")
    distill("distill_int8", "int8")

    # serving from the mesh: distil-large-v3, random bf16 weights
    mesh = make_mesh((1, world) if world == 2 else (2, 2))
    report["serving_mesh"] = list(coordinates(mesh)[1::2])
    tok = WhisperTokenizer.from_pretrained(spec["tok"])
    cfg = PRESETS["distil-large-v3"]
    full = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    clips = synthetic_audio(PS_LANES, 20.0, seed=11)
    requests = [(c, {"language": "en"}) for c in clips]

    def pipeline(mesh_):
        return WhisperPipeline(None, dtype=torch.bfloat16,
                               batch_size=PS_LANES,
                               max_new_tokens=PS_NEW_TOKENS, params=full,
                               cfg=cfg, tokenizer=tok, device="cuda",
                               mesh=mesh_)

    def serve(name, tr):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with groups.timed() as rec:
            if tr.leader:
                tr.start()
                try:
                    results, latency, wall = serve_all(tr, requests,
                                                       timeout=300)
                finally:
                    tr.stop()
            else:
                tr.follow()
        torch.cuda.synchronize()
        row = {"s": time.perf_counter() - t0, "launches": read_counts(),
               "all_reduces": rec.counts["all_reduce"],
               "all_reduce_ms": rec.ms()}
        if tr.leader:
            row.update(texts=[r["text"] for r in results],
                       p50_ms=_percentile(latency, 50) * 1e3,
                       wall_s=wall, stats=dict(tr.stats))
        report[name] = row

    pipe = pipeline(mesh)
    serve("engine", ContinuousTranscriber(
        pipe, batch_size=PS_LANES, max_new_tokens=PS_NEW_TOKENS,
        block_steps=16))
    serve("microbatch", BatchingTranscriber(
        pipe, batch_size=PS_LANES, max_new_tokens=PS_NEW_TOKENS,
        max_wait_ms=200))
    del pipe
    # a 2-D decode on CUDA graphs against the plain loop, data rank 0's rows
    # ending first: (2, 1) on one card, the serving mesh on four
    reset_mesh_counts()
    mesh_2d = make_mesh((2, 1)) if world == 2 else mesh
    report["graphs_2d"] = meshed_graph_cases(
        full, cfg, mesh_2d, tok, rules=RULES_2D, eos_rank=0,
        new_tokens=MESH_2D_NEW_TOKENS, full_set=False)
    report["fp32_2d_eval"] = fp32_2d_eval(cfg, mesh_2d, tok)
    if rank == 0:
        # one rank's engine on the same weights, and the near-tie report of
        # any request whose text parts from it
        one = pipeline(None)
        tr = ContinuousTranscriber(one, batch_size=PS_LANES,
                                   max_new_tokens=PS_NEW_TOKENS,
                                   block_steps=16).start()
        try:
            ref = [r["text"] for r in serve_all(tr, requests)[0]]
        finally:
            tr.stop()
        report["engine_one_rank_texts"] = ref
        for name in ("engine", "microbatch"):
            texts = report[name]["texts"]
            report[name]["equal_to_one_rank"] = sum(
                a == b for a, b in zip(texts, ref)) / len(ref)
            if texts != ref:
                prompt = tok.prompt_ids(language="en")
                mels = compute_mel(np.stack(clips), cfg,
                                   device="cuda").to(torch.bfloat16)
                opts = GenerationOptions.from_config(
                    one.cfg, max_new_tokens=PS_NEW_TOKENS,
                    no_speech_token_id=tok.no_speech)
                seqs, lens, _ = one._decode_batch(
                    mels, [prompt] * len(clips), opts, 1, 1.0)
                report[name]["near_ties"] = text_near_ties(
                    one, mels, seqs, lens, texts, ref, prompt,
                    [PS_NEW_TOKENS] * len(clips))
        del one
    del full
    torch.cuda.empty_cache()

    # one POST through run_server --distributed
    reset_counts()
    httpd, tr = run_server.build_server([
        "--model_checkpoint", spec["student"], "--device", "cuda",
        "--dtype", "bfloat16", "--host", "127.0.0.1", "--port", "0",
        "--distributed", "--model_parallel", "2",
        "--scheduler", "continuous", "--batch_size", "4",
        "--max_new_tokens", "32"])
    if httpd is None:
        tr.follow()
    else:
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            wav = out / "post.wav"
            write_wav(str(wav), clips[0], 16000, float32=True)
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/v1/transcribe"
                "?language=en", data=wav.read_bytes(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                post = json.loads(r.read())
            report["http"] = {"status": r.status, "text": post["text"],
                              "latency_s": time.perf_counter() - t0}
        finally:
            httpd.shutdown()
            httpd.server_close()
            tr.stop()
    report["http_launches"] = read_counts()
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def phase_param_sharding_path(teacher_cfg, root):
    """2-D (FSDP-style) parameter sharding and serving under a mesh across
    ``max(2, cards)`` spawned ranks (one card: two ranks over gloo; four
    cards: one a card over NCCL).  Each rank (``ps_rank``):
    ``run_distillation --distributed --param_sharding 2d`` with the
    ``training_teacher``, bf16 and int8, ``PS_STEPS`` steps of ``PS_BATCH``
    rows a data rank, on a (2, 1) mesh (one card) or (2, 2) (four); the
    continuous engine and the micro-batch scheduler serving distil-large-v3
    in bf16 from a (1, 2) mesh (one card) or (2, 2) (four), ``PS_LANES``
    lanes, 8 requests, ``PS_NEW_TOKENS`` tokens; one POST through
    ``run_server --distributed``.  Here: the step-1 loss terms against
    one process on the data ranks' first batches (``MG_LOSS_TOL``; the
    int8 teacher's KL term on a model axis ``PS_INT8_KL_TOL``), the
    placed state's bytes a rank against the 1-D placement, the meshed
    schedulers' texts against one rank's (``PS_EQUAL_FLOOR``, and every
    parting a near-tie), and
    ``dryrun_multigpu(4, model_parallel=2, param_sharding="2d")`` (the
    small fp32 model's 2-D step and engine against one process; four
    ranks sharing one card over gloo, or one a card)."""
    import logging
    import shutil
    import torch

    logging.basicConfig(level=logging.WARNING)
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    world = max(2, cards)
    mp = 1 if world == 2 else 2
    report = {"world": world, "cards": cards,
              "distill_mesh": [world // mp, mp],
              "backend": "nccl" if cards >= world else "gloo"}
    ps_dir = root / "param_sharding"
    try:
        ps_dir.mkdir()
        synthetic_tokenizer(ps_dir)
        spec = {"teacher": str(root / "teacher"),
                "student": str(root / "student"),
                "train": str(root / "train.jsonl"), "tok": str(ps_dir),
                "out": str(ps_dir / "out")}
        Path(spec["out"]).mkdir()
        t0 = time.perf_counter()
        ranks = run_ranks(world, spec, ps_rank)
        report["ranks_s"] = time.perf_counter() - t0
        out = Path(spec["out"])
        refs = step1_references(root / "teacher", root / "student", {
            name: (precision, [torch.load(
                out / f"ps-{name}-batch-rank{r}.pt", weights_only=True)
                for r in range(0, world, mp)])
            for name, precision in (("distill", "inference"),
                                    ("distill_int8", "int8"))})
        for name in ("distill", "distill_int8"):
            metrics = _train_rows(_metrics(out / name))
            ref = refs[name]
            row = {k: [r[name][k] for r in ranks] for k in (
                "s", "launches", "peak_bytes", "state", "all_gathers",
                "reduce_scatters", "all_reduces", "collective_ms",
                "collective_host_ms", "received_bytes")}
            row.update(
                loss=[m["train/loss"] for m in metrics],
                step_ms_ranks=[[t * 1e3 for t in m["train/step_time_s_ranks"]]
                               for m in metrics],
                step1_vs_one_process={k: [metrics[0][f"train/{k}"], ref[k]]
                                      for k in ("loss", "ce_loss",
                                                "kl_loss")})
            # every term at MG_LOSS_TOL, but the int8 teacher's KL term on a
            # model axis at PS_INT8_KL_TOL
            row["limits"] = {k: MG_LOSS_TOL for k in
                             row["step1_vs_one_process"]}
            if name == "distill_int8" and mp > 1:
                row["limits"]["kl_loss"] = PS_INT8_KL_TOL
            row["step1_rel_diff"] = {
                k: abs(a - b) / abs(b)
                for k, (a, b) in row["step1_vs_one_process"].items()}
            report[name] = row
        for name in ("engine", "microbatch"):
            report[name] = [r[name] for r in ranks]
        report["serving_mesh"] = ranks[0]["serving_mesh"]
        report["graphs_2d"] = [r["graphs_2d"] for r in ranks]
        report["fp32_2d_eval"] = [r["fp32_2d_eval"] for r in ranks]
        _MESH["param_sharding_2d_rank0"] = ranks[0]["graphs_2d"][
            "collective_launches"]
        report["engine_one_rank_texts"] = ranks[0]["engine_one_rank_texts"]
        report["http"] = ranks[0]["http"]
        report["http_launches"] = [r["http_launches"] for r in ranks]
        dry = dryrun("param_sharding", world)
        report["dryrun"] = {k: dry[k] for k in (
            "backend", "param_sharding", "grad_err", "param_err",
            "loss_rel_err", "int8_teacher_err", "qat_err",
            "generate_tokens_equal", "engine_texts_equal",
            "engine_ts_fallback", "engine_drafted")}
        report["dryrun"]["s"] = dry["s"]
    finally:
        shutil.rmtree(ps_dir, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "param_sharding_path", **report})

    bad = []
    layers = teacher_cfg.encoder_layers
    for name in ("distill", "distill_int8"):
        row = report[name]
        if len(row["loss"]) != PS_STEPS or not all(
                map(math.isfinite, row["loss"])):
            bad.append(f"{name}: losses {row['loss']}")
        for k, d in row["step1_rel_diff"].items():
            if not d <= row["limits"][k]:
                bad.append(f"{name} step-1 {k} {d} off one process's, over "
                           f"{row['limits'][k]}: "
                           f"{row['step1_vs_one_process'][k]}")
        for r in range(world):
            got = row["launches"][r]
            if got["encoder_attention"] != layers * PS_STEPS:
                bad.append(f"rank {r} {name} launches {got}")
            if name == "distill_int8" and not got["int8_mlp"]:
                bad.append(f"rank {r} {name}: no int8 MLP launch {got}")
            state = row["state"][r]
            if not state["params"]["bytes"] < state["params"]["bytes_1d"]:
                bad.append(f"rank {r} {name}: 2-D holds {state}")
    g2 = report["graphs_2d"]
    first = range(world // 2)       # data rank 0 (the model axis inner)
    ended = {r: max(g2[r]["generate"]["seq_len"]) for r in range(world)}
    if not max(ended[r] for r in first) < min(ended[r] for r in range(
            world) if r not in first):
        bad.append(f"2-D decode: data rank 0's rows did not end first: "
                   f"{ended}")
    for r in range(world):
        got = g2[r]["collective_launches"]
        if not (got["gather"] and got["sum_int"]):
            bad.append(f"rank {r}: the 2-D graph cases launched no device "
                       f"gather or stop agreement: {got}")
        ev = report["fp32_2d_eval"][r]
        if not (ev["tokens_equal_to_one_rank"] and ev["gather_launches"]):
            bad.append(f"rank {r}: the fp32 2-D eval: {ev}")
    lead = {name: report[name][0] for name in ("engine", "microbatch")}
    for name, row in lead.items():
        if len(row["texts"]) != PS_LANES or not all(row["texts"]):
            bad.append(f"{name} texts {row['texts']}")
        if not row["equal_to_one_rank"] >= PS_EQUAL_FLOOR:
            bad.append(f"{name}: {row['equal_to_one_rank']} of its texts "
                       f"equal one rank's, under {PS_EQUAL_FLOOR}")
        if row["texts"] != report["engine_one_rank_texts"] and \
                not row["near_ties"]["all_near_ties"]:
            bad.append(f"{name} texts part from one rank's beyond a "
                       f"near-tie: {row['near_ties']}")
        for r in range(world):
            # the leader featurizes; every rank encodes its lanes' rows
            got = report[name][r]["launches"]
            if (r == 0 and not got["log_mel"]) or \
                    not got["encoder_attention"]:
                bad.append(f"rank {r} {name} launches {got}")
    if report["http"]["status"] != 200 or not report["http"]["text"]:
        bad.append(f"http {report['http']}")
    if bad:
        raise AssertionError("param sharding path: " + "; ".join(bad))
    counts = {}
    for r in range(world):
        counts[f"ps_distill_rank{r}"] = report["distill"]["launches"][r]
        counts[f"ps_distill_int8_rank{r}"] = \
            report["distill_int8"]["launches"][r]
        counts[f"ps_engine_rank{r}"] = report["engine"][r]["launches"]
        counts[f"ps_microbatch_rank{r}"] = report["microbatch"][r]["launches"]
        counts[f"ps_http_rank{r}"] = report["http_launches"][r]
    return counts


def phase_small_reference(tok):
    """A small model on the card against the CPU: fp32 greedy tokens
    identical, bf16 fused (kernel) encoder close to the fp32 CPU encoder;
    then the int8 lane and the long-form paths on the same small model.
    test-tiny widened to heads of 64, the kernel's head dim."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                      encode_and_generate)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths

    cfg = PRESETS["test-tiny"].replace(d_model=128, encoder_attention_heads=2,
                                       decoder_attention_heads=2)
    cpu = init_params(cfg, seed=3, device="cpu")
    gpu = unflatten_paths({p: x.cuda() for p, x in tree_paths(cpu).items()})
    gpu16 = unflatten_paths({p: x.cuda().to(torch.bfloat16)
                             for p, x in tree_paths(cpu).items()})
    mel = np.random.default_rng(4).standard_normal((2, 80, 3000)).astype("float32")
    prompt = [[50258, 50259, 50359, 50363]] * 2
    opts = GenerationOptions.from_config(cfg, max_new_tokens=24)
    a = encode_and_generate(cpu, cfg, mel, prompt, opts, device="cpu")
    b = encode_and_generate(gpu, cfg, mel, prompt, opts, device="cuda")
    same = torch.equal(a.sequences, b.sequences.cpu())
    fcfg = cfg.replace(use_flash_encoder=True, fast_bf16_attention=True)
    e32 = W.encode(cpu["encoder"], cfg, torch.from_numpy(mel))
    e16 = W.encode(gpu16["encoder"], fcfg, torch.from_numpy(mel).cuda(),
                   dtype=torch.bfloat16).float().cpu()
    rel = ((e16 - e32).norm() / e32.norm()).item()
    emit({"phase": "small_reference", "fp32_tokens_identical": same,
          "bf16_kernel_encoder_rel_err": rel})
    if not same or not rel < 2e-2:
        raise AssertionError("the card disagrees with the CPU on test-tiny")
    small_reference_int8(cfg, mel, prompt)
    small_reference_longform(cfg, mel, tok)
    small_reference_speculative(cfg, mel, tok)
    small_reference_serving(cfg, tok)


def small_reference_longform(cfg, mel, tok):
    """The widened test-tiny with the synthetic tokenizer's vocabulary, fp32
    on the card against the CPU at the same weights: beam tokens identical,
    sequential segments at temperature 0 identical (the same whole-file
    features on both sides), word-timestamp token times equal."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber,
        encode_and_beam_search)
    from distil_whisper_tpu_torch.generation.word_timestamps import (
        default_alignment_heads, extract_token_timestamps)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths

    scfg = cfg.replace(vocab_size=51866)       # the tokenizer's layout
    cpu = init_params(scfg, seed=6, device="cpu")
    gpu = unflatten_paths({p: x.cuda() for p, x in tree_paths(cpu).items()})
    prompt = [tok.prompt_ids(language="en", no_timestamps=False)] * 2
    opts = GenerationOptions.from_config(scfg, max_new_tokens=24,
                                         return_timestamps=True,
                                         no_speech_token_id=tok.no_speech)
    a = encode_and_beam_search(cpu, scfg, mel, prompt, opts, num_beams=3,
                               device="cpu")
    b = encode_and_beam_search(gpu, scfg, mel, prompt, opts, num_beams=3,
                               device="cuda")
    beam_same = torch.equal(a.sequences, b.sequences.cpu())

    files = [x[:int(sec * 16000)] for x, sec in
             zip(synthetic_audio(2, 62.0, seed=9), (62.0, 45.0))]
    feats = [compute_mel(x, scfg, pad_to_chunk=False, device="cpu")[0].numpy()
             for x in files]
    sopts = SequentialOptions(temperatures=(0.0,), max_new_tokens=48)
    segs = [_segment_keys(SequentialTranscriber(
        params, scfg, tok, sopts, language="en", batch_size=2,
        device=device).transcribe(feats))
        for params, device in ((cpu, "cpu"), (gpu, "cuda"))]

    heads = default_alignment_heads(scfg)
    times = [extract_token_timestamps(
        params, scfg, a.sequences, a.seq_len, len(prompt[0]), heads,
        enc=W.encode(params["encoder"], scfg, torch.from_numpy(mel).to(device)),
        num_frames=[3000, 2000]) for params, device in ((cpu, "cpu"),
                                                        (gpu, "cuda"))]
    emit({"phase": "small_reference_longform", "fp32_beam_identical": beam_same,
          "fp32_sequential_segments_identical": segs[0] == segs[1],
          "sequential_segments": sum(len(r) for r in segs[0]),
          "fp32_word_times_equal": bool(np.array_equal(*times)),
          "word_times_max_abs_diff": float(np.abs(times[0] - times[1]).max())})
    if not (beam_same and segs[0] == segs[1] and np.array_equal(*times)):
        raise AssertionError("the card disagrees with the CPU on the "
                             "long-form paths of test-tiny")


def small_reference_speculative(cfg, mel, tok):
    """The widened test-tiny as a 4-layer teacher with a 2-layer draft (its
    own weights), fp32: draft and n-gram speculation on the card give the
    CPU greedy tokens, with timestamps, batched, and a draft equal to the
    teacher accepts every proposal; the speculative sequential t = 0 rung
    on the card gives the plain CPU rung's segments."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber,
        encode_and_generate)
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths

    tcfg = cfg.replace(vocab_size=51866, decoder_layers=4)
    dcfg = tcfg.replace(decoder_layers=2)
    cpu = init_params(tcfg, seed=7, device="cpu")
    gpu = unflatten_paths({p: x.cuda() for p, x in tree_paths(cpu).items()})
    dgpu = unflatten_paths({p: x.cuda() for p, x in tree_paths(
        init_params(dcfg, seed=8, device="cpu")).items()})
    prompt = [tok.prompt_ids(language="en", no_timestamps=False)] * 2
    opts = GenerationOptions.from_config(tcfg, max_new_tokens=32,
                                         return_timestamps=True,
                                         no_speech_token_id=tok.no_speech)
    golden = encode_and_generate(cpu, tcfg, mel, prompt, opts, device="cpu")
    enc = W.encode(gpu["encoder"], tcfg, torch.from_numpy(mel).cuda())
    t_cross = W.cross_kv(gpu["decoder"], tcfg, enc)
    prompt_t = torch.tensor(prompt, device="cuda")
    outs = {
        "draft": S.speculative_generate_batched(
            gpu["decoder"], tcfg, dgpu["decoder"], dcfg, t_cross,
            W.cross_kv(dgpu["decoder"], dcfg, enc), prompt_t, opts, gamma=3),
        "ngram": S.ngram_speculative_generate_batched(
            gpu["decoder"], tcfg, t_cross, prompt_t, opts, gamma=3),
        "self_draft": S.speculative_generate_batched(
            gpu["decoder"], tcfg, gpu["decoder"], tcfg, t_cross, t_cross,
            prompt_t, opts, gamma=3)}
    same = {k: bool(torch.equal(o.sequences.cpu(), golden.sequences)
                    and torch.equal(o.seq_len.cpu(), golden.seq_len))
            for k, o in outs.items()}
    # the graphs against the plain loop, bit for bit (each call above
    # captured into an owner of its own)
    plain_loop = {
        "draft": S.speculate_eager(
            gpu["decoder"], tcfg, t_cross, prompt_t, opts, gamma=3,
            draft=(dgpu["decoder"], dcfg,
                   W.cross_kv(dgpu["decoder"], dcfg, enc))),
        "ngram": S.speculate_eager(gpu["decoder"], tcfg, t_cross, prompt_t,
                                   opts, gamma=3)}
    graphs_equal = {k: outputs_equal(outs[k], o)
                    for k, o in plain_loop.items()}
    # a draft equal to the teacher accepts every proposal: every round but
    # a lane's last emits gamma + 1 tokens
    sd = outs["self_draft"]
    least_rounds = (sd.seq_len.cpu() - len(prompt[0]) - 1 + 3) // 4
    self_draft_all = bool(torch.equal(sd.rounds.cpu(), least_rounds)
                          and (sd.drafted - sd.accepted).max() <= 3)

    files = [x[:int(sec * 16000)] for x, sec in
             zip(synthetic_audio(2, 62.0, seed=9), (62.0, 45.0))]
    feats = [compute_mel(x, tcfg, pad_to_chunk=False, device="cpu")[0].numpy()
             for x in files]
    sopts = SequentialOptions(temperatures=(0.0,), max_new_tokens=48)
    plain_cpu = _segment_keys(SequentialTranscriber(
        cpu, tcfg, tok, sopts, language="en", batch_size=2,
        device="cpu").transcribe(feats))
    spec_tr = SequentialTranscriber(
        gpu, tcfg, tok, sopts, language="en", batch_size=2, device="cuda",
        speculative_method="draft", assistant=(dgpu, dcfg), gamma=3)
    spec_gpu = _segment_keys(spec_tr.transcribe(feats))
    emit({"phase": "small_reference_speculative",
          "fp32_tokens_identical_to_cpu_greedy": same,
          "graphs_equal_to_plain_loop": graphs_equal,
          "generated_tokens": int((golden.seq_len - len(prompt[0])).sum()),
          **{name: {k: getattr(o, k).tolist()
                    for k in ("rounds", "drafted", "accepted")}
             for name, o in outs.items()},
          "self_draft_accepts_every_proposal": self_draft_all,
          "fp32_sequential_t0_segments_identical": spec_gpu == plain_cpu,
          "sequential_segments": sum(len(r) for r in plain_cpu),
          "sequential_spec_stats": spec_tr.spec_stats})
    if not (all(same.values()) and all(graphs_equal.values())
            and self_draft_all and spec_gpu == plain_cpu
            and spec_tr.spec_stats["rounds"] > 0):
        raise AssertionError("speculation on the card disagrees with the CPU "
                             "greedy on test-tiny")


def small_reference_serving(cfg, tok):
    """The widened test-tiny (vocabulary of the synthetic tokenizer) and a
    1-layer draft of its width, fp32: the continuous engine (greedy, draft
    and n-gram lanes; 2 lanes, block 3) and the micro-batch scheduler on
    the card give the CPU pipeline's results (text and segment offsets) on
    6 requests with mixed timestamps and budgets, arriving together."""
    import torch
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber

    scfg = cfg.replace(vocab_size=51866)
    dcfg = scfg.replace(decoder_layers=1)
    cpu = init_params(scfg, seed=10, device="cpu")

    def on_card(tree):
        return unflatten_paths({p: x.cuda() for p, x in tree_paths(tree).items()})

    gpu = on_card(cpu)
    draft = on_card(init_params(dcfg, seed=11, device="cpu"))
    common = dict(dtype=torch.float32, batch_size=2, max_new_tokens=16,
                  cfg=scfg, tokenizer=tok)
    cpu_pipe = WhisperPipeline(None, params=cpu, device="cpu", **common)
    gpu_pipe = WhisperPipeline(None, params=gpu, device="cuda", **common)
    clips = synthetic_audio(6, 9.0, seed=12)
    reqs = [(c, dict(language="en", return_timestamps=(i % 3 == 0),
                     max_new_tokens=[16, 9, 12][i % 3]))
            for i, c in enumerate(clips)]
    golden = [cpu_pipe(c, **kw) for c, kw in reqs]
    same = {}
    for name, cls, kw in (
            ("engine_greedy", ContinuousTranscriber, dict(block_steps=3)),
            ("engine_draft", ContinuousTranscriber,
             dict(block_steps=3, assistant=(draft, dcfg), gamma=3)),
            ("engine_ngram", ContinuousTranscriber,
             dict(block_steps=3, ngram_speculative=True, gamma=3)),
            ("microbatch", BatchingTranscriber, dict(max_wait_ms=20.0))):
        tr = cls(gpu_pipe, batch_size=2, max_new_tokens=16, **kw).start()
        try:
            results, _, _ = serve_all(tr, reqs)
        finally:
            tr.stop()
        same[name] = results == golden
    emit({"phase": "small_reference_serving",
          "fp32_results_identical_to_cpu_pipeline": same,
          "requests": len(reqs),
          "card_pipeline_identical_to_cpu": [gpu_pipe(c, **kw) for c, kw in
                                             reqs] == golden})
    if not all(same.values()):
        raise AssertionError("serving on the card disagrees with the CPU "
                             "pipeline on test-tiny")


def small_reference_int8(cfg, mel, prompt):
    """The widened test-tiny with all five int8 flags and ffn 512, so that
    the int8 MLP kernel's gate holds (d 128, 3000 rows): fp32 on the card
    against the CPU, then the bf16 int8 encoder (both encoder kernels)
    against the fp32 CPU int8 encoder."""
    import torch
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                      encode_and_generate)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths
    from distil_whisper_tpu_torch.ops import int8_mlp
    from distil_whisper_tpu_torch.ops.quant import maybe_quantize_encoder

    qcfg = cfg.replace(encoder_ffn_dim=512, decoder_ffn_dim=512, **INT8_FLAGS)
    raw = init_params(qcfg, seed=5, device="cpu")
    cpu = maybe_quantize_encoder(raw, qcfg)
    gpu = unflatten_paths({p: x.cuda() for p, x in tree_paths(cpu).items()})
    opts = GenerationOptions.from_config(qcfg, max_new_tokens=24)
    a = encode_and_generate(cpu, qcfg, mel, prompt, opts, device="cpu")
    b = encode_and_generate(gpu, qcfg, mel, prompt, opts, device="cuda")
    agree = (a.sequences == b.sequences.cpu()).float().mean().item()

    def prefill(params, device):
        enc = W.encode(params["encoder"], qcfg, torch.from_numpy(mel).to(device))
        cross = W.cross_kv(params["decoder"], qcfg, enc)
        cache = W.init_cache(qcfg, len(prompt), device=device, max_len=8)
        logits, _ = W.decode(params["decoder"], qcfg,
                             torch.tensor(prompt, device=device), cross=cross,
                             cache=cache)
        return logits.cpu()

    la, lb = prefill(cpu, "cpu"), prefill(gpu, "cuda")
    logit_rel = ((lb - la).norm() / la.norm()).item()

    gpu16 = maybe_quantize_encoder(unflatten_paths(
        {p: x.cuda().to(torch.bfloat16) for p, x in tree_paths(raw).items()}),
        qcfg)
    fcfg = qcfg.replace(use_flash_encoder=True, fast_bf16_attention=True)
    e32 = W.encode(cpu["encoder"], qcfg, torch.from_numpy(mel))
    before = int8_mlp.fused_int8_mlp.launches
    e16 = W.encode(gpu16["encoder"], fcfg, torch.from_numpy(mel).cuda(),
                   dtype=torch.bfloat16).float().cpu()
    mlp_launches = int8_mlp.fused_int8_mlp.launches - before
    rel = ((e16 - e32).norm() / e32.norm()).item()
    emit({"phase": "small_reference_int8", "fp32_token_agreement": agree,
          "fp32_prefill_logits_rel_err": logit_rel,
          "bf16_int8_encoder_rel_err": rel, "int8_mlp_launches": mlp_launches})
    # fp32 on both sides: the int8 products are exact, other sums round in
    # another order and can move a requantization quantum; one moved quantum
    # (of the cross K/V, say) shifts every later activation a little and
    # moves further quanta downstream, so the prefill logits of the random
    # model part by about 1e-2 (9.0e-3 measured on the H100) where the fp32
    # path without int8 parts by 1e-6; a fault of layout or scale parts by
    # order 1.  Tokens may flip where a random model has a near-tie.
    if not (agree >= 0.9 and logit_rel < 3e-2 and rel < 3e-2
            and mlp_launches == qcfg.encoder_layers):
        raise AssertionError("the card disagrees with the CPU on the int8 "
                             "test-tiny")


def phase_released(weights):
    """After the distil phases: the weights behind ``weights`` (weak
    references) are freed and no graph owner is alive; the bytes left
    allocated once the library workspaces of the streams are dropped."""
    import torch
    from distil_whisper_tpu_torch.generation.graphs import GraphOwner
    gc.collect()
    alive = [w for w in weights if w() is not None]
    owners = sorted(o.name for o in gc.get_objects()
                    if isinstance(o, GraphOwner))
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    report = {"weights_alive": len(alive), "graph_owners_alive": owners,
              "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
              "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    emit({"phase": "released", **report})
    if alive or owners:
        raise AssertionError(f"the distil phases left {report} behind")
    return report


def main() -> int:
    if not (ROOT / "distil_whisper_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(distil_whisper_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    seconds = {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed_phase("build", phase_build)
    rows = timed_phase("kernels", phase_kernels)
    with tempfile.TemporaryDirectory() as tmp:
        tok = synthetic_tokenizer(Path(tmp))
    with torch.no_grad():
        bf16 = timed_phase("main_path", phase_main_path, tok)
        counts = timed_phase("int8_main_path", phase_int8_main_path, tok,
                             bf16)
        longform = timed_phase("longform_path", phase_longform_path, tok,
                               bf16)
        longform.update(timed_phase("compiled_decode_path",
                                    phase_compiled_decode_path, tok, bf16))
        longform.update(timed_phase("serving_path", phase_serving_path, tok,
                                    bf16))
        longform.update(timed_phase("speculative_path",
                                    phase_speculative_path, tok, bf16))
        # nothing of the distil phases outlives them: no weights, no graph
        # owner (whose programs hold weights and a pool)
        weights = [weakref.ref(t) for t in (
            bf16["params"]["decoder"]["tok_emb"],
            bf16["params"]["encoder"]["conv1"]["kernel"])]
        del bf16
        timed_phase("released", phase_released, weights)
        timed_phase("small_reference", phase_small_reference, tok)
    # the teacher, student and manifests of training_path serve
    # multigpu_path and recipe_path too
    shared = Path(tempfile.mkdtemp(prefix="dw_training_"))
    teacher_cfg = training_teacher()
    try:
        emit({"phase": "dryruns", "seconds_each": timed_phase(
            "dryruns", run_dryruns)})
        training = timed_phase("training_path", phase_training_path,
                               teacher_cfg, shared)
        multigpu = timed_phase("multigpu_path", phase_multigpu_path,
                               teacher_cfg, shared)
        multigpu.update(timed_phase("tensor_parallel_path",
                                    phase_tensor_parallel_path, teacher_cfg,
                                    shared))
        multigpu.update(timed_phase("param_sharding_path",
                                    phase_param_sharding_path, teacher_cfg,
                                    shared))
        recipe = timed_phase("recipe_path", phase_recipe_path, teacher_cfg,
                             shared)
    finally:
        import shutil
        shutil.rmtree(shared, ignore_errors=True)
    emit({"phase": "seconds", **seconds})
    longform.update({f"training_{k}": v for k, v in training.items()})
    longform.update(multigpu)
    longform.update({f"recipe_{k}": v for k, v in recipe.items()})
    # the gradient row's launches: its main path is the fine-tuning run
    counts["encoder_attention_grad"] = (
        training["finetune"]["encoder_attention_grad"])
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in longform.items()}
    # the device collective: its main path is the meshed decodes (rank 0's
    # launches of each mode on the tensor-parallel and 2-D paths)
    paths = ("tensor_parallel_rank0", "param_sharding_2d_rank0")
    for row in _MESH["rows"]:
        mode = row["name"][len("mesh_collective_"):]
        row["launches_by_path"] = {p: _MESH[p][mode] for p in paths}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on the meshed "
                                 f"paths {row['launches_by_path']}")
        rows.append(row)
    emit({"kernels": rows})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
