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
   [B, T, 1280] projections, and held on ragged shapes (T 1536 with 1500
   live keys; B 3, H 5, T 200, 77 live keys); the int8 MLP also at one
   window (1500 rows) and at the gate's 300 rows; decode attention also at
   T 32 and 8192 and with one mask row for the batch.  Each row carries
   its source's ptxas report.
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
6. Drives serving (``serving_path``) on the same weights: the continuous
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
   idle share and host syncs a block.
7. Drives speculative decoding (``speculative_path``) with large-v3 at full
   width as the teacher (32 + 32 layers, random bf16 weights from seed 0)
   and distil-large-v3's 2-layer decoder as its draft (seed 1, on the
   teacher's encoder states): the teacher's plain greedy and draft
   speculation through ``WhisperPipeline`` on the 16 windows (launches
   log-mel 1, encoder attention 32), then the decode loops alone: the
   draft (rounds, acceptance, the share of tokens equal to greedy's in
   bf16), ``synthetic_acceptance`` 0.8 against the prefix law and n-gram
   lookup with ``synthetic_period`` 16 (both synthetic tokens), and the
   sequential t = 0 rung with the draft on 4 long files against the plain
   rung; then the continuous engine serving large-v3 (16 requests, 64-token
   budgets, 16 lanes): plain, the draft under ``synthetic_acceptance`` 0.8
   and n-gram lookup with ``synthetic_period`` 16.
8. A small model on the card agrees with the CPU: fp32 tokens identical,
   bf16 fused encoder close; the same model with the int8 flags (fp32 tokens
   and prefill logits against the CPU; the bf16 int8 encoder, through both
   encoder kernels, close to the fp32 CPU int8 encoder); beam, sequential
   and word-timestamp results; fp32 draft and n-gram speculation on the
   card equal to the CPU greedy tokens, and the speculative sequential
   t = 0 rung equal to the plain CPU rung; the continuous engine (greedy,
   draft and n-gram lanes) and the micro-batch scheduler on the card equal
   to the CPU pipeline.
9. Prints the kernels line (launches from the int8 path's short-form run,
   and per path in ``launches_by_path``), the card's name and power limit,
   and last the result line ``{"ok": true, "device": {...}}``.

Any failed phase raises: the script then exits non-zero without a result
line.  It also exits non-zero without a GPU, and outside the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
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


def cuda_graph_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Device time of one call of ``fn`` without the host's launch work:
    ``reps`` calls captured in one CUDA graph, the graph replayed between
    CUDA events, over ``reps``; the median of ``rounds`` replays, after
    warm-up.  For kernels of tens of microseconds, where back-to-back
    launches from Python would time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    del graph
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
    three [B, T, 1280] projections; plus ragged cases against the plain
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
        "shape": [b, h, t, d], "ptxas": ptxas_report("encoder_attention")}
    del q, k, v, qm, km, vm
    torch.cuda.empty_cache()
    return row


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
                 "int8_mlp": 0, "int8_decode_attention": 0}

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
    # the decode loop alone, on the main path's encoder states
    cross = W.cross_kv(params["decoder"], pcfg, bf16["enc"])
    prompt = torch.tensor([tok.prompt_ids(language="en")] * 16, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=128,
                                         no_speech_token_id=tok.no_speech)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = beam_search(params["decoder"], pcfg, cross, prompt, opts,
                      num_beams=k, dtype=dtype)
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
    launches["int8_beam"] = read_counts()
    # the encoder's 32 layers, and the decoder's prefill: 80 rows x 4 prompt
    # tokens pass the kernel's 256-row gate (one launch a decoder layer)
    expected = {**bf16_path,
                "int8_mlp": cfg.encoder_layers + cfg.decoder_layers}
    if launches["int8_beam"] != expected:
        raise AssertionError(f"int8 beam launches {launches['int8_beam']}")
    if beam_run(qpipe) != qfirst:
        raise AssertionError("two int8 beam runs gave other tokens")
    del qpipe
    torch.cuda.empty_cache()
    emit({"phase": "longform_path", "model": "distil-large-v3",
          "dtype": "bf16", "launches": launches, "int8_beam_first_call_s":
          qbeam_s})
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


def _device_ms(fn):
    """(wall ms, summed device kernel ms) of ``fn`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            busy += float(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
    return wall, busy / 1e3


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


def engine_idle_share(tr, mels, tok, blocks: int = 4):
    """The step loop alone, greedy and sampling blocks: 16 lanes admitted at
    once (96-token budgets; sampled lanes at temperature 0.8, top_k 8),
    ``blocks`` blocks (step + unpack) timed without the profiler, then
    under it for the device time; the idle share is 1 - device / the
    unprofiled wall (as scripts/torch_profile_main_path.py).  Also the
    Python frames of every synchronising CUDA call in one block and in its
    ``unpack`` (``torch.cuda.set_sync_debug_mode``)."""
    import traceback
    import warnings
    import torch
    eng = tr.engine
    prompt = tok.prompt_ids(language="en")
    n = eng.lanes

    def syncs(fn):
        where = []

        def record(message, category, filename, lineno, *a, **k):
            if "synchronizing CUDA operation" in str(message):
                where.append([f"{Path(f.filename).name}:{f.lineno}"
                              for f in traceback.extract_stack()[-6:-1]])

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode(1)
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, where

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
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
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
        torch.cuda.empty_cache()
    return engines, serving_launches


def phase_speculative_path(tok, bf16):
    """Speculative decoding at full width: large-v3 (32 encoder and 32
    decoder layers) is the teacher, random bf16 weights from seed 0;
    distil-large-v3's 2-layer decoder (seed 1) drafts for it on the
    teacher's encoder states.  On the main path's 16 windows, greedy, 128
    new tokens, gamma 5: the teacher's plain greedy, draft speculation
    through ``WhisperPipeline`` (launches counted from 0 around its first
    call), then the decode loops on the same encoder states: draft,
    ``synthetic_acceptance`` 0.8 and n-gram lookup with
    ``synthetic_period`` 16 (both synthetic: their tokens are the oracle's,
    not the model's); last the sequential t = 0 rung with the draft on 4
    long files, against the plain t = 0 rung."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (
        GenerationOptions, SequentialOptions, SequentialTranscriber, generate)
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline

    cfg, dcfg = PRESETS["large-v3"], PRESETS["distil-large-v3"]
    dtype, gamma, max_new, n = torch.bfloat16, 5, 128, 16
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
                 "int8_mlp": 0, "int8_decode_attention": 0}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. the entry point: plain greedy and draft speculation ------------
    plain(clips, language="en")                                 # warm-up
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
    t_cross = W.cross_kv(teacher["decoder"], pcfg, enc)
    d_cross = W.cross_kv(draft["decoder"], dpcfg, enc)
    prompt = torch.tensor([tok.prompt_ids(language="en")] * n, device="cuda")
    opts = GenerationOptions.from_config(pcfg, max_new_tokens=max_new,
                                         no_speech_token_id=tok.no_speech)
    p = prompt.shape[1]
    greedy, gen_s = timed(lambda: generate(teacher["decoder"], pcfg, t_cross,
                                           prompt, opts, dtype=dtype))
    steps = int(greedy.seq_len.max()) - p
    report = {"greedy": {"ms_per_step": gen_s * 1e3 / max(steps, 1),
                         "decode_s": gen_s, "steps": steps,
                         "audio_s_per_s": audio_s / (encode_s + gen_s)}}

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
        report[name] = row
        return row

    out, sec = timed(lambda: S.speculative_generate_batched(
        teacher["decoder"], pcfg, draft["decoder"], dpcfg, t_cross, d_cross,
        prompt, opts, gamma=gamma, dtype=dtype))
    loop_report("draft", out, sec, False)
    alpha = 0.8
    out, sec = timed(lambda: S.speculative_generate_batched(
        teacher["decoder"], pcfg, draft["decoder"], dpcfg, t_cross, d_cross,
        prompt, opts, gamma=gamma, dtype=dtype, synthetic_acceptance=alpha))
    row = loop_report("synthetic_acceptance_0.8", out, sec, True)
    row["prefix_law_accepted_per_round"] = (alpha * (1 - alpha ** gamma)
                                            / (1 - alpha))
    row["prefix_law_tokens_per_round"] = row[
        "prefix_law_accepted_per_round"] + 1
    out, sec = timed(lambda: S.ngram_speculative_generate_batched(
        teacher["decoder"], pcfg, t_cross, prompt, opts, gamma=gamma,
        max_ngram=3, dtype=dtype, synthetic_period=16))
    loop_report("ngram_synthetic_period_16", out, sec, True)
    del t_cross, d_cross, enc

    # -- 3. the sequential t = 0 rung with the draft, 4 long files ---------
    files = [a[:int(sec * 16000)] for a, sec in
             zip(synthetic_audio(4, 75.0, seed=7), (40.0, 52.0, 63.0, 75.0))]
    reset_counts()
    feats = [compute_mel(a, pcfg, pad_to_chunk=False, device="cuda")[0]
             for a in files]
    torch.cuda.synchronize()
    feature_mels = read_counts()["log_mel"]
    sopts = SequentialOptions(temperatures=(0.0,))
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
          "generated_tokens": int((golden.seq_len - len(prompt[0])).sum()),
          **{name: {k: getattr(o, k).tolist()
                    for k in ("rounds", "drafted", "accepted")}
             for name, o in outs.items()},
          "self_draft_accepts_every_proposal": self_draft_all,
          "fp32_sequential_t0_segments_identical": spec_gpu == plain_cpu,
          "sequential_segments": sum(len(r) for r in plain_cpu),
          "sequential_spec_stats": spec_tr.spec_stats})
    if not (all(same.values()) and self_draft_all and spec_gpu == plain_cpu
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

    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        tok = synthetic_tokenizer(Path(tmp))
    with torch.no_grad():
        bf16 = phase_main_path(tok)
        counts = phase_int8_main_path(tok, bf16)
        longform = phase_longform_path(tok, bf16)
        longform.update(phase_serving_path(tok, bf16))
        longform.update(phase_speculative_path(tok, bf16))
        del bf16
        torch.cuda.empty_cache()
        phase_small_reference(tok)
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["launches_by_path"] = {path: c[row["name"]]
                                   for path, c in longform.items()}
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
