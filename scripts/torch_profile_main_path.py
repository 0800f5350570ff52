#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on one GPU.

    python3 scripts/torch_profile_main_path.py [--batch 16] [--max-new 128]
                                               [--trace-dir profile_traces]
                                               [--int8 | --speculative]
                                               [--beams K]

distil-large-v3 at full width, random weights from a seed, bf16, a batch of
30 s synthetic windows, greedy with a fixed token budget.  ``--int8`` sets
all five ``quantize_*`` flags (W8A8 encoder and decoder, int8 self-KV and
cross K/V, int8 logits), quantizing the weights as ``WhisperPipeline``
does.  ``--speculative`` profiles speculative decoding instead: large-v3
(32 encoder and 32 decoder layers, seed 0) is the teacher and
distil-large-v3's 2-layer decoder (seed 1) its draft, on the teacher's
encoder states, gamma 5.  The stages of ``WhisperPipeline`` run one by
one, each warm and then once under ``torch.profiler`` (CPU + CUDA):

    mel       compute_mel (the fused CUDA log-mel kernel)
    encode    models.whisper.encode (the CUDA encoder-attention kernel; with
              --int8 also the int8 MLP kernel)
    cross_kv  models.whisper.cross_kv (with --speculative: the teacher's and
              the draft's), alone: the decode loops project their own
    generate  generation.generate on the encoder states (the prefill with
              its cross K/V and the greedy step blocks, CUDA graphs)
    speculate_draft, speculate_synthetic_0.8, speculate_ngram_period_16
              (--speculative only) generation.speculative's loops on the
              encoder states, CUDA graphs: the draft, the draft under
              synthetic_acceptance 0.8 and n-gram lookup under
              synthetic_period 16 (synthetic tokens)
    speculate_synthetic_0.8_eager
              (--speculative only) the same loop as the plain version,
              speculate_eager, a read of the device every round
    beam      (--beams K only) generation.beam_search with K beams on the
              encoder states (the prefill and the step blocks, CUDA graphs)
    beam_eager
              (--beams K only) the same search as the plain version,
              beam_search_eager, a read of the device every step

The decode stages replay the programs of one graph owner, captured by
their warm call, so that a profiled call does not capture.

For each stage it prints one JSON line: host wall time (ends in a
synchronize), the summed device time of its kernels, the device's idle share
(1 - device / wall), and the kernels taking the most device time.  The
Chrome traces go to ``--trace-dir``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def profile_stage(name, fn, out_dir: Path, top: int = 12):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / f"{name}.json"))
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    kernels.sort(key=_device_us, reverse=True)
    return {"stage": name, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "n_kernel_launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:90], "ms": _device_us(e) / 1e3,
                     "count": e.count} for e in kernels[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--trace-dir", default=str(ROOT / "profile_traces"))
    ap.add_argument("--int8", action="store_true",
                    help="the int8 lane: all five quantize_* flags")
    ap.add_argument("--speculative", action="store_true",
                    help="large-v3 as the teacher, distil-large-v3's "
                         "decoder as the draft: adds the speculative loops")
    ap.add_argument("--beams", type=int, default=0,
                    help="adds beam search with this many beams, on graphs "
                         "and as the plain loop")
    args = ap.parse_args()
    if args.int8 and args.speculative:
        ap.error("--int8 and --speculative profile different models")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                      beam_search, generate)
    from distil_whisper_tpu_torch.generation.beam import beam_search_eager
    from distil_whisper_tpu_torch.generation.graphs import GraphOwner
    from distil_whisper_tpu_torch.generation import speculative as S
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models import whisper as W
    from distil_whisper_tpu_torch.ops import _build
    from distil_whisper_tpu_torch.ops.quant import maybe_quantize_encoder

    _build.build_all()
    out_dir = Path(args.trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dtype = torch.bfloat16
    model = "large-v3" if args.speculative else "distil-large-v3"
    cfg = PRESETS[model].replace(fast_bf16_attention=True,
                                 use_flash_encoder=True)
    params = init_params(cfg, seed=0, device="cuda", dtype=dtype)
    if args.speculative:
        dcfg = PRESETS["distil-large-v3"].replace(fast_bf16_attention=True,
                                                  use_flash_encoder=True)
        draft = init_params(dcfg, seed=1, device="cuda", dtype=dtype)
    if args.int8:
        cfg = cfg.replace(quantize_encoder=True, quantize_decoder=True,
                          quantize_lm_head=True, quantize_cross_kv=True,
                          quantize_self_kv=True)
        params = maybe_quantize_encoder(params, cfg)
    rng = np.random.default_rng(1)
    wavs = (0.1 * rng.standard_normal((args.batch, cfg.n_samples))
            ).astype(np.float32)
    # v3 prompt: <|startoftranscript|><|en|><|transcribe|><|notimestamps|>
    prompt = torch.tensor([[50258, 50259, 50360, 50364]] * args.batch,
                          device="cuda")
    opts = GenerationOptions.from_config(cfg, max_new_tokens=args.max_new,
                                         no_speech_token_id=50363)
    state = {}
    owner = GraphOwner("profile")

    def mel():
        state["mel"] = compute_mel(wavs, cfg, device="cuda").to(dtype)

    def encode():
        state["enc"] = W.encode(params["encoder"], cfg, state["mel"],
                                dtype=dtype)

    def cross():
        state["cross"] = W.cross_kv(params["decoder"], cfg, state["enc"])
        if args.speculative:
            state["d_cross"] = W.cross_kv(draft["decoder"], dcfg,
                                          state["enc"])

    def gen():
        state["out"] = generate(params["decoder"], cfg, state["enc"], prompt,
                                opts, dtype=dtype, graphs=owner)

    def speculate(alpha):
        def run():
            state["out"] = S.speculative_generate_batched(
                params["decoder"], cfg, draft["decoder"], dcfg, state["enc"],
                state["enc"], prompt, opts, gamma=5, dtype=dtype,
                synthetic_acceptance=alpha, graphs=owner)
        return run

    def ngram():
        state["out"] = S.ngram_speculative_generate_batched(
            params["decoder"], cfg, state["enc"], prompt, opts, gamma=5,
            max_ngram=3, dtype=dtype, synthetic_period=16, graphs=owner)

    def eager():
        state["out"] = S.speculate_eager(
            params["decoder"], cfg, state["enc"], prompt, opts, gamma=5,
            draft=(draft["decoder"], dcfg, state["enc"]), dtype=dtype,
            synthetic_acceptance=0.8)

    def beams(plain):
        def run():
            kw = dict(num_beams=args.beams, dtype=dtype)
            state["out"] = (beam_search_eager(
                params["decoder"], cfg, state["enc"], prompt, opts, **kw)
                if plain else beam_search(params["decoder"], cfg,
                                          state["enc"], prompt, opts,
                                          graphs=owner, **kw))
        return run

    stages = [("mel", mel), ("encode", encode), ("cross_kv", cross),
              ("generate", gen)]
    if args.beams:
        stages += [("beam", beams(False)), ("beam_eager", beams(True))]
    if args.speculative:
        stages += [("speculate_draft", speculate(None)),
                   ("speculate_synthetic_0.8", speculate(0.8)),
                   ("speculate_ngram_period_16", ngram),
                   ("speculate_synthetic_0.8_eager", eager)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "model": model,
                      "batch": args.batch, "int8": args.int8,
                      "speculative": args.speculative,
                      "beams": args.beams,
                      "max_new_tokens": args.max_new,
                      "power_limit": _power_limit()}), flush=True)
    with torch.no_grad():
        for name, fn in stages:
            row = profile_stage(name, fn, out_dir)
            if name == "generate":
                steps = int(state["out"].seq_len.max()) - prompt.shape[1]
                row["decode_steps"] = steps
                row["wall_ms_per_step"] = row["wall_ms"] / max(steps, 1)
            elif name.startswith("beam"):
                # the loop's steps, from the beam program's device cursor
                (prog,) = [v for k, v in owner.entries.items()
                           if k[0] == "beam"]
                steps = int(prog.state["cur"][0]) - prompt.shape[1]
                row["decode_steps"] = steps
                row["wall_ms_per_step"] = row["wall_ms"] / steps
                row["device_ms_per_step"] = row["device_ms"] / steps
            elif name.startswith("speculate"):
                out = state["out"]
                rounds = int(out.rounds.max())
                tokens = int(out.seq_len.max()) - prompt.shape[1]
                row.update(rounds=rounds, tokens=tokens,
                           accepted=int(out.accepted.sum()),
                           wall_ms_per_round=row["wall_ms"] / max(rounds, 1),
                           wall_ms_per_token=row["wall_ms"] / max(tokens, 1))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
