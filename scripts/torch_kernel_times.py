#!/usr/bin/env python3
"""Time the log-mel and encoder-attention kernels of one checkout of the
PyTorch port on the GPU, at the main path's shapes.

    python3 scripts/torch_kernel_times.py [--root CHECKOUT] [--tag NAME]

``--root`` is the root of a checkout (default: this one); its
``distil_whisper_tpu_torch`` is imported and its kernels built there.  To
compare two commits on one card, unpack the other into a git-ignored
directory and run both in one command, in turns (A, B, B, A): each run is
its own process, because both packages share one name.

Times are CUDA events around 10 calls launched back to back, over 10, the
median of 3 such runs after warm-up (as ``chip_smoke.py``): log-mel on
16 x 30 s of audio at 128 mels, encoder attention at (16, 20, 1500, 64) bf16
contiguous and as [B, H, T, 64] views of [B, T, 1280] projections, and the
PyTorch calls that compute the same functions.  Prints one JSON line with
the ptxas report of both kernels and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, reps: int = 10, warmup: int = 2, rounds: int = 3) -> float:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_kernel_times.py: no CUDA device", file=sys.stderr)
        return 1
    from distil_whisper_tpu_torch.audio import mel_kernel
    from distil_whisper_tpu_torch.audio.mel import whisper_mel_filters
    from distil_whisper_tpu_torch.ops import _build
    from distil_whisper_tpu_torch.ops import encoder_attention as ea
    _build.build_all(["mel", "encoder_attention"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "root": args.root,
           "ptxas": {name: [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, log in _build.build_logs.items()}}

    audio = 0.2 * torch.randn(16, 480000, generator=gen, device="cuda")
    window = torch.hann_window(400, device="cuda")
    filters = torch.from_numpy(whisper_mel_filters(128)).cuda()

    def stft_mel():
        spec = torch.stft(audio, 400, 160, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        return torch.log10(torch.clamp(filters.T @ (spec[..., :-1].abs() ** 2),
                                       min=1e-10))

    out["log_mel_ms"] = cuda_ms(lambda: mel_kernel.log10_mel_fused(audio, 128))
    out["stft_mel_ms"] = cuda_ms(stft_mel)
    del audio

    b, h, t, d = 16, 20, 1500, 64
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qm, km, vm = (torch.randn(b, t, h * d, generator=gen, device="cuda")
                  .to(torch.bfloat16).view(b, t, h, d).transpose(1, 2)
                  for _ in range(3))
    out["attention_ms"] = cuda_ms(lambda: ea.encoder_attention(q, k, v, t))
    out["attention_main_layout_ms"] = cuda_ms(
        lambda: ea.encoder_attention(qm, km, vm, t))
    out["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    out["sdpa_main_layout_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qm, km, vm))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
