#!/usr/bin/env python3
"""Time the hand-written kernels of one checkout of the PyTorch port on the
GPU, at the main path's shapes.

    python3 scripts/torch_kernel_times.py [--root CHECKOUT] [--tag NAME]

``--root`` is the root of a checkout (default: this one); its
``distil_whisper_tpu_torch`` is imported and its kernels built there.  To
compare two commits on one card, unpack the other into a git-ignored
directory and run both in one command, in turns (A, B, B, A): each run is
its own process, because both packages share one name.

Times are CUDA events around 10 calls launched back to back, over 10, the
median of 3 such runs after warm-up (as ``chip_smoke.py``): log-mel on
16 x 30 s of audio at 128 mels, encoder attention at (16, 20, 1500, 64) bf16
contiguous and as [B, H, T, 64] views of [B, T, 1280] projections, the int8
MLP at the encoder's shape (x [24000, 1280] bf16, ffn 5120), int8 decode
attention at the cross shape (B 16, T 1536, 1500 live keys, per-head scales)
and the self-cache shape (T 448, per-token scales, per-row masks; device
time from a CUDA graph of 20 calls, since at tens of microseconds
back-to-back launches from Python time the host), the encoder-attention
backward at (2, 20, 1500, 64) and (4, 20, 1500, 64) (a CUDA graph too,
beside the host microseconds a call takes), and the PyTorch calls
beside each: SDPA (and its backward), the ``torch.stft`` composition, the
``torch._int_mm`` composition and bf16 ``F.linear``-gelu-``F.linear``, SDPA
on dequantized bf16 K/V.  Inputs come from one seed, so every checkout sees
the same numbers.  Prints one JSON line with the ptxas report of every
kernel and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# the timing helpers of this checkout's chip_smoke.py (cuda_ms, cuda_graph_ms,
# host_us), imported before --root goes first on the path, so that every
# checkout timed is timed by the same code
sys.path.insert(0, str(HERE))
from chip_smoke import cuda_graph_ms, cuda_ms, host_us  # noqa: E402


def attention_backward_times(gen):
    """The encoder-attention backward at (B, 20, 1500, 64), B 2 and 4, on
    [B, H, T, 64] views of [B, T, 1280] projections: the kernel from a
    saved forward, dq alone and dk/dv alone, the Function's backward
    through autograd and SDPA's backward, all in CUDA graphs; the host
    microseconds of a direct and of an autograd call."""
    import torch
    import torch.nn.functional as F
    from distil_whisper_tpu_torch.ops import encoder_attention as ea
    h, t, d = 20, 1500, 64
    out = {}
    for b in (2, 4):
        q, k, v, g = (torch.randn(b, t, h * d, generator=gen, device="cuda")
                      .to(torch.bfloat16).view(b, t, h, d).transpose(1, 2)
                      for _ in range(4))
        o, lse = ea._launch(q, k, v, t, with_lse=True)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def backward_of(forward):
            def setup():
                y = forward(*leaves)
                return lambda: torch.autograd.grad(y, leaves, g,
                                                   retain_graph=True)
            return setup

        ours = backward_of(lambda *x: ea.encoder_attention(*x, t))
        key = f"attention_bwd_b{b}"
        out[f"{key}_ms"] = cuda_graph_ms(
            lambda: ea.encoder_attention_grad(q, k, v, o, lse, g, t))
        out[f"{key}_dq_only_ms"] = cuda_graph_ms(
            lambda: ea.encoder_attention_grad(q, k, v, o, lse, g, t,
                                              (True, False, False)))
        out[f"{key}_dkdv_only_ms"] = cuda_graph_ms(
            lambda: ea.encoder_attention_grad(q, k, v, o, lse, g, t,
                                              (False, True, True)))
        out[f"{key}_autograd_ms"] = cuda_graph_ms(None, setup=ours)
        out[f"sdpa_bwd_b{b}_ms"] = cuda_graph_ms(
            None, setup=backward_of(F.scaled_dot_product_attention))
        out[f"{key}_host_us"] = host_us(
            lambda: ea.encoder_attention_grad(q, k, v, o, lse, g, t),
            rounds=15)
        out[f"{key}_autograd_host_us"] = host_us(ours(), rounds=15)
        del q, k, v, g, o, lse, leaves
        torch.cuda.empty_cache()
    return out


def int8_mlp_times(gen, cuda_ms):
    import torch
    import torch.nn.functional as F
    from distil_whisper_tpu_torch.ops import int8_mlp
    from distil_whisper_tpu_torch.ops.quant import dense_int8, quantize_dense
    m, d, f = 16 * 1500, 1280, 5120

    def rand(*shape, std):
        return std * torch.randn(*shape, generator=gen, device="cuda")

    fc1 = quantize_dense({"kernel": rand(d, f, std=0.03), "bias": rand(f, std=0.01)})
    fc2 = quantize_dense({"kernel": rand(f, d, std=0.03), "bias": rand(d, std=0.01)})
    x = rand(m, d, std=1.0).to(torch.bfloat16)
    w1 = (fc1["kernel_q"].float() * fc1["kernel_scale"]).T.to(torch.bfloat16).contiguous()
    w2 = (fc2["kernel_q"].float() * fc2["kernel_scale"]).T.to(torch.bfloat16).contiguous()
    b1, b2 = fc1["bias"].to(torch.bfloat16), fc2["bias"].to(torch.bfloat16)
    return {
        "int8_mlp_ms": cuda_ms(lambda: int8_mlp.fused_int8_mlp(fc1, fc2, x)),
        "int_mm_composition_ms": cuda_ms(
            lambda: dense_int8(fc2, F.gelu(dense_int8(fc1, x)))),
        "bf16_linear_gelu_linear_ms": cuda_ms(
            lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2))}


def int8_decode_attention_times(gen):
    import torch
    import torch.nn.functional as F
    from distil_whisper_tpu_torch.ops import int8_decode_attention as ida
    b, d, h = 16, 1280, 20
    out = {}
    for name, t, per_head in (("cross", 1536, True), ("self", 448, False)):
        q = torch.randn(b, d, generator=gen, device="cuda").to(torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (b, t, d), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        shape = (b, h) if per_head else (b, t)
        ks, vs = (0.01 * (0.5 + torch.rand(shape, generator=gen, device="cuda"))
                  for _ in range(2))
        live = (torch.full((1, 1), 1500, device="cuda") if per_head else
                torch.randint(1, t, (b, 1), generator=gen, device="cuda"))
        mask = torch.arange(t, device="cuda")[None] < live

        def dequant(xq, s):
            s = s.repeat_interleave(d // h, dim=1)[:, None] if per_head else s[..., None]
            return (xq.to(torch.bfloat16) * s.to(torch.bfloat16)).view(
                b, t, h, d // h).transpose(1, 2)

        kd, vd = dequant(kq, ks), dequant(vq, vs)
        qh, am = q.view(b, h, 1, d // h), mask.view(mask.shape[0], 1, 1, t)
        # device time: graph replay (host launches would dominate)
        out[f"int8_decode_attention_{name}_ms"] = cuda_graph_ms(
            lambda: ida.int8_decode_attention(q, kq, ks, vq, vs, h, mask))
        out[f"sdpa_dequantized_{name}_ms"] = cuda_graph_ms(
            lambda: F.scaled_dot_product_attention(qh, kd, vd, attn_mask=am))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(HERE))
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
    _build.build_all()
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
    del q, k, v, qm, km, vm
    out.update(attention_backward_times(gen))
    out.update(int8_mlp_times(gen, cuda_ms))
    out.update(int8_decode_attention_times(gen))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
