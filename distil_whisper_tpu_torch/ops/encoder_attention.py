"""Whisper encoder self-attention: the CUDA kernel's wrapper, its plain
version, and the fused self-attention block around it.

The kernel (``csrc/encoder_attention.cu``) replaces the Pallas TPU kernel of
``distil_whisper_tpu/ops/encoder_attention.py``: non-causal attention that
never writes the [B, H, T, T] logits or probabilities to device memory.  It
streams keys with an online softmax (the TPU kernel held a whole score row in
VMEM; a block's shared memory cannot), so it computes the same function with
different rounding.  It loads q/k/v by TMA through 4-D tensor maps whose
geometry :func:`_tma_geometry` computes from the caller's strides, so it
takes the real length T (TMA zero-fills the ragged edge) and [B, H, T, 64]
views of [B, T, H*64] projections: ``encode`` needs no pad or copy.

:func:`encoder_attention` launches the kernel for CUDA tensors (bf16 only)
and runs :func:`encoder_attention_plain` for CPU tensors; anything else
raises.  ``encoder_attention.launches`` counts kernel launches.

Not ported: the TPU-only ``exp_impl`` and ``fused_qkv`` knobs (measured dead
on the TPU); the QAT branch of ``fused_self_attention`` and the backward
(einsum recompute) come with training.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .quant import dense_int8, quantize_acts


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, t_real: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  q/k/v [B, H, T, D].

    fp32 scores scaled by D^-0.5 after the product, keys >= t_real set to
    -inf, fp32 softmax statistics, the UNnormalised probabilities cast to the
    v dtype for p.v (fp32 accumulation), one division by the fp32 row sum.
    """
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if t_real < k.shape[2]:
        s[..., t_real:] = float("-inf")
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("encoder_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_encoder_attention.argtypes = (
        [p, p, p, p, i, i, i, i, ctypes.c_float] + [ll] * 12 + [p])
    lib.dw_encoder_attention.restype = ctypes.c_int
    return lib


def _tma_geometry(x: torch.Tensor):
    """``(dims, byte_strides)`` of the 4-D tensor map through which the
    kernel loads ``x`` [B, H, T, D]: dims ``(D, T, H, B)``, innermost first,
    and the byte strides of T, H and B.  Raises ``ValueError`` on a layout
    TMA cannot take (D not unit-stride, a base or a stride that is not a
    multiple of 16 bytes)."""
    if x.ndim != 4:
        raise ValueError(f"encoder_attention: want [B, H, T, D], got "
                         f"{tuple(x.shape)}")
    b, h, t, d = x.shape
    size = x.element_size()
    strides = (x.stride(2) * size, x.stride(1) * size, x.stride(0) * size)
    if x.stride(3) != 1 or x.data_ptr() % 16 or any(
            s % 16 or not 0 < s < 2 ** 40 for s in strides):
        raise ValueError("encoder_attention: TMA needs unit stride along D, "
                         "a 16-byte aligned base and T/H/B strides that are "
                         f"multiples of 16 bytes; got strides {x.stride()} "
                         f"(elements), base {x.data_ptr():#x}")
    return (d, t, h, b), strides


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"encoder_attention kernel takes bf16, got {name} "
                         f"{x.dtype} (fp32 runs use the einsum path)")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"encoder_attention: {name} shape {tuple(x.shape)} "
                         f"!= {tuple(shape)}")


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      t_real: int) -> torch.Tensor:
    """Whisper encoder self-attention.  q/k/v [B, H, T, 64]; keys >= t_real
    are masked.  Returns [B, H, T, 64] in q.dtype, laid out like q (a
    [B, H, T, D] view of a [B, T, H, D] buffer stays one)."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, t_real)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    b, h, t, d = q.shape
    if d != 64:
        raise ValueError(f"encoder_attention kernel takes head dim 64, got {d}")
    if not 1 <= t_real <= t:
        raise ValueError(f"encoder_attention: t_real {t_real} not in [1, {t}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"encoder_attention: {name} on {x.device}")
        _check_operand(name, x, q.shape)
    out = torch.empty_like(q)
    strides = [s for x in (q, k, v, out) for s in _tma_geometry(x)[1]]
    scale_log2 = d ** -0.5 * math.log2(math.e)
    err = _lib().dw_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t,
        t_real, scale_log2, *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder attention kernel launch failed "
                           f"(cudaError {err})")
    _build.count_launch(encoder_attention)
    return out


encoder_attention.launches = 0


def fused_self_attention(p_attn, x_ln: torch.Tensor, n_heads: int,
                         t_real: int) -> torch.Tensor:
    """Post-LN hidden states [B, T, d_model] -> self-attention block output
    [B, T, d_model] through :func:`encoder_attention`.

    q/k/v are projected as [B, T, d_model] (fp32 accumulation, cast, then the
    bias added in the working dtype, as ``dense``) and handed to the kernel
    as [B, H, T, D] views; the kernel writes its output in the same layout, so
    the out-projection reads [B, T, d_model] with no copy."""
    b, t, dm = x_ln.shape
    d = dm // n_heads
    quantized = "kernel_q" in p_attn["q"]
    if quantized:
        # W8A8 (ops/quant.py): one activation quantization shared by q/k/v
        xq, xs = quantize_acts(x_ln)

    def proj(p):
        if quantized:
            y = dense_int8(p, x_ln, xq, xs)
        else:
            y = torch.matmul(x_ln, p["kernel"].to(x_ln.dtype))
            if "bias" in p:
                y = y + p["bias"].to(y.dtype)
        return y.view(b, t, n_heads, d).transpose(1, 2)          # [B, H, T, D]

    a = encoder_attention(proj(p_attn["q"]), proj(p_attn["k"]),
                          proj(p_attn["v"]), t_real)
    a = a.transpose(1, 2).reshape(b, t, dm)
    if quantized:
        # JAX scales the out-projection's input per (b, t) over (h, k): the
        # same elements as a per-row scale of the merged [B, T, d] row
        return dense_int8(p_attn["out"], a)
    y = torch.matmul(a, p_attn["out"]["kernel"].to(a.dtype))
    return y + p_attn["out"]["bias"].to(y.dtype)
