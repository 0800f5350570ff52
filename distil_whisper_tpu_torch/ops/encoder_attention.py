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

On the card the kernel runs inside a :class:`torch.autograd.Function`
whose backward recomputes the attention through the plain version under
autograd and returns its vector-Jacobian product, as the JAX package's
``custom_vjp`` does (``_bwd`` recomputes through its einsum reference).  The
backward launches no kernel; it holds the fp32 [B, H, T, T] scores and
probabilities of one layer while it runs (180 MB per batch row at
large-v3's 20 heads and T = 1500).  On the CPU autograd goes through the
plain version directly.

``fused_self_attention`` also takes a QAT w8a8 tree (``ops/qat.py``): it
fake-quantizes the q/k/v input and the out-projection's input, with the
kernel and its recompute backward in between.  Under tensor parallelism it
runs the kernel on this rank's heads ([B, H/tp, T, 64] views of the
[B, T, d/tp] projections) and its out-projection is row-parallel: partials
summed over the model group, an int8 or fake-quant row scale its max
(``parallel/tensor_parallel.py``).

Not ported: the TPU-only ``exp_impl`` and ``fused_qkv`` knobs (measured dead
on the TPU).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from ..parallel import tensor_parallel as tp
from .qat import ACT_FQ_KEY, fake_quant_acts
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
    # the row max only shifts the exponent: no gradient through it
    m = torch.amax(s, dim=-1, keepdim=True).detach()
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            t_real: int) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (checked here)."""
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
    # the .so launches on the CUDA runtime's current card
    with torch.cuda.device(q.device):
        err = _lib().dw_encoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t,
            t_real, scale_log2, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder attention kernel launch failed "
                           f"(cudaError {err})")
    _build.count_launch(encoder_attention)
    return out


def encoder_attention_vjp(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, t_real: int, g: torch.Tensor,
                          needs=(True, True, True)):
    """The kernel's backward: the vector-Jacobian product of
    :func:`encoder_attention_plain` at (q, k, v) with the output cotangent
    ``g``, recomputed under autograd (JAX's ``_bwd``).  Returns (dq, dk,
    dv), None where ``needs`` is false; each gradient comes back laid out as
    autograd lays out its input."""
    # a named range, so that a profile of a training step can sum the
    # recompute's device time
    with torch.profiler.record_function("encoder_attention_vjp"), \
            torch.enable_grad():
        qkv = [x.detach().requires_grad_(n) for x, n in zip((q, k, v), needs)]
        out = encoder_attention_plain(*qkv, t_real)
        grads = iter(torch.autograd.grad(
            out, [x for x in qkv if x.requires_grad], g))
    return tuple(next(grads) if x.requires_grad else None for x in qkv)


class _KernelAttention(torch.autograd.Function):
    """The kernel's forward, the plain version's recompute backward (JAX:
    ``_fwd``/``_bwd`` of the custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, t_real):
        ctx.save_for_backward(q, k, v)
        ctx.t_real = t_real
        return _launch(q, k, v, t_real)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*encoder_attention_vjp(q, k, v, ctx.t_real, g,
                                       ctx.needs_input_grad[:3]), None)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      t_real: int) -> torch.Tensor:
    """Whisper encoder self-attention.  q/k/v [B, H, T, 64]; keys >= t_real
    are masked.  Returns [B, H, T, 64] in q.dtype, laid out like q (a
    [B, H, T, D] view of a [B, T, H, D] buffer stays one).  Differentiable
    in q, k and v on both devices."""
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, t_real)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    return _KernelAttention.apply(q, k, v, t_real)


encoder_attention.launches = 0


def fused_self_attention(p_attn, x_ln: torch.Tensor, n_heads: int,
                         t_real: int, group=None) -> torch.Tensor:
    """Post-LN hidden states [B, T, d_model] -> self-attention block output
    [B, T, d_model] through :func:`encoder_attention`.

    q/k/v are projected as [B, T, H*D] (fp32 accumulation, cast, then the
    bias added in the working dtype, as ``dense``) and handed to the kernel
    as [B, H, T, D] views; the kernel writes its output in the same layout, so
    the out-projection reads [B, T, H*D] with no copy.  ``n_heads`` are this
    rank's under tensor parallelism over ``group``, and D comes from the
    projections' width."""
    b, t, _ = x_ln.shape
    quantized = "kernel_q" in p_attn["q"]
    x_ln = tp.copy_to(x_ln, group)
    act_fq = ACT_FQ_KEY in p_attn["q"]
    if act_fq:
        # QAT w8a8 tree (ops/qat.py): fake-quant the shared q/k/v input as
        # the int8 branch quantizes it (one scale a row), straight-through
        x_ln = fake_quant_acts(x_ln)
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
        w = y.shape[-1]
        return y.view(b, t, n_heads, w // n_heads).transpose(1, 2)  # [B,H,T,D]

    a = encoder_attention(proj(p_attn["q"]), proj(p_attn["k"]),
                          proj(p_attn["v"]), t_real)
    a = a.transpose(1, 2).reshape(b, t, -1)
    if quantized:
        # JAX scales the out-projection's input per (b, t) over (h, k): the
        # same elements as a per-row scale of the merged [B, T, d] row (over
        # the model group's heads under tensor parallelism)
        return dense_int8(p_attn["out"], a, group=group)
    if act_fq:
        # JAX fake-quants the out-projection's input per (b, t) over (h, k):
        # a per-row fake-quant of the merged [B, T, d] row, as above
        a = fake_quant_acts(a, group)
    y = tp.matmul(a, p_attn["out"]["kernel"], group)
    return y + p_attn["out"]["bias"].to(y.dtype)
