"""Whisper encoder self-attention: the CUDA kernels' wrappers (forward and
backward), their plain versions, and the fused self-attention block around
them.

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

Under autograd on the card the kernel runs inside a
:class:`torch.autograd.Function`: its forward also stores each row's
log-sum-exp (fp32 [B, H, T], base 2), and its backward is a second kernel
(``csrc/encoder_attention_bwd.cu``, :func:`encoder_attention_grad`) that
rebuilds the probabilities from it tile by tile, so no [B, H, T, T] array
reaches device memory: a dQ pass that also forms the rows' (lse2, delta)
pairs, then a dK/dV pass, each a persistent grid of min(SMs, work items)
blocks (:func:`bwd_geometry`).  It computes the gradient of the same
function as the JAX package's ``custom_vjp`` (``_bwd`` recomputes through
its einsum reference); :func:`encoder_attention_bwd_plain` is its
arithmetic in plain PyTorch, and :func:`encoder_attention_vjp`, the
recompute through the plain forward under autograd, stays as the bridge to
JAX's ``_bwd`` and a second reference on the card.
``encoder_attention_grad.launches`` counts backward kernel calls.  On the
CPU autograd goes through the plain version directly.

``fused_self_attention`` also takes a QAT w8a8 tree (``ops/qat.py``): it
fake-quantizes the q/k/v input and the out-projection's input, with the
kernel and its backward kernel in between.  Under tensor parallelism it
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


LOG2E = math.log2(math.e)
# rows of a backward work item; the (lse2, delta) scratch's rows are padded
# to this multiple
LD_ALIGN = 128


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, t_real: int,
                            return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch.  q/k/v [B, H, T, D].

    fp32 scores scaled by D^-0.5 after the product, keys >= t_real set to
    -inf, fp32 softmax statistics, the UNnormalised probabilities cast to the
    v dtype for p.v (fp32 accumulation), one division by the fp32 row sum.
    With ``return_lse`` also returns the fp32 [B, H, T] log-sum-exp of each
    row's scaled scores in base 2, as the forward kernel stores it for the
    backward.
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
    out = (pv / denom).to(q.dtype)
    if not return_lse:
        return out
    return out, ((m + torch.log(denom)) * LOG2E).squeeze(-1).detach()


def encoder_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, g: torch.Tensor,
                                t_real: int):
    """The backward kernel's arithmetic in plain PyTorch: (dq, dk, dv) in
    q.dtype for q/k/v, the forward's output ``out`` and its base-2
    log-sum-exp ``lse`` [B, H, T], and the output cotangent ``g``.

    P = exp2(S scale_log2 - lse) from the fp32 scores (keys >= t_real 0),
    delta = rowsum(g * out), dS = P (g V^T - delta) in fp32; P and dS cast
    to the q dtype before the products that take them (dV = P^T g,
    dK = dS^T Q D^-0.5, dQ = dS K D^-0.5), all accumulated in fp32.
    """
    d = q.shape[-1]
    scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None])
    if t_real < k.shape[2]:
        p[..., t_real:] = 0.0
    gf = g.float()
    delta = (gf * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), gf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("encoder_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_encoder_attention.argtypes = (
        [p, p, p, p, p, i, i, i, i, ctypes.c_float] + [ll] * 12 + [p])
    lib.dw_encoder_attention.restype = ctypes.c_int
    return lib


# the byte strides of T, H and B of q, k, v, out and g, as one argument
_BWD_STRIDES = ctypes.c_longlong * 15


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    lib = _build.load("encoder_attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dw_encoder_attention_bwd.argtypes = (
        [p] * 10 + [i] * 5 + [f, f, p, p])
    lib.dw_encoder_attention_bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_geometry(b: int, h: int, t: int, n_sm: int):
    """``(items, grid, rows)`` of the backward kernel's two persistent
    launches: the work items of each pass (a 128-row tile of queries or of
    keys, a head, a batch row), the blocks of each grid, min(``n_sm``,
    items), and the rows Tp of the (lse2, delta) scratch, T rounded up to a
    whole tile (the dQ pass writes every one of them, pad rows zero)."""
    tiles = -(-t // LD_ALIGN)
    items = tiles * h * b
    return items, min(items, n_sm), tiles * LD_ALIGN


def _tma_ok(x: torch.Tensor, strides) -> bool:
    return x.stride(3) == 1 and not x.data_ptr() % 16 and all(
        not s % 16 and 0 < s < 2 ** 40 for s in strides)


def _byte_strides(x: torch.Tensor):
    size = x.element_size()
    return (x.stride(2) * size, x.stride(1) * size, x.stride(0) * size)


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
    strides = _byte_strides(x)
    if not _tma_ok(x, strides):
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


def _check_shapes(q: torch.Tensor, t_real: int, operands) -> None:
    """The kernels' shared checks: head dim 64, 1 <= t_real <= T, and every
    operand a bf16 tensor of q's shape on q's card."""
    b, h, t, d = q.shape
    if d != 64:
        raise ValueError(f"encoder_attention kernel takes head dim 64, got {d}")
    if not 1 <= t_real <= t:
        raise ValueError(f"encoder_attention: t_real {t_real} not in [1, {t}]")
    for name, x in operands:
        if x.device != q.device:
            raise ValueError(f"encoder_attention: {name} on {x.device}")
        _check_operand(name, x, q.shape)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            t_real: int, with_lse: bool = False):
    """One launch of the kernel on CUDA tensors (checked here).  Returns the
    output, and with ``with_lse`` also the rows' base-2 log-sum-exp (fp32
    [B, H, T]) that the backward reads."""
    b, h, t, d = q.shape
    _check_shapes(q, t_real, (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, t, dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [s for x in (q, k, v, out) for s in _tma_geometry(x)[1]]
    scale_log2 = d ** -0.5 * LOG2E
    # the .so launches on the CUDA runtime's current card
    with torch.cuda.device(q.device):
        err = _lib().dw_encoder_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), b, h, t, t_real,
            scale_log2, *strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder attention kernel launch failed "
                           f"(cudaError {err})")
    _build.count_launch(encoder_attention)
    return (out, lse) if with_lse else out


def _grad_buffers(q: torch.Tensor, n: int):
    """``n`` gradient buffers of q's shape from one allocation: [B, H, T, D]
    views of consecutive [B, T, H, D] slices, the layout in which the
    projections' backward reads a gradient with no copy."""
    b, h, t, d = q.shape
    return torch.empty_strided(
        (n, b, h, t, d), (b * t * h * d, t * h * d, d, h * d, 1),
        dtype=q.dtype, device=q.device).unbind(0)


def _launch_bwd(q, k, v, out, lse, g, t_real: int, needs):
    """One backward call of the kernel on CUDA tensors (checked here):
    (dq, dk, dv), None where ``needs`` is false."""
    b, h, t, d = q.shape
    _check_shapes(q, t_real, (("q", q), ("k", k), ("v", v), ("out", out),
                              ("g", g)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"encoder_attention_grad: lse must be fp32 "
                         f"[{b}, {h}, {t}] contiguous on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if not _tma_ok(g, _byte_strides(g)):
        g = g.contiguous()          # e.g. the expanded cotangent of a sum
    strides = _BWD_STRIDES(
        *(s for x in (q, k, v, out, g) for s in _tma_geometry(x)[1]))
    want_dq, want_dkdv = needs[0], needs[1] or needs[2]
    grads = _grad_buffers(q, int(want_dq) + 2 * int(want_dkdv))
    # the kernel writes dq, dk and dv as views of contiguous [B, T, H, 64]
    # buffers, with strides it derives from H and T
    if grads and grads[0].stride() != (t * h * d, d, h * d, 1):
        raise ValueError(f"encoder_attention_grad: the kernel writes [B, T, "
                         f"H, 64] buffers, got strides {grads[0].stride()}")
    dq = grads[0] if want_dq else None
    dk, dv = grads[-2:] if want_dkdv else (None, None)
    _, grid, rows = bwd_geometry(b, h, t, _sm_count(q.device.index))
    ld = torch.empty(b * h * rows * 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _bwd_lib().dw_encoder_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), ld.data_ptr(),
            *(0 if x is None else x.data_ptr() for x in (dq, dk, dv)),
            b, h, t, t_real, grid, d ** -0.5 * LOG2E, d ** -0.5, strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder attention backward kernel launch failed "
                           f"(cudaError {err})")
    _build.count_launch(encoder_attention_grad)
    return (dq, dk if needs[1] else None, dv if needs[2] else None)


def encoder_attention_grad(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, g: torch.Tensor, t_real: int,
                           needs=(True, True, True)):
    """The encoder attention's backward: (dq, dk, dv) for q/k/v [B, H, T,
    64], the forward's output ``out`` and base-2 log-sum-exp ``lse`` [B, H,
    T], and the output cotangent ``g``; None where ``needs`` is false.

    Launches the backward kernel for CUDA tensors (bf16 only; the gradients
    come back as [B, H, T, 64] views of [B, T, H, 64] buffers) and runs
    :func:`encoder_attention_bwd_plain` for CPU tensors; anything else
    raises.  ``encoder_attention_grad.launches`` counts kernel calls."""
    if q.device.type == "cpu":
        grads = encoder_attention_bwd_plain(q, k, v, out, lse, g, t_real)
        return tuple(x if n else None for x, n in zip(grads, needs))
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention_grad: unsupported device "
                         f"{q.device}")
    # a named range, so that a profile of a training step can sum the
    # backward's device time
    with torch.profiler.record_function("encoder_attention_grad"):
        return _launch_bwd(q, k, v, out, lse, g, t_real, needs)


encoder_attention_grad.launches = 0


def encoder_attention_vjp(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, t_real: int, g: torch.Tensor,
                          needs=(True, True, True)):
    """The recompute route of the backward: the vector-Jacobian product of
    :func:`encoder_attention_plain` at (q, k, v) with the output cotangent
    ``g``, recomputed under autograd (JAX's ``_bwd``).  Returns (dq, dk,
    dv), None where ``needs`` is false; each gradient comes back laid out as
    autograd lays out its input.  A reference for the backward kernel; no
    path of the port calls it."""
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
    """The forward kernel, storing its rows' log-sum-exp, and the backward
    kernel (JAX: ``_fwd``/``_bwd`` of the custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, t_real):
        out, lse = _launch(q, k, v, t_real, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.t_real = t_real
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*encoder_attention_grad(q, k, v, out, lse, g, ctx.t_real,
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _KernelAttention.apply(q, k, v, t_real)
    return _launch(q, k, v, t_real)     # inference: no lse stored


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
