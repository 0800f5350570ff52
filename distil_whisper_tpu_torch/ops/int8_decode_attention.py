"""Single-token attention against int8 merged-layout K/V: the CUDA kernel's
wrapper and its plain version.

The kernel (``csrc/int8_decode_attention.cu``) replaces the Pallas TPU kernel
of ``distil_whisper_tpu/ops/int8_decode_attention.py`` (``_kernel``).  As in
the JAX package it is not wired into ``decode()``: the decoder dequantizes
its int8 caches and runs ``ops.attention`` (whether to wire it in waits for
a measurement of the decode step).

The function, per batch row b and head h (hd = D / H):

    q8, qs  = int8 of q[b, h] (absmax, scale floor 1e-12)
    s[t]    = (q8 . K[b, t, h]) [int32] * (qs * k_head * hd^-0.5) * k_row[t]
              + (0 if mask[t] else -1e30)                           (fp32)
    p       = softmax(s) * v_row                                    (fp32)
    p8, ps  = round(p / ps), ps = max(max_t p, 1e-12) / 127 (no clip)
    out     = (p8 . V[b, :, h]) [int32] * (ps * v_head)

K/V are [B, T, D] int8 with T % 32 == 0.  The scales come in the two serving
formats, told apart by shape: per head [B, H] (cross K/V: ``k_head`` is the
scale, ``k_row`` 1) or per token [B, T] (the self cache: ``k_head`` 1).  The
block-diagonal q operand and the head-selector matrix of the TPU kernel are
layout devices of the TPU's matrix unit and are not carried over.

On the card each (b, h) is a thread-block cluster of CTAs that split T
(:func:`_cluster_split` chooses the split); they load their K/V slices by
TMA and reduce the softmax statistics and the p.V partials through
distributed shared memory.

:func:`int8_decode_attention` launches the kernel for CUDA tensors (bf16 q,
head dim 64) and runs :func:`int8_decode_attention_plain` for CPU tensors;
anything else raises.  ``int8_decode_attention.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .quant import over_127, symmetric_int8


def _scale_format(scale: torch.Tensor, b: int, t: int, n_heads: int):
    """(per_head, scale) of a [B, H] or [B, T] scale; raises otherwise."""
    if tuple(scale.shape) == (b, n_heads):
        return True, scale.float()
    if tuple(scale.shape) == (b, t):
        return False, scale.float()
    raise ValueError(f"scale shape {tuple(scale.shape)} matches neither "
                     f"per-head [B, {n_heads}] nor per-token [B, {t}]")


def _check(q, kq, vq, n_heads, mask):
    b, t, d = kq.shape
    if t % 32:
        raise ValueError(f"key length {t} must be a multiple of 32: pad the "
                         "K/V buffers and mask the tail rows")
    if t == n_heads:
        raise ValueError(f"key length == n_heads ({t}): the per-head [B, H] "
                         "and per-token [B, T] scale formats are ambiguous")
    if tuple(q.shape) != (b, d) or tuple(vq.shape) != (b, t, d) \
            or d % n_heads:
        raise ValueError(f"int8_decode_attention: q {tuple(q.shape)}, K "
                         f"{tuple(kq.shape)}, V {tuple(vq.shape)}, "
                         f"{n_heads} heads")
    if mask is not None and (mask.dim() != 2 or mask.shape[1] != t
                             or mask.shape[0] not in (1, b)):
        raise ValueError(f"mask shape {tuple(mask.shape)} is not [B or 1, "
                         f"{t}]")


def int8_decode_attention_plain(q: torch.Tensor, kq: torch.Tensor,
                                k_scale: torch.Tensor, vq: torch.Tensor,
                                v_scale: torch.Tensor, n_heads: int,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, for any head dim: integer
    products exact (int64 sums), fp32 elsewhere."""
    _check(q, kq, vq, n_heads, mask)
    b, t, d = kq.shape
    hd = d // n_heads
    k_per_head, ks = _scale_format(k_scale, b, t, n_heads)
    v_per_head, vs = _scale_format(v_scale, b, t, n_heads)
    ones_h = torch.ones((b, n_heads), device=q.device)
    ones_t = torch.ones((b, 1, t), device=q.device)
    k_head, k_row = (ks, ones_t) if k_per_head else (ones_h, ks[:, None])
    v_head, v_row = (vs, ones_t) if v_per_head else (ones_h, vs[:, None])

    qh = q.float().view(b, n_heads, hd)
    q8, qs = symmetric_int8(qh, qh.abs().amax(dim=-1, keepdim=True))
    q8, qs = q8.long(), qs[..., 0]                                  # qs [B, H]
    kh = kq.view(b, t, n_heads, hd).long()
    s32 = (kh * q8[:, None]).sum(dim=-1).transpose(1, 2)           # [B, H, T]
    sfac = (qs * k_head * (hd ** -0.5))[..., None]
    bias = torch.zeros((1, 1, t), device=q.device)
    if mask is not None:
        bias = torch.where(mask != 0, 0.0, -1e30).float()[:, None, :]
    s = s32.float() * sfac * k_row + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)) * v_row
    ps = over_127(torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-12))
    p8 = torch.round(p / ps).long()                                 # [B, H, T]
    vh = vq.view(b, t, n_heads, hd).long()
    o32 = (p8.transpose(1, 2)[..., None] * vh).sum(dim=1)          # [B, H, hd]
    o = o32.float() * (ps * v_head[..., None])
    return o.reshape(b, d).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("int8_decode_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_int8_decode_attention.argtypes = [p, p, p, p, p, i, i, p, ll, p,
                                             i, i, i, ctypes.c_float, i, i,
                                             i, p]
    lib.dw_int8_decode_attention.restype = ctypes.c_int
    return lib


def _cluster_split(t: int):
    """``(cl, slice, box_rows)``: the kernel's cluster of ``cl`` CTAs a
    (batch row, head), CTA r taking key rows [r * slice, min((r + 1) *
    slice, T)), loaded in TMA boxes of ``box_rows`` <= 256 rows.  ``slice``
    is a multiple of ``box_rows``, and ``box_rows`` of 8 (whole warps of
    four threads a row); the last CTAs may get fewer rows, or none.  cl
    grows with T: 2 below 1024 keys, 4 below 4096, else 8 (the fastest of
    2, 4 and 8 at T 448 and 1536 on the H100)."""
    cl = 2 if t < 1024 else 4 if t < 4096 else 8
    rows = -(-t // cl)
    boxes = -(-rows // 256)
    slice_ = -(-rows // (8 * boxes)) * 8 * boxes
    return cl, slice_, slice_ // boxes


def int8_decode_attention(q: torch.Tensor, kq: torch.Tensor,
                          k_scale: torch.Tensor, vq: torch.Tensor,
                          v_scale: torch.Tensor, n_heads: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q [B, D], kq/vq [B, T, D] int8 (T % 32 == 0), scales [B, H] or
    [B, T] fp32, mask [B or 1, T] (nonzero = attend) or None -> [B, D] in
    q.dtype."""
    if q.device.type == "cpu":
        return int8_decode_attention_plain(q, kq, k_scale, vq, v_scale,
                                           n_heads, mask)
    if q.device.type != "cuda":
        raise ValueError(f"int8_decode_attention: unsupported device "
                         f"{q.device}")
    _check(q, kq, vq, n_heads, mask)
    b, t, d = kq.shape
    if d // n_heads != 64:
        raise ValueError(f"int8_decode_attention kernel takes head dim 64, "
                         f"got {d // n_heads}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"int8_decode_attention kernel takes bf16 q, got "
                         f"{q.dtype}")
    if t > 8192:
        raise ValueError(f"int8_decode_attention kernel takes T <= 8192, "
                         f"got {t}")
    k_per_head, ks = _scale_format(k_scale, b, t, n_heads)
    v_per_head, vs = _scale_format(v_scale, b, t, n_heads)
    ks, vs = ks.contiguous(), vs.contiguous()
    for name, x in (("q", q), ("kq", kq), ("vq", vq), ("k_scale", ks),
                    ("v_scale", vs)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"int8_decode_attention: {name} must be a "
                             f"contiguous, 16-byte aligned tensor on {q.device}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError("int8_decode_attention: K/V must be int8")
    mask_ptr, mask_bstride = None, 0
    if mask is not None:
        mask = (mask != 0).to(torch.uint8).contiguous()
        mask_ptr = mask.data_ptr()
        mask_bstride = t if mask.shape[0] == b and b > 1 else 0
    out = torch.empty_like(q)
    # the .so launches on the CUDA runtime's current card
    with torch.cuda.device(q.device):
        err = _lib().dw_int8_decode_attention(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), int(k_per_head), int(v_per_head), mask_ptr,
            mask_bstride, out.data_ptr(), b, n_heads, t, 64 ** -0.5,
            *_cluster_split(t),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 decode attention kernel launch failed "
                           f"(cudaError {err})")
    _build.count_launch(int8_decode_attention)
    return out


int8_decode_attention.launches = 0
