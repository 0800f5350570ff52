"""Multi-head attention ops, plain PyTorch.

Einsum formulation with fp32 softmax (the T5X ``float32_logits`` trick): the
products run in the model dtype with fp32 logits, and the numerically
brittle softmax stays fp32.  Counterpart of ``distil_whisper_tpu.ops.attention``;
the encoder's full self-attention goes through the hand-written kernel
(``ops/encoder_attention.py``) instead.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # large-negative mask fill that is bf16-safe


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        float32_logits: bool = True, return_probs: bool = False,
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None, dropout_group=None):
    """Scaled dot-product attention (einsum formulation).

    q: [B, Tq, H, D]   k, v: [B, Tk, H, D]   mask: broadcastable to [B, H, Tq, Tk]
    (True = attend).  Returns [B, Tq, H, D] in q.dtype.

    ``float32_logits=True``: logits and softmax in fp32 over the model-dtype
    operands (exact products, fp32 sums).  ``float32_logits=False`` (the bf16
    inference fast path): logits and softmax stay in the input dtype.

    ``return_probs``: also return the fp32 probabilities [B, H, Tq, Tk] (the
    softmax of the logits taken in fp32), as JAX's ``return_probs`` does for
    the cross-attention DTW alignment.

    ``dropout_rate`` with a ``generator``: inverted dropout on the
    probabilities (training), as JAX's ``dropout_rng``; with a model
    ``dropout_group`` the heads are this rank's, masked as their slice of
    the unsharded draw.
    """
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    q = q * scale
    if float32_logits:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    if dropout_rate > 0.0 and generator is not None:
        from ..parallel.tensor_parallel import rand_shard
        keep = rand_shard(probs.shape, 1, dropout_group, generator,
                          probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dtype)
    if return_probs:
        return out, torch.softmax(logits.float(), dim=-1)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_heads: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention against MERGED-layout K/V.

    q [B, D], k/v [B, T, D] with D = n_heads * head_dim; mask [B or 1, T]
    (True = attend).  Returns [B, D] in q.dtype.

    The JAX package computes this with a block-diagonal query so that a TPU
    never re-lays the cache out at 64 lanes; on the card a [B, T, H, hd] view
    of the merged buffer is free, so this is the head-split formulation with
    the same numerics: q pre-scaled in q.dtype, fp32 logits, fp32 softmax,
    probs cast to q.dtype, products p*v rounded to q.dtype and summed over T
    in fp32.
    """
    b, t, d = k.shape
    hd = d // n_heads
    qs = (q * hd ** -0.5).view(b, n_heads, hd)
    kh = k.view(b, t, n_heads, hd)
    vh = v.view(b, t, n_heads, hd)
    logits = torch.einsum("bthd,bhd->bth", kh.float(), qs.float())
    if mask is not None:
        logits = logits.masked_fill(~mask[:, :, None], NEG_INF)
    probs = torch.softmax(logits, dim=1).to(q.dtype)
    out = (probs[..., None] * vh).float().sum(dim=1)           # [B, H, hd]
    return out.reshape(b, d).to(q.dtype)


def causal_mask(tq: int, tk: int, offset, device=None) -> torch.Tensor:
    """Causal mask where query position i (global ``offset + i``) may attend
    to key positions <= offset + i.

    ``offset`` is an int ([1, 1, tq, tk] result) or a per-lane [B] tensor
    ([B, 1, tq, tk] result): each lane of a decode at its own cursor."""
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(tk, device=device)[None, :]
    if isinstance(offset, torch.Tensor):
        return (kpos[None] <= qpos[None] + offset.long()[:, None, None])[:, None]
    return (kpos <= qpos + offset)[None, None]
