"""Quantization-aware training (QAT) by straight-through estimation, the
port of ``distil_whisper_tpu.ops.qat``.

The int8 serving stack (``ops/quant.py``: W8A8 projections and MLP, int8 KV
caches, the int8 lm head) is post-training quantization.  QAT trains the
student against the quantized forward numerics, so the weights it learns
are the ones the int8 path serves:

* **Fake-quant weights**: ``w + (dq(q(w)) - w).detach()`` with the same
  per-output-channel symmetric absmax as the serving quantizer
  (:func:`..ops.quant.quantize_weight`, including its IEEE division by 127),
  so train-time and serve-time weight values are bit-identical.  The
  gradient is the identity: the optimizer updates the full-precision
  master weights.
* **Fake-quant activations** (``w8a8``): dynamic per-row absmax through
  :func:`..ops.quant.quantize_acts`, applied inside ``dense()`` and
  ``fused_self_attention`` when the param subtree carries the ``act_fq``
  marker, a zero-size int8 tensor (``[L, 0]`` for stacked kernels, so
  that a layer's view of it is one too).
* **Scope**: the student's decoder projections and MLP, what
  ``cfg.quantize_decoder`` serves; the encoder's too when it is unfrozen.
  The tied embedding stays exact.

Under tensor parallelism a row-parallel kernel (out, fc2) takes the model
group's max of its per-output-channel absmax, every step (the weights
move), and a row-parallel input the group's max of its row absmax, so the
fake-quant values are the unsharded tree's.

The straight-through sum is written as JAX writes it, ``x + (dq -
x).detach()`` in fp32 and then cast: returning ``dq`` itself would differ
from JAX's ``x + stop_gradient(q - x)`` in the last fp32 bit.  The
transform is applied inside the loss on the live parameters at every step
(fresh scales), and the marker lives only in that tree: the optimizer never
sees it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from .quant import (layers_group, map_decoder_dense, map_encoder_dense,
                    over_127, quantize_acts, quantize_weight)

Params = Dict[str, Any]

# the key whose presence makes ``dense()`` fake-quant its input
ACT_FQ_KEY = "act_fq"


def _ste(x32: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Value of ``dq``, gradient of ``x32`` (straight-through)."""
    return x32 + (dq - x32).detach()


def fake_quant_weight(kernel: torch.Tensor, contract_axis: int = -2,
                      group=None) -> torch.Tensor:
    """Per-output-channel int8 fake-quant with identity gradient: the value
    of ``q * scale`` of :func:`..ops.quant.quantize_weight` (``group``: a
    row-parallel shard)."""
    q, scale = quantize_weight(kernel.detach(), contract_axis, group)
    return _ste(kernel.float(), q.float() * scale).to(kernel.dtype)


def fake_quant_acts(x: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic per-row (last-dim) int8 fake-quant, identity gradient
    (``group``: a row-parallel input)."""
    q, scale = quantize_acts(x.detach(), group)
    return _ste(x.float(), q.float() * scale).to(x.dtype)


def fake_quant_acts_axes(x: torch.Tensor, axes: Sequence[int]
                         ) -> torch.Tensor:
    """Symmetric int8 fake-quant with the absmax over ``axes`` (kept), the
    constants of :func:`..ops.quant.quantize_acts`, identity gradient."""
    x32 = x.float()
    amax = x32.detach().abs().amax(dim=tuple(axes), keepdim=True)
    scale = over_127(torch.clamp(amax, min=1e-12))
    dq = torch.clamp(torch.round(x32.detach() / scale), -127, 127) * scale
    return _ste(x32, dq).to(x.dtype)


def fake_quant_dense(p: Params, acts: bool, group=None) -> Params:
    """{kernel, bias?} -> the same tree with fake-quant kernel values (and
    the ``act_fq`` marker in w8a8 mode); ``group`` for a row-parallel
    shard."""
    out = {"kernel": fake_quant_weight(p["kernel"], group=group)}
    if "bias" in p:
        out["bias"] = p["bias"]
    if acts:
        lead = (p["kernel"].shape[0], 0) if p["kernel"].dim() == 3 else (0,)
        out[ACT_FQ_KEY] = torch.zeros(lead, dtype=torch.int8,
                                      device=p["kernel"].device)
    return out


def fake_quant_decoder_params(dec: Params, acts: bool = True) -> Params:
    """Decoder subtree -> fake-quant self/cross q/k/v/out and fc1/fc2, by
    the traversal of ``quantize_decoder_params`` (``map_decoder_dense``), so
    the QAT scope is the serving scope.

    One bounded difference from serving stays, as in JAX: an int8 decoder
    MLP pass of 256 rows or more in bf16 on the card (teacher-forced
    scoring, a large prefill; never a single-token step) takes the fused
    int8 MLP kernel, which requantizes the gelu output per (row, 512-chunk),
    finer than QAT's per-row fake-quant of the fc2 input."""
    out = dict(dec)
    out["layers"] = map_decoder_dense(
        dec["layers"], lambda p, g: fake_quant_dense(p, acts, g),
        layers_group(dec["layers"]))
    return out


def fake_quant_encoder_params(enc: Params, acts: bool = True) -> Params:
    """Encoder subtree -> fake-quant self q/k/v/out and fc1/fc2 (the
    ``quantize_encoder_params`` scope).  Only useful when the encoder is
    unfrozen; the fused int8 MLP kernel that serves it requantizes per
    (row, 512-chunk), as noted for the decoder."""
    out = dict(enc)
    out["layers"] = map_encoder_dense(
        enc["layers"], lambda p, g: fake_quant_dense(p, acts, g),
        layers_group(enc["layers"]))
    return out


def fake_quant_student_params(params: Params, mode: str,
                              encoder_too: bool = False) -> Params:
    """Full student tree -> the QAT forward tree.

    ``mode``: ``"w8a8"`` (weights and dynamic activation fake-quant: the
    serving numerics) or ``"weights"`` (weights only, an ablation)."""
    if mode not in ("weights", "w8a8"):
        raise ValueError(f"quantize_student mode {mode!r} not in "
                         "('weights', 'w8a8')")
    acts = mode == "w8a8"
    out = dict(params)
    out["decoder"] = fake_quant_decoder_params(params["decoder"], acts)
    if encoder_too:
        out["encoder"] = fake_quant_encoder_params(params["encoder"], acts)
    return out
