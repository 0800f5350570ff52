"""Distillation losses: CE + temperature-scaled KL + hidden-state MSE.

The port of ``distil_whisper_tpu.training.losses``: loss = ce_weight * CE +
kl_weight * T^2 * KL (+ mse_weight * MSE on mapped hidden states), every term
token-masked and normalised by the global number of label tokens.  Every
term is taken in fp32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

LABEL_PAD = -100


def token_mask(labels: torch.Tensor) -> torch.Tensor:
    """fp32 mask of supervised positions ([B, S]); prompt/pad carry -100."""
    return (labels != LABEL_PAD).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token-level CE.  Returns (summed loss, token count).

    With label smoothing the loss is shifted by the constant that makes its
    minimum 0 (the JAX package's normaliser)."""
    mask = token_mask(labels)
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        v = logits.shape[-1]
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
        low_conf = label_smoothing / (v - 1)
        norm = -((1.0 - label_smoothing) * math.log(1.0 - label_smoothing)
                 + (v - 1) * low_conf * math.log(low_conf + 1e-20))
        nll = nll - norm
    return (nll * mask).sum(), mask.sum()


def kl_divergence(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                  labels: torch.Tensor, temperature: float = 2.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked KL(teacher || student) with T^2 scaling; the teacher takes no
    gradient."""
    mask = token_mask(labels)
    t = teacher_logits.detach().float() / temperature
    s = student_logits.float() / temperature
    t_logp = torch.log_softmax(t, dim=-1)
    kl = (t_logp.exp() * (t_logp - torch.log_softmax(s, dim=-1))).sum(dim=-1)
    kl = kl * temperature ** 2
    return (kl * mask).sum(), mask.sum()


def _chunk_losses(syc, tyc, lc, student_emb, teacher_emb, temperature,
                  label_smoothing):
    """CE, KL and token count of one S-chunk; its fp32 [B, chunk, V]
    logits (fp32 products of the working-dtype operands, as ``decode``)."""
    sl = torch.matmul(syc.float(), student_emb.to(syc.dtype).float().T)
    tl = torch.matmul(tyc.float(), teacher_emb.to(tyc.dtype).float().T)
    ce, n = cross_entropy(sl, lc, label_smoothing)
    kl, _ = kl_divergence(tl, sl, lc, temperature)
    return ce, kl, n


def chunked_ce_kl(student_y: torch.Tensor, teacher_y: torch.Tensor,
                  student_emb: torch.Tensor, teacher_emb: torch.Tensor,
                  labels: torch.Tensor, temperature: float = 2.0,
                  label_smoothing: float = 0.0, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CE + KL without materialising the full [B, S, V] logits.

    ``student_y``/``teacher_y`` are the decoders' final-LayerNorm hidden
    states [B, S, d].  S is padded to a multiple of ``chunk`` (labels with
    ``LABEL_PAD``) and the vocabulary projection runs chunk by chunk under
    ``torch.utils.checkpoint``, which recomputes a chunk's logits in the
    backward: only one fp32 [B, chunk, V] pair is alive at a time.  Returns
    (ce_sum, kl_sum, n_tokens), the unchunked pair's contract."""
    b, s, d = student_y.shape
    pad = (-s) % chunk
    if pad:
        student_y = torch.nn.functional.pad(student_y, (0, 0, 0, pad))
        teacher_y = torch.nn.functional.pad(teacher_y, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=LABEL_PAD)
    teacher_y = teacher_y.detach()
    zero = torch.zeros((), device=student_y.device)
    ce, kl, n = zero, zero, zero
    for c in range(0, s + pad, chunk):
        args = (student_y[:, c:c + chunk], teacher_y[:, c:c + chunk],
                labels[:, c:c + chunk], student_emb, teacher_emb,
                temperature, label_smoothing)
        if torch.is_grad_enabled():
            out = checkpoint(_chunk_losses, *args, use_reentrant=False)
        else:
            out = _chunk_losses(*args)
        ce, kl, n = ce + out[0], kl + out[1], n + out[2]
    return ce, kl, n


def hidden_state_mse(teacher_hs: torch.Tensor, student_hs: torch.Tensor,
                     layer_map: Sequence[int], labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSE between student layers and mapped teacher layers.

    teacher_hs/student_hs: [L+1, B, S, D] (embeddings + every layer).
    ``layer_map[i]`` is the teacher hidden-state index that supervises
    student layer i+1 (:func:`get_layers_to_supervise`)."""
    mask = token_mask(labels)[None, :, :, None]
    idx = torch.as_tensor(list(layer_map), device=teacher_hs.device)
    t = teacher_hs.detach()[idx].float()
    se = (student_hs[1:].float() - t).square() * mask
    return se.mean(dim=-1).sum(), token_mask(labels).sum() * len(layer_map)


def get_layers_to_supervise(student_layers: int, teacher_layers: int
                            ) -> list:
    """Maximally-spaced teacher hidden states, the last pinned:
    ``linspace(teacher_L // student_L, teacher_L, student_L)``."""
    return [int(i) for i in
            np.linspace(teacher_layers // student_layers, teacher_layers,
                        student_layers).astype(int)]
