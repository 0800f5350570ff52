"""Distillation and fine-tuning steps.

The port of ``distil_whisper_tpu.training.distill``.  A step computes the
loss, takes the gradients of every parameter leaf with ``torch.autograd``
(a leaf the loss does not reach gets ``None``, counted as zeros), records
the global norm of those raw gradients and hands them to
``TrainState.apply_gradients``.  The teacher side runs under ``no_grad``.

Shared frozen encoder: when the student's encoder is frozen and matches the
teacher's width and mel bins, the window is encoded once, by the teacher,
and both decoders read the same encoder states.  The chunked CE+KL
(``loss_chunk_size``) applies only there, without the hidden-state MSE.
Every term is normalised by the batch's token count, ``max(n, 1)``.

Data parallel (a ``mesh`` from ``parallel.make_mesh`` with more than one
rank on 'data'): each rank computes its rows' loss sums, divided by the
GLOBAL token count (the ranks' counts all-reduced first), so the sum over
ranks of the local gradients is the gradient of the global batch's loss,
which JAX's sharded step computes.  The gradients are summed over the
ranks in a few large fp32 buckets (``None`` leaves stay ``None``: which
leaves the loss reaches does not depend on the data), the global norm is
taken after the sum, and the loss metrics are summed for logging, so every
rank holds the same state and the same metrics.  Ranks holding different
token counts are why the per-rank means are not simply averaged.

Tensor parallel (a mesh with a 'model' axis, the state placed by
``place_state``): the model ranks of a data group feed the same rows and
compute the same loss on their shards (``models/whisper.py``); the token
counts, metrics and gradients are still summed over 'data' only, and the
global norm takes the sharded leaves over the model group
(``state.global_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..config import WhisperConfig
from ..models.params import tree_paths
from ..models.whisper import decode, encode, forward
from ..ops.qat import fake_quant_student_params
from ..parallel.mesh import data_group
from ..parallel.multihost import all_reduce_sum
from ..utils.profiling import StepTimer
from .losses import (chunked_ce_kl, cross_entropy, get_layers_to_supervise,
                     hidden_state_mse, kl_divergence)
from .state import OptimizerConfig, TrainState, global_norm

Params = Any


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    ce_weight: float = 0.8
    kl_weight: float = 1.0
    temperature: float = 2.0
    mse_weight: float = 0.0
    label_smoothing: float = 0.0
    freeze_encoder: bool = True
    share_encoder: bool = True      # student decodes on teacher enc states
    remat: bool = False
    loss_chunk_size: int = 0        # 0 = off (the same numbers when on)
    # QAT (ops/qat.py): 'none' | 'weights' | 'w8a8'.  Fake-quantizes the
    # student's decoder projections and MLP inside the loss (the encoder's
    # too when it is unfrozen), straight-through gradients
    quantize_student: str = "none"


def gradients(loss: torch.Tensor, state: TrainState
              ) -> Dict[str, Optional[torch.Tensor]]:
    """d loss / d leaf for every parameter leaf of ``state`` (None where
    the loss does not reach)."""
    leaves = state.leaves()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return dict(zip(leaves, grads))


class DataParallel:
    """The sums a data-parallel step takes over the mesh's 'data' axis;
    each is the identity without data parallelism.  ``timer`` holds the
    device time of each step's gradient reduction."""

    def __init__(self, mesh=None):
        self.group = data_group(mesh)
        self.timer: Optional[StepTimer] = None

    def count(self, n: torch.Tensor) -> torch.Tensor:
        """The global token count of a local one."""
        if self.group is None:
            return n
        return all_reduce_sum([n], self.group)[0].to(n.dtype)

    def metrics(self, metrics: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Loss terms of the local rows (local sums over the global
        count) summed into the global batch's."""
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.group is None:
            return metrics
        summed = all_reduce_sum(list(metrics.values()), self.group)
        return {k: s.to(v.dtype) for (k, v), s in zip(metrics.items(), summed)}

    def gradients(self, grads: Dict[str, Optional[torch.Tensor]]
                  ) -> Dict[str, Optional[torch.Tensor]]:
        """Gradients summed over the ranks (fp32)."""
        if self.group is None:
            return grads
        live = [p for p, g in grads.items() if g is not None]
        if self.timer is None:
            self.timer = StepTimer(grads[live[0]].device if live else "cpu")
        with self.timer:
            summed = all_reduce_sum([grads[p] for p in live], self.group)
        return {**grads, **dict(zip(live, summed))}


def _step(state: TrainState, loss: torch.Tensor, metrics: Dict,
          dp: DataParallel, grad_norm: bool = True):
    grads = dp.gradients(gradients(loss, state))
    metrics = dp.metrics(metrics)
    if grad_norm:
        metrics["grad_norm"] = global_norm(grads, state.model_group)
    state.apply_gradients(grads)
    return state, metrics


def build_train_step(student_cfg: WhisperConfig, teacher_cfg: WhisperConfig,
                     dcfg: DistillConfig, opt_cfg: OptimizerConfig, mesh=None):
    """Returns ``train_step(state, teacher_params, batch, generator=None)
    -> (state, metrics)`` and ``eval_step(params, teacher_params, batch)
    -> metrics``; ``train_step.data_parallel`` is the step's
    :class:`DataParallel`.

    batch: input_features [B, M, 3000], decoder_input_ids [B, S], labels
    [B, S] (-100 on prompt/pad), decoder_attention_mask [B, S] optional, all
    tensors on the device; under data parallelism, this rank's rows (every
    rank calls each step, and each eval step, alike).  ``generator`` turns
    on the student's dropout (under a mesh, one seeded with (seed, data
    coordinate): ``parallel.multihost.rank_generator(seed, mesh=mesh)``)."""
    dtype = opt_cfg.compute_dtype
    dp = DataParallel(mesh)
    share = dcfg.share_encoder and dcfg.freeze_encoder and (
        student_cfg.d_model == teacher_cfg.d_model
        and student_cfg.num_mel_bins == teacher_cfg.num_mel_bins)
    use_mse = dcfg.mse_weight > 0.0
    layer_map = get_layers_to_supervise(
        student_cfg.decoder_layers, teacher_cfg.decoder_layers) if use_mse else ()
    chunked = dcfg.loss_chunk_size > 0 and share and not use_mse

    def weighted(ce_sum, kl_sum, n_tok):
        n_tok = torch.clamp(dp.count(n_tok), min=1.0)
        ce, kl = ce_sum / n_tok, kl_sum / n_tok
        loss = dcfg.ce_weight * ce + dcfg.kl_weight * kl
        return loss, {"ce_loss": ce, "kl_loss": kl}

    def compute_losses(params: Params, teacher: Params,
                       batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None):
        if dcfg.quantize_student != "none":
            # QAT: fresh scales every step, applied to the live tree
            params = fake_quant_student_params(
                params, dcfg.quantize_student,
                encoder_too=not dcfg.freeze_encoder)
        mel = batch["input_features"]
        dec_in = batch["decoder_input_ids"]
        labels = batch["labels"]
        mask = batch.get("decoder_attention_mask")
        common = dict(attention_mask=mask, dtype=dtype)

        if share:
            with torch.no_grad():
                enc = encode(teacher["encoder"], teacher_cfg, mel,
                             dtype=dtype, freeze=True)
                t_out = decode(teacher["decoder"], teacher_cfg, dec_in,
                               enc=enc, output_hidden_states=use_mse,
                               skip_logits=chunked, **common)
            s_out = decode(params["decoder"], student_cfg, dec_in, enc=enc,
                           remat=dcfg.remat, output_hidden_states=use_mse,
                           generator=generator, skip_logits=chunked,
                           **common)
            if chunked:
                loss, metrics = weighted(*chunked_ce_kl(
                    s_out[0], t_out[0], params["decoder"]["tok_emb"],
                    teacher["decoder"]["tok_emb"], labels,
                    temperature=dcfg.temperature,
                    label_smoothing=dcfg.label_smoothing,
                    chunk=dcfg.loss_chunk_size))
                metrics["loss"] = loss
                return loss, metrics
            t_logits, s_logits = t_out[0], s_out[0]
            t_hs = t_out[2] if use_mse else None
            s_hs = s_out[2] if use_mse else None
        else:
            with torch.no_grad():
                t_logits, t_aux = forward(
                    teacher, teacher_cfg, mel, dec_in,
                    decoder_attention_mask=mask, dtype=dtype,
                    output_hidden_states=use_mse)
            s_logits, s_aux = forward(
                params, student_cfg, mel, dec_in,
                decoder_attention_mask=mask, dtype=dtype, remat=dcfg.remat,
                freeze_encoder=dcfg.freeze_encoder,
                output_hidden_states=use_mse, generator=generator)
            t_hs = t_aux.get("decoder_hidden_states")
            s_hs = s_aux.get("decoder_hidden_states")

        ce_sum, n_tok = cross_entropy(s_logits, labels, dcfg.label_smoothing)
        kl_sum, _ = kl_divergence(t_logits, s_logits, labels, dcfg.temperature)
        loss, metrics = weighted(ce_sum, kl_sum, n_tok)
        if use_mse:
            mse_sum, mse_n = hidden_state_mse(t_hs, s_hs, layer_map, labels)
            mse = mse_sum / torch.clamp(dp.count(mse_n), min=1.0)
            loss = loss + dcfg.mse_weight * mse
            metrics["mse_loss"] = mse
        metrics["loss"] = loss
        return loss, metrics

    def train_step(state: TrainState, teacher_params: Params,
                   batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        loss, metrics = compute_losses(state.params, teacher_params, batch,
                                       generator)
        return _step(state, loss, metrics, dp)

    @torch.no_grad()
    def eval_step(params: Params, teacher_params: Params,
                  batch: Dict[str, torch.Tensor]):
        return dp.metrics(compute_losses(params, teacher_params, batch)[1])

    train_step.data_parallel = dp
    return train_step, eval_step


def build_finetune_step(cfg: WhisperConfig, opt_cfg: OptimizerConfig,
                        label_smoothing: float = 0.0, remat: bool = False,
                        freeze_encoder: bool = False,
                        quantize_student: str = "none", mesh=None):
    """Plain CE fine-tuning: ``train_step(state, batch, generator=None) ->
    (state, metrics)`` and ``eval_step(params, batch) -> metrics``, data
    parallel over ``mesh`` as :func:`build_train_step`.

    ``quantize_student`` ('none' | 'weights' | 'w8a8'): QAT (ops/qat.py) of
    the decoder, and of the encoder too unless it is frozen."""
    dtype = opt_cfg.compute_dtype
    dp = DataParallel(mesh)

    def loss_fn(params, batch, generator=None):
        if quantize_student != "none":
            params = fake_quant_student_params(
                params, quantize_student, encoder_too=not freeze_encoder)
        logits, _ = forward(params, cfg, batch["input_features"],
                            batch["decoder_input_ids"],
                            decoder_attention_mask=batch.get(
                                "decoder_attention_mask"),
                            dtype=dtype, remat=remat,
                            freeze_encoder=freeze_encoder,
                            generator=generator)
        ce_sum, n_tok = cross_entropy(logits, batch["labels"], label_smoothing)
        loss = ce_sum / torch.clamp(dp.count(n_tok), min=1.0)
        return loss, {"loss": loss}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        loss, metrics = loss_fn(state.params, batch, generator)
        return _step(state, loss, metrics, dp, grad_norm=False)

    @torch.no_grad()
    def eval_step(params, batch):
        return dp.metrics(loss_fn(params, batch)[1])

    train_step.data_parallel = dp
    return train_step, eval_step


def optax_global_norm(tree) -> torch.Tensor:
    """fp32 global norm of a gradient tree or path dict (None leaves are
    zeros)."""
    return global_norm(tree_paths(tree))
