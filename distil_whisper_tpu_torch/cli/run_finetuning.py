"""Plain CE fine-tuning (no teacher), on one GPU or data parallel over
several (one process a GPU).

The port of ``distil_whisper_tpu.cli.run_finetuning`` with its flags: the
distillation trainer's skeleton with label-smoothed cross-entropy only, the
same data order, step checkpoints and the final HF-format export.  Runs on
the GPU unless ``--device cpu``.  ``--quantize_student`` trains through
the int8 serving numerics (QAT, ``ops/qat.py``).  ``--distributed`` (under
``torchrun``) runs data parallel as ``run_distillation`` does: each rank
prepares its contiguous shard and feeds ``--per_device_train_batch_size``
rows a step, rank 0 writes, and the run ends with its last checkpoint for
``convert_checkpoint_to_hf``.  ``--model_parallel N`` shards the state over
a ``(world / N, N)`` mesh's model axis, as in ``run_distillation``.
``--param_sharding 2d`` raises, naming its ROADMAP.md item.

    python -m distil_whisper_tpu_torch.cli.run_finetuning \\
        --model_checkpoint /ckpts/whisper-small \\
        --train_dataset_path ./data.jsonl --output_dir ./ft-run --max_steps 5000
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import load_params, save_pretrained
from ..models.params import to_fp32
from ..tokenizer import (BasicTextNormalizer, EnglishTextNormalizer,
                         WhisperTokenizer)
from ..parallel.mesh import coordinates
from ..parallel.multihost import world_size
from ..training import (Collator, CheckpointManager, OptimizerConfig,
                        TrainState, build_finetune_step, place_state)
from ..utils.profiling import MetricsLogger, StepTimer
from .common import (copy_tokenizer_files, load_dataset_any, logger,
                     setup_data_parallel, setup_logging, shard_rows)
from .run_distillation import (Profiler, _prepare_samples, peak_memory,
                               refuse_unported, step_times, to_device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--train_dataset_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--precision", default="half_mixed",
                   choices=["full", "half_mixed", "full_mixed"])
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--quantize_student", default="none",
                   choices=["none", "weights", "w8a8"],
                   help="quantization-aware training (ops/qat.py): "
                        "fake-quantize the model's projections and MLP in "
                        "the forward (the decoder always, the encoder too "
                        "unless --freeze_encoder) with straight-through "
                        "gradients, so the fine-tuned weights serve under "
                        "the int8 stack")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--max_label_length", type=int, default=448)
    p.add_argument("--min_duration_s", type=float, default=0.0)
    p.add_argument("--max_duration_s", type=float, default=30.0)
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe")
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--logging_steps", type=int, default=25)
    p.add_argument("--report_to", default="jsonl",
                   help="comma list of metrics sinks: jsonl / stdout / "
                        "tensorboard / wandb (see run_distillation)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steps with torch.profiler "
                        "(starting 2 steps in)")
    p.add_argument("--profile_dir", default=None,
                   help="trace output dir (default <output_dir>/trace)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training, one process a GPU under "
                        "torchrun; fails fast unless the job has several "
                        "ranks")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism, as run_distillation's")
    p.add_argument("--param_sharding", default="1d", choices=["1d", "2d"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)
    refuse_unported(args)
    setup_logging()
    mesh = setup_data_parallel(args.distributed, args.device,
                               args.model_parallel)
    device = resolve_device(args.device)
    n_proc = world_size()
    d_idx, n_data, _, _ = coordinates(mesh)
    rng = np.random.default_rng(args.seed)

    params, cfg = load_params(args.model_checkpoint, device=device)
    tok = WhisperTokenizer.from_pretrained(args.model_checkpoint)
    normalizer = (EnglishTextNormalizer(tok.spelling_mapping)
                  if args.language in (None, "en", "english")
                  else BasicTextNormalizer())
    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=args.max_steps, weight_decay=args.weight_decay,
        b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
        precision=args.precision,
        frozen_prefixes=("encoder",) if args.freeze_encoder else ())
    state = place_state(TrainState.create(params, opt_cfg), mesh)
    del params
    train_step, _ = build_finetune_step(
        cfg, opt_cfg, label_smoothing=args.label_smoothing,
        remat=args.gradient_checkpointing, freeze_encoder=args.freeze_encoder,
        quantize_student=args.quantize_student, mesh=mesh)

    ft_args = argparse.Namespace(**{**vars(args), "use_pseudo_labels": False,
                                    "wer_threshold": None,
                                    "timestamp_probability": 0.0,
                                    "condition_on_prev_probability": 0.0})
    train_ds = load_dataset_any(args.train_dataset_path, "train")
    if n_data > 1:
        # shard BEFORE preparation: each rank pays the mel and filter cost
        # of its own rows only (the loop cycles: unequal counts are fine)
        train_ds = shard_rows(train_ds, n_data, d_idx)
    samples = _prepare_samples(train_ds, tok, cfg, ft_args, normalizer, rng,
                               device)
    # mask prompts with the tokenizer's SOT (see run_distillation)
    collator = Collator(decoder_start_token_id=tok.sot,
                        pad_token_id=cfg.pad_token_id,
                        max_target_length=args.max_label_length)
    mgr = CheckpointManager(args.output_dir,
                            save_total_limit=args.save_total_limit)
    bsz = args.per_device_train_batch_size
    metrics_log = MetricsLogger(
        str(Path(args.output_dir) / "metrics.jsonl"),
        report_to=tuple(s.strip() for s in args.report_to.split(",")),
        run_name=Path(args.output_dir).name)
    order = rng.permutation(len(samples))
    cursor = 0
    timer = StepTimer(device)
    profiler = None
    if device.type == "cuda":   # the steps' peak, not the loading's
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for step in range(args.max_steps):
        if args.profile_steps:
            if step == 2:
                profiler = Profiler(args.profile_dir or
                                    str(Path(args.output_dir) / "trace"),
                                    device)
            elif profiler and step == 2 + args.profile_steps:
                metrics_log.log(step, profiler.stop(args.profile_steps))
                profiler = None
        idx = []
        while len(idx) < bsz:
            if cursor >= len(order):
                order = rng.permutation(len(samples))
                cursor = 0
            idx.append(order[cursor])
            cursor += 1
        raw = collator([samples[i] for i in idx])
        with timer:
            state, metrics = train_step(state, to_device(raw, device))
        if (step + 1) % args.logging_steps == 0:
            loss = float(metrics["loss"])
            sps = (step + 1) / (time.perf_counter() - t0)
            logger.info("step %d: loss=%.4f (%.2f steps/s)",
                        step + 1, loss, sps)
            metrics_log.log(step + 1, {
                "train/loss": loss,
                "train/steps_per_second": sps,
                **step_times(timer, train_step,
                             int((raw["labels"] != -100).sum()), mesh),
                **peak_memory(device)})
        if (step + 1) % args.save_steps == 0:
            mgr.save(step + 1, state)
    if profiler:
        metrics_log.log(args.max_steps, profiler.stop(args.max_steps - 2))
    metrics_log.close()
    if args.max_steps % args.save_steps != 0:
        mgr.save(args.max_steps, state)
    final_dir = Path(args.output_dir) / "end-of-training-weights"
    if n_proc > 1:
        ckpt_dir = Path(args.output_dir) / f"checkpoint-{args.max_steps}"
        logger.info("multi-process run: convert the final checkpoint with "
                    "python -m distil_whisper_tpu_torch.cli."
                    "convert_checkpoint_to_hf --checkpoint_dir %s "
                    "--base_checkpoint %s --save_dir %s --distributed",
                    ckpt_dir, args.model_checkpoint, final_dir)
        return str(ckpt_dir)
    save_pretrained(to_fp32(state.params), cfg, str(final_dir))
    copy_tokenizer_files(args.model_checkpoint, str(final_dir))
    logger.info("final weights exported to %s", final_dir)
    return str(final_dir)


if __name__ == "__main__":
    main()
