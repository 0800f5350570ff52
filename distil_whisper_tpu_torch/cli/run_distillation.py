"""Knowledge distillation trainer (pseudo-labelled data -> distil student),
on one GPU or data parallel over several (one process a GPU).

The port of ``distil_whisper_tpu.cli.run_distillation`` with its flags and
defaults: WER-threshold filtering of pseudo-labels, timestamp / condition-
on-prev label sampling, ce_weight * CE + kl_weight * T^2 * KL (+ mse_weight
hidden-state MSE), the shared frozen encoder, the precision policies,
``--teacher_precision train|inference|int8``, the chunked loss, remat,
``--quantize_student`` (QAT), eval WER through ``encode_and_generate``,
step checkpoints with rotation, best-by-val-WER checkpoints, resume, and
the final HF-format export.  The data order is the JAX trainer's (the same
``np.random.default_rng(seed)`` permutations, or with ``--streaming`` the
same shuffle buffer over rows prepared on the fly by a producer thread); a
resumed run skips the batches its checkpoint has seen, so it continues as
the uninterrupted run would.  Runs on the GPU unless ``--device cpu``.

Data parallel (``--distributed`` under ``torchrun``, one rank a GPU, as the
JAX trainer's multi-process branches): every rank holds a replica of the
student, broadcast from rank 0, prepares its contiguous shard of the
training set and feeds ``--per_device_train_batch_size`` rows of it a step
(the global batch is that times the data axis); gradients are summed over
the ranks.  The eval set is sliced into equal parts (the eval runs
collectives per batch) and its error counts summed; rank 0 writes the
metrics, predictions and checkpoints; a SIGTERM stop is agreed at logging,
eval and save boundaries; the run ends with its last checkpoint, which
``convert_checkpoint_to_hf`` exports.  ``--model_parallel N`` (with
``--distributed``) runs a ``(world / N, N)`` mesh: the teacher and the
student's state are sharded over the model axis (tensor parallelism,
``parallel/tensor_parallel.py``), the rows are sharded by the data
coordinate, the global batch is the per-device batch times the data axis,
and checkpoints hold the gathered state.  ``--param_sharding 2d`` (with
``--distributed``) slices the teacher and the student's parameters,
moments and accumulated gradient over the data axis too (FSDP-style,
``RULES_2D``): the model gathers each layer where it takes it and
reduce-scatters its gradient (``parallel/fsdp.py``); the step's numbers
are the 1-D step's.

    python -m distil_whisper_tpu_torch.cli.run_distillation \\
        --teacher_checkpoint /ckpts/whisper-large-v3 \\
        --student_checkpoint ./distil-init \\
        --train_dataset_path ./pl_out/train.jsonl --output_dir ./distil-run \\
        --max_steps 80000 --per_device_train_batch_size 64
    torchrun --nproc_per_node 4 -m distil_whisper_tpu_torch.cli.run_distillation \\
        ... --distributed
"""

from __future__ import annotations

import argparse
import json
import signal
import time
from pathlib import Path

import numpy as np
import torch

from ..audio import compute_mel
from ..audio.io import load_audio
from ..device import resolve_device
from ..generation import GenerationOptions, encode_and_generate
from ..generation.graphs import GraphOwner
from ..metrics import WordErrors, process_words
from ..models import load_params, save_pretrained
from ..models.convert import FP32_LEAVES
from ..models.params import map_with_path, to_fp32
from ..ops.quant import quantize_teacher_params
from ..parallel import DEFAULT_RULES, RULES_2D, process_local_slice, \
    shard_params
from ..parallel.mesh import coordinates
from ..parallel.multihost import (any_over_ranks, gather_rows,
                                  is_distributed, rank, sum_over_ranks,
                                  world_size)
from ..tokenizer import (BasicTextNormalizer, EnglishTextNormalizer,
                         WhisperTokenizer)
from ..training import (Collator, CheckpointManager, DistillConfig,
                        OptimizerConfig, TrainState, build_train_step,
                        is_wer_in_range, place_state, prepare_labels)
from ..training.data_stream import streaming_batches
from ..utils.profiling import MetricsLogger, StepTimer, device_time_ms
from .common import (copy_tokenizer_files, load_dataset_any,
                     load_multiple_datasets, logger, setup_data_parallel,
                     setup_logging, shard_rows, summed_word_errors)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--teacher_checkpoint", required=True)
    p.add_argument("--student_checkpoint", required=True)
    p.add_argument("--train_dataset_path", required=True,
                   help="dataset path, or `+`-delimited list to interleave")
    p.add_argument("--train_splits", default=None)
    p.add_argument("--dataset_probabilities", default=None)
    p.add_argument("--min_duration_s", type=float, default=0.0)
    p.add_argument("--max_duration_s", type=float, default=30.0)
    p.add_argument("--streaming", action="store_true",
                   help="prepare rows on the fly (load, filter, labels, "
                        "log-mel) in a producer thread through a shuffle "
                        "buffer of --shuffle_buffer_size rows, instead of "
                        "preparing the whole set before the first step")
    p.add_argument("--shuffle_buffer_size", type=int, default=256)
    p.add_argument("--eval_dataset_path", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--per_device_eval_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--lr_scheduler_type", default="constant_with_warmup")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--precision", default="half_mixed",
                   choices=["full", "half_mixed", "full_mixed"])
    p.add_argument("--wer_threshold", type=float, default=10.0)
    p.add_argument("--use_pseudo_labels", action="store_true", default=True)
    p.add_argument("--no_pseudo_labels", dest="use_pseudo_labels",
                   action="store_false")
    p.add_argument("--timestamp_probability", type=float, default=0.2)
    p.add_argument("--condition_on_prev_probability", type=float, default=0.2)
    p.add_argument("--round_timestamps", action="store_true",
                   help="round timestamp labels to 0.1 s")
    p.add_argument("--max_label_length", type=int, default=448)
    p.add_argument("--freeze_encoder", action="store_true", default=True)
    p.add_argument("--train_encoder", dest="freeze_encoder",
                   action="store_false")
    p.add_argument("--freeze_decoder", action="store_true",
                   help="freeze the decoder except the tied embeddings/LM "
                        "head")
    p.add_argument("--freeze_embed_positions", action="store_true",
                   help="freeze the decoder position embeddings")
    p.add_argument("--preprocessing_only", action="store_true",
                   help="prepare + cache the training set, then exit")
    p.add_argument("--preprocessed_cache", default=None,
                   help="directory for the prepared-sample cache (written by "
                        "--preprocessing_only, reused on the training run)")
    p.add_argument("--param_sharding", default="1d", choices=["1d", "2d"],
                   help="2d: parameters, moments and accumulated gradient "
                        "sliced over the data axis too (FSDP-style; with "
                        "--distributed)")
    p.add_argument("--ce_weight", type=float, default=0.8)
    p.add_argument("--kl_weight", type=float, default=1.0)
    p.add_argument("--mse_weight", type=float, default=0.0)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe")
    p.add_argument("--eval_steps", type=int, default=500)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--save_total_limit", type=int, default=1)
    p.add_argument("--save_best_total_limit", type=int, default=1,
                   help="how many best-by-val-WER checkpoints to keep")
    p.add_argument("--logging_steps", type=int, default=25)
    p.add_argument("--report_to", default="jsonl",
                   help="comma list of metrics sinks: jsonl (default), "
                        "stdout, tensorboard (where importable), wandb "
                        "(needs WANDB_PROJECT)")
    p.add_argument("--tensorboard_dir", default=None,
                   help="TB event-file dir (default <output_dir>/tb)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steps with torch.profiler, starting "
                        "2 steps after the first; the Chrome trace goes to "
                        "--profile_dir and the device and wall time per "
                        "step to the metrics")
    p.add_argument("--profile_dir", default=None,
                   help="trace output dir (default <output_dir>/trace)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training, one process a GPU under "
                        "torchrun; fails fast unless the job has several "
                        "ranks")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism: ranks a model group (the mesh "
                        "is (world / N, N)); needs --distributed and a "
                        "degree that divides the world size, the heads and "
                        "the ffn widths")
    p.add_argument("--resume_from_checkpoint", action="store_true")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--eval_max_new_tokens", type=int, default=128)
    p.add_argument("--teacher_precision", default="train",
                   choices=["train", "inference", "int8"],
                   help="numerics of the teacher side of the step, which is "
                        "inference only: 'train' = the training policy "
                        "(default, exact); 'inference' = bf16 fast attention "
                        "and the encoder-attention kernel (bf16 compute); "
                        "'int8' = inference + W8A8 int8 teacher projections "
                        "(the int8 MLP kernel in its encoder).  Under the "
                        "shared frozen encoder the student trains on the "
                        "approximate teacher's encoder states")
    p.add_argument("--quantize_student", default="none",
                   choices=["none", "weights", "w8a8"],
                   help="quantization-aware training of the student "
                        "(ops/qat.py): fake-quantize its decoder projections "
                        "and MLP in the forward with straight-through "
                        "gradients, so the trained weights serve under the "
                        "int8 stack (--quantize_decoder).  'w8a8' (weights "
                        "and dynamic per-row activations) is the serving "
                        "numerics; 'weights' is an ablation.  An unfrozen "
                        "encoder (--train_encoder) is fake-quantized too")
    p.add_argument("--loss_chunk_size", type=int, default=0,
                   help="chunked CE+KL: never materialise the [B,S,V] "
                        "student+teacher logits pair; 0 = off.  The same "
                        "numbers")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p.parse_args(argv)


def param_rules(args):
    """The rule table of ``--param_sharding``."""
    return RULES_2D if args.param_sharding == "2d" else DEFAULT_RULES


def to_compute_dtype(params, dtype: torch.dtype):
    """Floating leaves to ``dtype``, the int8 scales kept fp32."""
    return map_with_path(
        lambda path, x: x.to(dtype) if (x.is_floating_point() and
                                        path.rsplit(".", 1)[-1]
                                        not in FP32_LEAVES) else x, params)


def _prepare_row(row, tok, cfg, args, normalizer, rng, device):
    """One raw row -> training sample (or None when filtered)."""
    text_col = "whisper_transcript" if args.use_pseudo_labels else "text"
    transcript = row.get(text_col)
    if args.use_pseudo_labels and args.wer_threshold is not None:
        if not is_wer_in_range(row.get("text", ""), transcript,
                               normalizer, args.wer_threshold):
            return None
    audio = load_audio(row["audio"], cfg.sampling_rate)
    if not (args.min_duration_s * cfg.sampling_rate < len(audio)
            <= args.max_duration_s * cfg.sampling_rate):
        return None
    prev = row.get("condition_on_prev")
    labels = prepare_labels(
        tok, transcript, is_pseudo_label=args.use_pseudo_labels,
        language=args.language, task=args.task,
        prev_ids=list(prev)[1:] if prev else None,
        timestamp_probability=args.timestamp_probability,
        condition_on_prev_probability=args.condition_on_prev_probability,
        max_label_length=args.max_label_length,
        round_timestamps=getattr(args, "round_timestamps", False), rng=rng)
    if not (1 < len(labels) < args.max_label_length):
        return None
    mel = compute_mel(audio, cfg, device=device)[0].cpu().numpy()
    return {"input_features": mel, "labels": labels,
            "text": row.get("text", "")}


def _prepare_samples(ds, tok, cfg, args, normalizer, rng, device):
    """Filter + label-prepare + feature-extract (the log-mel on the
    device)."""
    samples = []
    n_filtered = 0
    for row in ds:
        s = _prepare_row(row, tok, cfg, args, normalizer, rng, device)
        if s is None:
            n_filtered += 1
        else:
            samples.append(s)
    logger.info("prepared %d samples (%d filtered)", len(samples), n_filtered)
    return samples


def peak_memory(device) -> dict:
    """The device's peak allocated memory since the steps began (CUDA)."""
    if device.type != "cuda":
        return {}
    return {"train/peak_mem_gib": torch.cuda.max_memory_allocated(device)
            / 2 ** 30}


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def step_times(timer, train_step, label_tokens: int, mesh=None) -> dict:
    """A logged step's times and label tokens.  Data parallel: the global
    label-token count (each data rank's once), the slowest rank's step
    time, every rank's step time and gradient all-reduce time (CUDA
    events) in rank order."""
    step_s = timer.times[-1]
    if not is_distributed():
        return {"train/step_time_s": step_s,
                "train/label_tokens": label_tokens}
    dp_timer = train_step.data_parallel.timer
    reduce_s = dp_timer.times[-1] if dp_timer is not None else 0.0
    once = coordinates(mesh)[2] == 0
    per_rank = gather_rows(np.asarray([[step_s, reduce_s,
                                        label_tokens * once]]))
    return {"train/step_time_s": float(per_rank[:, 0].max()),
            "train/label_tokens": int(per_rank[:, 2].sum()),
            "train/step_time_s_ranks": per_rank[:, 0].tolist(),
            "train/allreduce_s_ranks": per_rank[:, 1].tolist()}


class Profiler:
    """``--profile_steps``: a ``torch.profiler`` window over some steps,
    exported as a Chrome trace, its device and wall time per step
    returned for the metrics."""

    def __init__(self, trace_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.dir, self.device = Path(trace_dir), device
        if is_distributed():
            self.dir = self.dir / f"rank{rank()}"
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self, steps: int) -> dict:
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.dir / "trace.json"))
        return {"profile/steps": steps,
                "profile/wall_ms_per_step": wall * 1e3 / steps,
                "profile/device_ms_per_step":
                    device_time_ms(self.prof) / steps}


def main(argv=None):
    args = parse_args(argv)
    if args.streaming and args.preprocessing_only:
        raise ValueError("--preprocessing_only is incompatible with "
                         "--streaming: preparation happens on the fly "
                         "(reference run_distillation.py:1308-1313)")
    setup_logging()
    mesh = setup_data_parallel(args.distributed, args.device,
                               args.model_parallel, args.param_sharding)
    rules = param_rules(args)
    device = resolve_device(args.device)
    n_proc, rank_ = world_size(), rank()
    # which rows this rank feeds: its data coordinate among the data ranks
    # (the model ranks of a data group feed the same rows)
    d_idx, n_data, _, _ = coordinates(mesh)
    rng = np.random.default_rng(args.seed)

    frozen = []
    if args.freeze_encoder:
        frozen.append("encoder")
    if args.quantize_student != "none" and args.freeze_decoder:
        # the straight-through gradients have nowhere to go
        logger.warning("--quantize_student with --freeze_decoder: the frozen "
                       "decoder cannot adapt to the quantized numerics; this "
                       "is equivalent to serving-time PTQ (--quantize_decoder)")
    if args.freeze_decoder:
        # everything under decoder EXCEPT tok_emb (tied to the lm head)
        frozen += ["decoder.pos_emb", "decoder.layers", "decoder.ln"]
    elif args.freeze_embed_positions:
        frozen.append("decoder.pos_emb")
    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=args.max_steps, schedule=args.lr_scheduler_type,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        precision=args.precision, frozen_prefixes=tuple(frozen))
    dtype = opt_cfg.compute_dtype

    # the teacher is inference only: stored in the compute dtype (int8
    # weights are quantized from the fp32 checkpoint first)
    teacher, teacher_cfg = load_params(args.teacher_checkpoint, device=device)
    if args.teacher_precision != "train":
        # the kernel takes bf16 only: under --precision full the teacher
        # keeps the einsum encoder
        teacher_cfg = teacher_cfg.replace(
            fast_bf16_attention=True,
            use_flash_encoder=(args.precision != "full"))
        if args.teacher_precision == "int8":
            teacher = quantize_teacher_params(teacher)
    teacher = shard_params(to_compute_dtype(teacher, dtype), mesh, rules,
                           cfg=teacher_cfg)
    student, student_cfg = load_params(args.student_checkpoint, device=device)
    state = place_state(TrainState.create(student, opt_cfg), mesh, rules)
    del student
    tok = WhisperTokenizer.from_pretrained(args.teacher_checkpoint)
    normalizer = (EnglishTextNormalizer(tok.spelling_mapping)
                  if args.language in (None, "en", "english")
                  else BasicTextNormalizer())

    dcfg = DistillConfig(
        ce_weight=args.ce_weight, kl_weight=args.kl_weight,
        temperature=args.temperature, mse_weight=args.mse_weight,
        freeze_encoder=args.freeze_encoder,
        share_encoder=args.freeze_encoder,
        remat=args.gradient_checkpointing,
        loss_chunk_size=args.loss_chunk_size,
        quantize_student=args.quantize_student)
    train_step, eval_step = build_train_step(student_cfg, teacher_cfg, dcfg,
                                             opt_cfg, mesh=mesh)

    mgr = CheckpointManager(args.output_dir,
                            save_total_limit=args.save_total_limit,
                            best_total_limit=args.save_best_total_limit)
    start_step = 0
    if args.resume_from_checkpoint:
        resumed = mgr.resume_latest(state)
        if resumed is not None:
            start_step, state = resumed
            state = place_state(state, mesh)
            logger.info("resumed from step %d", start_step)

    train_ds = load_multiple_datasets(args.train_dataset_path,
                                      args.train_splits,
                                      args.dataset_probabilities,
                                      seed=args.seed)
    # Mask prompts with the tokenizer's <|startoftranscript|>: labels are
    # built from the tokenizer
    if tok.sot != teacher_cfg.decoder_start_token_id:
        logger.warning(
            "config decoder_start_token_id=%d != tokenizer <|startoftranscript|>"
            "=%d; using the tokenizer's id for prompt masking",
            teacher_cfg.decoder_start_token_id, tok.sot)
    collator = Collator(decoder_start_token_id=tok.sot,
                        pad_token_id=teacher_cfg.pad_token_id,
                        max_target_length=args.max_label_length)
    # each data rank feeds its own rows: the global batch is this times
    # the data axis
    bsz = args.per_device_train_batch_size

    cache_file = (Path(args.preprocessed_cache) / "train_samples.npy"
                  if args.preprocessed_cache else None)
    # with --streaming the stream starts below, after the eval set
    samples = None
    if not args.streaming:
        prep_sharded = False
        if (cache_file is not None and cache_file.exists()
                and not args.preprocessing_only):
            # a file this trainer wrote with --preprocessing_only
            samples = list(np.load(cache_file, allow_pickle=True))
            logger.info("loaded %d prepared samples from %s",
                        len(samples), cache_file)
        else:
            prep_ds = train_ds
            if n_data > 1 and not args.preprocessing_only:
                # shard BEFORE preparation (audio load, mel and the WER
                # filter are the start-up cost); the train loop cycles, so
                # unequal counts after filtering are fine
                prep_ds = shard_rows(train_ds, n_data, d_idx)
                prep_sharded = True
            samples = _prepare_samples(prep_ds, tok, teacher_cfg, args,
                                       normalizer, rng, device)
            if not samples:
                raise RuntimeError("no training samples after filtering")
            if cache_file is not None and rank_ == 0:
                cache_file.parent.mkdir(parents=True, exist_ok=True)
                np.save(cache_file, np.asarray(samples, dtype=object),
                        allow_pickle=True)
                logger.info("cached %d prepared samples at %s",
                            len(samples), cache_file)
        if args.preprocessing_only:
            logger.info("--preprocessing_only set: preprocessing finished, "
                        "skipping training")
            return str(cache_file) if cache_file else None
        if n_data > 1 and not prep_sharded:
            samples = samples[process_local_slice(len(samples), d_idx,
                                                  n_data)]
    eval_samples = None
    if args.eval_dataset_path:
        eval_ds = load_dataset_any(args.eval_dataset_path, "validation")
        eval_args = argparse.Namespace(**{**vars(args),
                                          "use_pseudo_labels": False,
                                          "wer_threshold": None,
                                          "condition_on_prev_probability": 0.0,
                                          "timestamp_probability": 0.0})
        eval_samples = _prepare_samples(eval_ds, tok, teacher_cfg, eval_args,
                                        normalizer, rng, device)
        if n_data > 1 and eval_samples:
            # every rank prepares the whole set and takes an EQUAL slice:
            # the eval runs collectives per batch, so every rank needs the
            # same number of batches (the counts are summed below)
            eval_samples = eval_samples[process_local_slice(
                len(eval_samples), d_idx, n_data)]
    stream = None
    if args.streaming:
        # rows are prepared on the fly by a producer thread; it starts only
        # now, so that its label draws from ``rng`` follow the eval set's
        # each rank streams its own contiguous shard: distinct shuffle
        # seeds alone would feed every rank the whole corpus
        stream = streaming_batches(
            shard_rows(train_ds, n_data, d_idx) if n_data > 1 else train_ds,
            prepare=lambda row: _prepare_row(row, tok, teacher_cfg, args,
                                             normalizer, rng, device),
            collate=collator, batch_size=bsz,
            shuffle_buffer_size=args.shuffle_buffer_size,
            seed=args.seed + d_idx, repeat=True, prefetch_depth=2)

    # SIGTERM/SIGINT request a checkpoint at the next step boundary, so a
    # preempted run resumes with --resume_from_checkpoint
    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        logger.warning("signal %d received: checkpointing at next step "
                       "boundary, then exiting", signum)
        stop_requested["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _request_stop)
        except ValueError:
            pass  # not the main thread (e.g. under a test runner)

    def stop_agreed(step: int) -> bool:
        """The stop request, agreed over the ranks at logging, eval, save
        and last-step boundaries only: a signal lands at another step on
        each rank, and ranks entering the save's barrier at different steps
        would hang; polling every step would put a host sync in the loop."""
        if n_proc == 1:
            return stop_requested["flag"]
        done = step + 1
        if (done % args.logging_steps and done % args.eval_steps
                and done % args.save_steps and done != args.max_steps):
            return False
        return any_over_ranks(stop_requested["flag"])

    order = rng.permutation(len(samples)) if samples else None
    cursor = 0
    best_wer = float("inf")
    metrics_log = MetricsLogger(
        str(Path(args.output_dir) / "metrics.jsonl"),
        report_to=tuple(s.strip() for s in args.report_to.split(",")),
        tensorboard_dir=args.tensorboard_dir,
        run_name=Path(args.output_dir).name)

    def next_indices():
        nonlocal order, cursor
        idx = []
        while len(idx) < bsz:
            if cursor >= len(order):
                order = rng.permutation(len(samples))
                cursor = 0
            idx.append(order[cursor])
            cursor += 1
        return idx

    def next_batch():
        if stream is not None:
            return next(stream)
        return collator([samples[i] for i in next_indices()])

    # a resumed run skips the batches the checkpoint has trained on
    for _ in range(start_step):
        if stream is not None:
            next(stream)
        else:
            next_indices()

    # the eval's decode as CUDA graphs on the card, for the whole run: the
    # optimizer writes the parameters in place, so one program serves
    # every eval
    eval_graphs = GraphOwner("eval")

    @torch.no_grad()
    def run_eval(step):
        nonlocal best_wer
        if not eval_samples:
            return
        opts = GenerationOptions.from_config(
            student_cfg, max_new_tokens=args.eval_max_new_tokens)
        prompt = tok.prompt_ids(language=args.language, task=args.task)
        ebsz = args.per_device_eval_batch_size
        refs, hyps, losses = [], [], []
        for i in range(0, len(eval_samples), ebsz):
            group = eval_samples[i:i + ebsz]
            n = len(group)
            batch = collator(group)
            if n < ebsz:   # a full batch, the last row repeated (as JAX)
                batch = {k: np.concatenate(
                    [v, np.repeat(v[-1:], ebsz - n, axis=0)])
                    for k, v in batch.items()}
            batch = to_device(batch, device)
            losses.append(float(eval_step(state.params, teacher,
                                          batch)["ce_loss"]))
            out = encode_and_generate(state.params, student_cfg,
                                      batch["input_features"],
                                      [prompt] * ebsz, opts, dtype=dtype,
                                      device=device, graphs=eval_graphs)
            seqs, lens = out.sequences.cpu().numpy(), out.seq_len.cpu().numpy()
            for j in range(n):
                hyps.append(normalizer(tok.decode(seqs[j][:lens[j]].tolist())))
                refs.append(normalizer(group[j]["text"]))
        pairs = [(r, h) for r, h in zip(refs, hyps) if r.strip()]
        stats = (process_words([r for r, _ in pairs], [h for _, h in pairs])
                 if pairs else WordErrors())
        if n_proc > 1:
            # the error counts summed over the ranks' slices; every rank
            # enters the collective, an empty slice too
            stats = summed_word_errors(stats, mesh=mesh)
        if not stats.num_ref_words:
            return      # a global decision: the same on every rank
        wer = 100 * stats.wer
        logger.info("eval @%d: ce=%.4f wer=%.2f%% (I=%d S=%d D=%d)",
                    step, np.mean(losses), wer, stats.insertions,
                    stats.substitutions, stats.deletions)
        metrics_log.log(step, {"eval/ce_loss": float(np.mean(losses)),
                               "eval/wer": wer,
                               "eval/insertions": stats.insertions,
                               "eval/substitutions": stats.substitutions,
                               "eval/deletions": stats.deletions})
        if rank_ == 0:
            pred_path = (Path(args.output_dir)
                         / f"eval_predictions-{step}.jsonl")
            with open(pred_path, "w") as f:
                for r, h in zip(refs, hyps):
                    f.write(json.dumps({"norm_ref": r, "norm_pred": h,
                                        "correct": r == h}) + "\n")
        if wer < best_wer:
            best_wer = wer
            mgr.save_best(step, state, wer)

    timer = StepTimer(device)
    profiler = None
    if device.type == "cuda":   # the steps' peak, not the loading's
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    for step in range(start_step, args.max_steps):
        if args.profile_steps:
            if step == start_step + 2:  # past the first steps' allocations
                profiler = Profiler(args.profile_dir or
                                    str(Path(args.output_dir) / "trace"),
                                    device)
            elif profiler and step == start_step + 2 + args.profile_steps:
                metrics_log.log(step, profiler.stop(args.profile_steps))
                profiler = None
        raw = next_batch()
        n_sup = int((raw["labels"] != -100).sum())
        # the first batch's check is agreed over the ranks: one rank
        # raising while the others enter the step's collectives would hang
        if step == start_step and not sum_over_ranks(np.asarray([n_sup]))[0]:
            raise RuntimeError(
                "first batch has zero supervised tokens: check that the "
                "checkpoint's special-token ids match its tokenizer")
        batch = to_device(raw, device)
        with timer:
            state, metrics = train_step(state, teacher, batch)
        if (step + 1) % args.logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            sps = (step + 1 - start_step) / (time.perf_counter() - t_start)
            logger.info("step %d: loss=%.4f ce=%.4f kl=%.4f gnorm=%.2f "
                        "(%.2f steps/s)", step + 1, m["loss"], m["ce_loss"],
                        m["kl_loss"], m["grad_norm"], sps)
            metrics_log.log(step + 1,
                            {**{f"train/{k}": v for k, v in m.items()},
                             "train/steps_per_second": sps,
                             **step_times(timer, train_step, n_sup, mesh),
                             **peak_memory(device)})
        if (step + 1) % args.eval_steps == 0:
            run_eval(step + 1)
        if (step + 1) % args.save_steps == 0:
            mgr.save(step + 1, state)
        if stop_agreed(step):
            mgr.save(step + 1, state, metadata={"preempted": True})
            logger.warning("preemption checkpoint written at step %d; "
                           "resume with --resume_from_checkpoint", step + 1)
            return None

    if profiler:
        metrics_log.log(args.max_steps,
                        profiler.stop(args.max_steps - start_step - 2))
    run_eval(args.max_steps)
    metrics_log.close()
    if args.max_steps % args.save_steps != 0:  # else just saved in the loop
        mgr.save(args.max_steps, state)
    final_dir = Path(args.output_dir) / "end-of-training-weights"
    if n_proc > 1:
        # the multi-process ending (JAX's): the last checkpoint is the
        # run's artifact, exported by the converter
        ckpt_dir = Path(args.output_dir) / f"checkpoint-{args.max_steps}"
        logger.info("multi-process run: convert the final checkpoint with "
                    "python -m distil_whisper_tpu_torch.cli."
                    "convert_checkpoint_to_hf --checkpoint_dir %s "
                    "--base_checkpoint %s --save_dir %s --distributed",
                    ckpt_dir, args.student_checkpoint, final_dir)
        return str(ckpt_dir)
    save_pretrained(to_fp32(state.params), student_cfg, str(final_dir))
    copy_tokenizer_files(args.teacher_checkpoint, str(final_dir))
    logger.info("final weights exported to %s (best val WER %.2f%%)",
                final_dir, best_wer)
    return str(final_dir)


if __name__ == "__main__":
    main()
