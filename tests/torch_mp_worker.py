"""One rank of the port's two-process CPU tests (gloo).

Usage: python torch_mp_worker.py <mode> <rank> <world> <port> [args...]
Modes:
  steps  <inputs.npz> <out_dir>   the data-parallel distillation step, three
         steps a case (plain, w8a8 QAT, int8 teacher) on this rank's rows of
         each global batch; every rank writes its parameters after steps 1
         and 3 and its metrics
  cli    <teacher> <student> <data_dir> <out_dir>   the CLIs with
         --distributed: run_eval, run_pseudo_labelling, run_distillation,
         convert_checkpoint_to_hf and run_finetuning (each trainer step's
         batch recorded for a one-process replay)
  tp     <inputs.npz> <ckpt> <teacher> <student> <data_dir> <out_dir>
         tensor parallelism over four ranks: sharded greedy (with
         timestamps), int8 generation on a (2, 2) mesh and draft
         speculation on a (1, 4) mesh; the shard/gather round trip; the
         distillation step cases on the (2, 2) mesh (parameters gathered
         after each step), a checkpoint saved there; a step with dropout
         on the (1, 4) mesh against the unsharded step; the pipeline with
         mesh=; run_distillation --distributed --model_parallel 2
  fsdp   <inputs.npz> <ckpt> <teacher> <student> <data_dir> <out_dir>
         2-D (FSDP-style) sharding over four ranks on a (2, 2) mesh: each
         rank's shards of a placed state and the shard/gather round trip
         (float and int8), the degrees the model reads, the step cases
         under RULES_2D and under the 1-D rules, checkpoints crossing
         between 2-D, 1-D and one process, and run_distillation and
         run_finetuning --distributed --model_parallel 2 --param_sharding
         2d
  serve  <inputs.npz> <ckpt> <draft> <out_dir>   the serving schedulers on a
         (2, 2) mesh: the continuous engine (greedy, timestamped and
         staggered, 2 lanes a data rank; draft and n-gram speculation; a
         word-timestamp request beside the lanes), the micro-batch
         scheduler (with a sampled group), requests whose own options
         fail (an unknown language) in both schedulers and over HTTP,
         run_server --distributed over HTTP, and last a follower that
         fails

The rank joins the job through the environment torchrun would set, as the
CLIs expect; the port alone is imported (no JAX).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np


def _join(rank, world, port, timeout=None):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    torch.set_num_threads(2)
    from distil_whisper_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed)
    assert maybe_initialize_distributed(force=True, device="cpu",
                                        timeout=timeout)
    return make_mesh()


# the cases of the step test: (optimizer, distill config, int8 teacher)
STEP_CASES = {
    "plain": (dict(learning_rate=1e-3), {}, False),
    "w8a8": (dict(learning_rate=1e-4), dict(quantize_student="w8a8"), False),
    "int8_teacher": (dict(learning_rate=1e-3), {}, True),
}
BASE_OPT = dict(warmup_steps=1, total_steps=10, precision="full",
                frozen_prefixes=("encoder",))


def steps(rank, world, mesh, inputs, out):
    import torch
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import params_from_numpy
    from distil_whisper_tpu_torch.models.params import (tree_paths,
                                                        unflatten_paths)
    from distil_whisper_tpu_torch.ops.quant import quantize_teacher_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step,
        place_state)

    data = np.load(inputs)
    dims = json.loads(str(data["dims"]))
    cfg = WhisperConfig(**dims)
    scfg = cfg.replace(decoder_layers=int(data["student_layers"]))

    def tree(prefix):
        return params_from_numpy(unflatten_paths(
            {k[len(prefix):]: data[k] for k in data.files
             if k.startswith(prefix)}), "cpu", torch.float32)

    n_batches = int(data["n_batches"])
    for name, (opt_kw, dcfg_kw, int8) in STEP_CASES.items():
        teacher = tree("teacher/")
        if int8:
            teacher = quantize_teacher_params(teacher)
        opt = OptimizerConfig(**{**BASE_OPT, **opt_kw})
        state = place_state(TrainState.create(tree("student/"), opt), mesh)
        step, _ = build_train_step(scfg, cfg, DistillConfig(**dcfg_kw), opt,
                                   mesh=mesh)
        saved, metrics = {}, []
        for i in range(n_batches):
            rows = slice(int(data[f"split{i}"][rank]),
                         int(data[f"split{i}"][rank + 1]))
            batch = {k: torch.from_numpy(data[f"batch{i}/{k}"][rows])
                     for k in ("input_features", "decoder_input_ids",
                               "labels")}
            state, m = step(state, teacher, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if i in (0, n_batches - 1):
                saved.update({f"step{i + 1}/{p}": x.detach().numpy().copy()
                              for p, x in tree_paths(state.params).items()})
        np.savez(Path(out) / f"{name}-rank{rank}.npz", **saved)
        Path(out, f"{name}-rank{rank}.json").write_text(json.dumps(metrics))


def recording(module, name, out, prefix, rank):
    """Replace ``module.name`` (a step builder) by one whose train step
    saves every batch it takes, for the one-process replay; returns the
    original."""
    original = getattr(module, name)

    def build(*args, **kwargs):
        train_step, eval_step = original(*args, **kwargs)
        calls = []

        def recorded(*step_args, **step_kwargs):
            batch = step_args[-1]
            np.savez(out / f"{prefix}-rank{rank}-step{len(calls)}.npz",
                     **{k: v.numpy() for k, v in batch.items()})
            calls.append(1)
            return train_step(*step_args, **step_kwargs)

        recorded.data_parallel = train_step.data_parallel
        return recorded, eval_step

    setattr(module, name, build)
    return original


def cli(rank, world, teacher, student, data_dir, out):
    from distil_whisper_tpu_torch.cli import (convert_checkpoint_to_hf,
                                              run_distillation, run_eval,
                                              run_finetuning,
                                              run_pseudo_labelling)
    data_dir, out = Path(data_dir), Path(out)
    cpu = ["--device", "cpu", "--distributed"]
    run_eval.main(["--model_checkpoint", teacher,
                   "--dataset_path", str(data_dir / "eval.jsonl"),
                   "--mode", "short", "--language", "en",
                   "--batch_size", "2", "--max_new_tokens", "8",
                   "--dtype", "float32",
                   "--output_json", str(out / "eval" / "eval.json")] + cpu)
    run_pseudo_labelling.main([
        "--model_checkpoint", teacher,
        "--dataset_path", str(data_dir / "pl.jsonl"),
        "--output_dir", str(out / "pl"), "--per_device_batch_size", "2",
        "--language", "en", "--max_new_tokens", "8", "--dtype", "float32",
        "--speaker_id_column_name", "speaker_id", "--compute_wer"] + cpu)

    original = recording(run_distillation, "build_train_step", out, "batch",
                         rank)
    ckpt = run_distillation.main([
        "--teacher_checkpoint", teacher, "--student_checkpoint", student,
        "--train_dataset_path", str(data_dir / "train.jsonl"),
        "--eval_dataset_path", str(data_dir / "eval.jsonl"),
        "--output_dir", str(out / "distill"), "--max_steps", "3",
        "--per_device_train_batch_size", "2",
        "--per_device_eval_batch_size", "2", "--learning_rate", "1e-3",
        "--warmup_steps", "1", "--eval_steps", "3", "--save_steps", "2",
        "--logging_steps", "1", "--language", "en", "--precision", "full",
        "--eval_max_new_tokens", "8", "--max_label_length", "64",
        "--seed", "3"] + cpu)
    run_distillation.build_train_step = original
    convert_checkpoint_to_hf.main(["--checkpoint_dir", ckpt,
                                   "--base_checkpoint", student,
                                   "--save_dir", str(out / "hf")] + cpu)
    original = recording(run_finetuning, "build_finetune_step", out,
                         "ft-batch", rank)
    ft_ckpt = run_finetuning.main([
        "--model_checkpoint", student,
        "--train_dataset_path", str(data_dir / "train.jsonl"),
        "--output_dir", str(out / "finetune"), "--max_steps", "2",
        "--per_device_train_batch_size", "2", "--learning_rate", "1e-4",
        "--warmup_steps", "0", "--save_steps", "5", "--logging_steps", "1",
        "--language", "en", "--precision", "full",
        "--max_label_length", "64", "--seed", "5"] + cpu)
    run_finetuning.build_finetune_step = original
    Path(out, f"cli-rank{rank}.json").write_text(
        json.dumps({"ckpt": ckpt, "ft_ckpt": ft_ckpt}))


# the tensor-parallel job's step cases: the data-parallel ones and one
# whose gradients are clipped
TP_STEP_CASES = {**STEP_CASES,
                 "clipped": (dict(learning_rate=1e-3, max_grad_norm=1e-3),
                             {}, False)}
TP_STEPS = 2


def _tree(data, prefix):
    import torch
    from distil_whisper_tpu_torch.models import params_from_numpy
    from distil_whisper_tpu_torch.models.params import unflatten_paths
    return params_from_numpy(unflatten_paths(
        {k[len(prefix):]: data[k] for k in data.files
         if k.startswith(prefix)}), "cpu", torch.float32)


def tp(rank, world, inputs, ckpt, teacher_ck, student_ck, data_dir, out):
    import torch
    from distil_whisper_tpu_torch.cli import run_distillation
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                     encode_and_generate)
    from distil_whisper_tpu_torch.generation.speculative import \
        speculative_generate_batched
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.models.whisper import cross_kv, encode
    from distil_whisper_tpu_torch.ops.quant import (maybe_quantize_encoder,
                                                    quantize_teacher_params)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.parallel import make_mesh
    from distil_whisper_tpu_torch.parallel.mesh import (
        coordinates, gather_params, shard_params)
    from distil_whisper_tpu_torch.parallel.multihost import rank_generator
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.training import (
        CheckpointManager, DistillConfig, OptimizerConfig, TrainState,
        build_train_step, place_state)

    data = np.load(inputs)
    out = Path(out)
    mesh22, mesh14 = make_mesh((2, 2)), make_mesh((1, 4))
    d = coordinates(mesh22)[0]
    res, arrays = {}, {}

    # -- inference ---------------------------------------------------------
    icfg = WhisperConfig(**json.loads(str(data["inf_dims"])))
    full = _tree(data, "inf/")
    sharded = shard_params(full, mesh22, cfg=icfg)
    back = tree_paths(gather_params(sharded, mesh22))
    res["roundtrip_equal"] = all(torch.equal(back[p], x) for p, x in
                                 tree_paths(full).items())
    rows = slice(2 * d, 2 * d + 2)
    prompt = torch.full((2, 1), 3, dtype=torch.long)
    out_ts = encode_and_generate(
        sharded, icfg, torch.from_numpy(data["mel_ts"][rows]), prompt,
        GenerationOptions(max_new_tokens=12, return_timestamps=True,
                          max_initial_timestamp_index=50), device="cpu")
    arrays.update(ts_sequences=out_ts.sequences.numpy(),
                  ts_sum_logprobs=out_ts.sum_logprobs.numpy())

    qcfg = icfg.replace(quantize_encoder=True, quantize_decoder=True)
    q_full = maybe_quantize_encoder(_tree(data, "int8/"), qcfg)
    q_sharded = shard_params(q_full, mesh22, cfg=qcfg)
    # quantizing the shards gives the shards of the quantized tree
    q_of_shards = tree_paths(maybe_quantize_encoder(
        shard_params(_tree(data, "int8/"), mesh22), qcfg))
    res["int8_quantize_shards_equal"] = all(
        torch.equal(q_of_shards[p], x) and q_of_shards[p].stride() ==
        x.stride() for p, x in tree_paths(q_sharded).items())
    out8 = encode_and_generate(
        q_sharded, qcfg, torch.from_numpy(data["mel_int8"][rows]), prompt,
        GenerationOptions(max_new_tokens=10), device="cpu")
    arrays["int8_sequences"] = out8.sequences.numpy()

    dcfg = icfg.replace(decoder_layers=1)
    t = shard_params(_tree(data, "spec_t/"), mesh14, cfg=icfg)
    dr = shard_params(_tree(data, "spec_d/"), mesh14, cfg=dcfg)
    mel1 = torch.from_numpy(data["mel_spec"])
    enc = encode(t["encoder"], icfg, mel1)
    spec = speculative_generate_batched(
        t["decoder"], icfg, dr["decoder"], dcfg,
        cross_kv(t["decoder"], icfg, enc), cross_kv(dr["decoder"], dcfg, enc),
        torch.full((1, 1), 3, dtype=torch.long),
        GenerationOptions(max_new_tokens=16), gamma=3)
    arrays["spec_sequences"] = spec.sequences.numpy()

    # -- the step ----------------------------------------------------------
    cfg = WhisperConfig(**json.loads(str(data["dims"])))
    scfg = cfg.replace(decoder_layers=int(data["student_layers"]))
    for name, (opt_kw, dcfg_kw, int8) in TP_STEP_CASES.items():
        teacher = _tree(data, "teacher/")
        if int8:
            teacher = quantize_teacher_params(teacher)
        teacher = shard_params(teacher, mesh22, cfg=cfg)
        opt = OptimizerConfig(**{**BASE_OPT, **opt_kw})
        state = place_state(TrainState.create(_tree(data, "student/"), opt),
                            mesh22)
        step, _ = build_train_step(scfg, cfg, DistillConfig(**dcfg_kw), opt,
                                   mesh=mesh22)
        saved, metrics = {}, []
        for i in range(TP_STEPS):
            split = data[f"split{i}"]
            rows = slice(int(split[d]), int(split[d + 1]))
            batch = {k: torch.from_numpy(data[f"batch{i}/{k}"][rows])
                     for k in ("input_features", "decoder_input_ids",
                               "labels")}
            state, m = step(state, teacher, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            saved.update({f"step{i + 1}/{p}": x.numpy().copy() for p, x in
                          state.state_dict()["params"].items()})
            if name == "plain" and i == 0:
                CheckpointManager(ckpt).save(1, state)
        np.savez(out / f"tp-{name}-rank{rank}.npz", **saved)
        Path(out, f"tp-{name}-rank{rank}.json").write_text(
            json.dumps(metrics))

    # -- dropout -----------------------------------------------------------
    # the student's dropout on, encoder unfrozen, at (1, 4): one step
    # equals the unsharded step under the same seed (the model group draws
    # the unsharded masks and each rank keeps its slice); the generators
    # of the (2, 2) mesh follow the data coordinate
    res["generator_draws"] = torch.rand(
        3, generator=rank_generator(5, mesh=mesh22)).tolist()
    cfg4 = cfg.replace(encoder_attention_heads=4, decoder_attention_heads=4)
    scfg4 = cfg4.replace(decoder_layers=2, dropout=0.1,
                         attention_dropout=0.1, activation_dropout=0.1)
    teacher4 = init_params(cfg4, seed=0, device="cpu")
    student4 = init_params(scfg4, seed=1, device="cpu")
    # no warmup: the one step moves the parameters
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                          precision="full")
    batch = {k: torch.from_numpy(data[f"batch0/{k}"])
             for k in ("input_features", "decoder_input_ids", "labels")}
    dropout_cfg = DistillConfig(freeze_encoder=False)
    after = {}
    for name, mesh, gen in (("tp4", mesh14, True), ("tp1", None, True),
                            ("tp1_no_dropout", None, False)):
        state = place_state(TrainState.create(student4, opt), mesh)
        step, _ = build_train_step(scfg4, cfg4, dropout_cfg, opt, mesh=mesh)
        state, _ = step(state, shard_params(teacher4, mesh, cfg=cfg4), batch,
                        rank_generator(7, mesh=mesh14) if gen else None)
        after[name] = state.state_dict()["params"]

    def max_diff(a, b):
        return max(float((a[p] - b[p]).abs().max()) for p in a)

    res["dropout_tp4_vs_tp1"] = max_diff(after["tp4"], after["tp1"])
    res["dropout_effect"] = max_diff(after["tp1"], after["tp1_no_dropout"])

    # -- the pipeline ------------------------------------------------------
    pipe = WhisperPipeline(teacher_ck, dtype=torch.float32, device="cpu",
                           mesh=mesh22)
    audios = [data[f"audio{j}"] for j in range(3)]
    res["pipeline"] = [r["text"] for r in pipe(audios, language="en",
                                               max_new_tokens=8)]
    words = pipe(audios[0], language="en", max_new_tokens=8,
                 return_timestamps="word")
    res["pipeline_words"] = [[c["text"], list(c["timestamp"])]
                             for c in words["chunks"]]

    # -- the CLI -----------------------------------------------------------
    original = recording(run_distillation, "build_train_step", out,
                         "tp-batch", rank)
    res["cli_ckpt"] = run_distillation.main([
        "--teacher_checkpoint", teacher_ck, "--student_checkpoint",
        student_ck, "--train_dataset_path", str(Path(data_dir) / "train.jsonl"),
        "--eval_dataset_path", str(Path(data_dir) / "eval.jsonl"),
        "--output_dir", str(out / "tp-distill"), "--max_steps", "2",
        "--per_device_train_batch_size", "2",
        "--per_device_eval_batch_size", "2", "--learning_rate", "1e-3",
        "--warmup_steps", "1", "--eval_steps", "2", "--save_steps", "2",
        "--logging_steps", "1", "--language", "en", "--precision", "full",
        "--eval_max_new_tokens", "8", "--max_label_length", "64",
        "--seed", "3", "--device", "cpu", "--distributed",
        "--model_parallel", "2"])
    run_distillation.build_train_step = original
    np.savez(out / f"tp-rank{rank}.npz", **arrays)
    Path(out, f"tp-rank{rank}.json").write_text(json.dumps(res))


# the 2-D job's step cases: (optimizer, distill config, int8 teacher,
# finetune step); the first two train the whole model with gradient
# accumulation and clipping on
FSDP_TRAIN = dict(learning_rate=1e-3, gradient_accumulation_steps=2,
                  max_grad_norm=0.5, frozen_prefixes=())
FSDP_CASES = {
    "distill": (FSDP_TRAIN, dict(freeze_encoder=False), False, False),
    "finetune": (FSDP_TRAIN, {}, False, True),
    "int8_teacher": (dict(learning_rate=1e-3), {}, True, False),
    "qat": (dict(learning_rate=1e-4), dict(quantize_student="w8a8"), False,
            False),
}
FSDP_MICRO = {"distill": 4, "finetune": 4, "int8_teacher": 2, "qat": 2}


def _local_batch(data, i, d):
    import torch
    split = data[f"split{i}"]
    rows = slice(int(split[d]), int(split[d + 1]))
    return {k: torch.from_numpy(data[f"batch{i}/{k}"][rows])
            for k in ("input_features", "decoder_input_ids", "labels")}


def fsdp(rank, world, inputs, ckpt, teacher_ck, student_ck, data_dir, out):
    import torch
    from distil_whisper_tpu_torch.cli import run_distillation, run_finetuning
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.ops.quant import (maybe_quantize_encoder,
                                                    quantize_teacher_params)
    from distil_whisper_tpu_torch.parallel import RULES_2D, fsdp as F
    from distil_whisper_tpu_torch.parallel import make_mesh
    from distil_whisper_tpu_torch.parallel import tensor_parallel as T
    from distil_whisper_tpu_torch.parallel.mesh import (
        DEFAULT_RULES, coordinates, gather_params, shard_params)
    from distil_whisper_tpu_torch.training import (
        CheckpointManager, DistillConfig, OptimizerConfig, TrainState,
        build_finetune_step, build_train_step, place_state)

    data = np.load(inputs)
    out, ckpt = Path(out), Path(ckpt)
    mesh = make_mesh((2, 2))
    d = coordinates(mesh)[0]
    cfg = WhisperConfig(**json.loads(str(data["dims"])))
    scfg = cfg.replace(decoder_layers=int(data["student_layers"]))
    res, arrays = {}, {}

    # -- placement ---------------------------------------------------------
    student = _tree(data, "student/")
    s2 = shard_params(student, mesh, RULES_2D, cfg=scfg)
    back = tree_paths(gather_params(s2, mesh, RULES_2D))
    res["roundtrip_equal"] = all(torch.equal(back[p], x) for p, x in
                                 tree_paths(student).items())
    q_full = maybe_quantize_encoder(_tree(data, "teacher/"), cfg.replace(
        quantize_encoder=True, quantize_decoder=True))
    q2 = shard_params(q_full, mesh, RULES_2D, cfg=cfg)
    qback = tree_paths(gather_params(q2, mesh, RULES_2D))
    res["int8_roundtrip_equal"] = all(
        torch.equal(qback[p], x) and qback[p].stride() == x.stride()
        for p, x in tree_paths(q_full).items())
    q = s2["decoder"]["layers"]["self_attn"]["q"]["kernel"]
    res["degrees"] = [T.degree({"kernel": q}, scfg.d_model),
                      F.degree(q, scfg.d_model),
                      q.shape[-2] // q.shape[-1]]
    opt = OptimizerConfig(**{**BASE_OPT, **FSDP_TRAIN})
    state = place_state(TrainState.create(student, opt), mesh, RULES_2D)
    step, _ = build_train_step(scfg, cfg, DistillConfig(freeze_encoder=False),
                               opt, mesh=mesh)
    state, _ = step(state, _tree(data, "teacher/"), _local_batch(data, 0, d))
    for name in ("params", "mu", "nu", "acc"):
        tree = (tree_paths(state.params) if name == "params"
                else getattr(state, name))
        arrays.update({f"place/{name}/{p}": x.detach().numpy().copy()
                       for p, x in tree.items()})

    # -- the steps, 2-D and 1-D --------------------------------------------
    def run(name, rules, resume=None, save=None, start=0):
        opt_kw, dcfg_kw, int8, finetune = FSDP_CASES[name]
        opt = OptimizerConfig(**{**BASE_OPT, **opt_kw})
        teacher = _tree(data, "teacher/")
        if int8:
            teacher = quantize_teacher_params(teacher)
        teacher = shard_params(teacher, mesh, rules, cfg=cfg)
        state = place_state(TrainState.create(_tree(data, "student/"), opt),
                            mesh, rules)
        if resume is not None:
            state = CheckpointManager(str(resume)).restore(
                str(resume / "checkpoint-2"), state)
            state = place_state(state, mesh)
        if finetune:
            step, _ = build_finetune_step(scfg, opt, mesh=mesh)
        else:
            step, _ = build_train_step(scfg, cfg, DistillConfig(**dcfg_kw),
                                       opt, mesh=mesh)
        saved, metrics = {}, []
        for i in range(start, FSDP_MICRO[name]):
            batch = _local_batch(data, i, d)
            state, m = (step(state, batch) if finetune
                        else step(state, teacher, batch))
            metrics.append({k: float(v) for k, v in m.items()})
            sd = state.state_dict()
            for part in ("params", "mu", "nu"):
                saved.update({f"step{i + 1}/{part}/{p}": x.numpy().copy()
                              for p, x in sd[part].items()})
            if save is not None and i == 1:
                CheckpointManager(str(save)).save(2, state)
        return saved, metrics

    for name in FSDP_CASES:
        for tag, rules in (("2d", RULES_2D), ("1d", DEFAULT_RULES)):
            save = ckpt / tag if name == "distill" else None
            saved, metrics = run(name, rules, save=save)
            np.savez(out / f"fsdp-{name}-{tag}-rank{rank}.npz", **saved)
            Path(out, f"fsdp-{name}-{tag}-rank{rank}.json").write_text(
                json.dumps(metrics))
    # checkpoints across topologies: 2-D written, resumed at 1-D; 1-D
    # written, resumed at 2-D; each continues to the end
    for tag, rules, src in (("2d_at_1d", DEFAULT_RULES, "2d"),
                            ("1d_at_2d", RULES_2D, "1d")):
        saved, _ = run("distill", rules, resume=ckpt / src, start=2)
        np.savez(out / f"fsdp-resume-{tag}-rank{rank}.npz", **saved)

    # -- the CLIs ----------------------------------------------------------
    flags = ["--device", "cpu", "--distributed", "--model_parallel", "2",
             "--param_sharding", "2d", "--language", "en", "--precision",
             "full", "--max_label_length", "64", "--logging_steps", "1",
             "--per_device_train_batch_size", "2"]
    original = recording(run_distillation, "build_train_step", out,
                         "fsdp-batch", rank)
    res["cli_ckpt"] = run_distillation.main([
        "--teacher_checkpoint", teacher_ck, "--student_checkpoint",
        student_ck, "--train_dataset_path", str(Path(data_dir) / "train.jsonl"),
        "--output_dir", str(out / "fsdp-distill"), "--max_steps", "2",
        "--learning_rate", "1e-3", "--warmup_steps", "1", "--save_steps", "2",
        "--seed", "3"] + flags)
    run_distillation.build_train_step = original
    original = recording(run_finetuning, "build_finetune_step", out,
                         "fsdp-ft-batch", rank)
    res["ft_ckpt"] = run_finetuning.main([
        "--model_checkpoint", student_ck,
        "--train_dataset_path", str(Path(data_dir) / "train.jsonl"),
        "--output_dir", str(out / "fsdp-finetune"), "--max_steps", "2",
        "--learning_rate", "1e-4", "--warmup_steps", "0", "--save_steps", "5",
        "--seed", "5"] + flags)
    run_finetuning.build_finetune_step = original
    np.savez(out / f"fsdp-rank{rank}.npz", **arrays)
    Path(out, f"fsdp-rank{rank}.json").write_text(json.dumps(res))


def _submit_all(tr, cases, stagger=0.05, timeout=600):
    """Each case from its own thread, arrivals staggered (the serving
    tests' pattern); the results in order, the first error raised."""
    import threading
    import time
    results, errors = [None] * len(cases), []

    def post(i, c):
        kw = {k: v for k, v in c.items() if k != "wav"}
        try:
            results[i] = tr.submit(c["wav"], timeout=timeout, **kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = []
    for i, c in enumerate(cases):
        th = threading.Thread(target=post, args=(i, c))
        th.start()
        threads.append(th)
        time.sleep(stagger * (i % 4))
    for th in threads:
        th.join(timeout=timeout)
    if errors:
        raise errors[0]
    return results


def _error_of(fn):
    """The error ``fn()`` raises, as text ("no error" if none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — recorded
        return f"{type(e).__name__}: {e}"
    return "no error"


def sampled_requests(wavs):
    """One sampled micro-batch group: temperature 1, seed 5, English."""
    from distil_whisper_tpu_torch.serving import _Request
    return [_Request(w, "en", "transcribe", False, temperature=1.0, seed=5)
            for w in wavs]


def serve(rank, world, inputs, ckpt, draft_ck, out):
    """The ``serve`` mode; ends the process itself (its last phase breaks
    the process group on purpose)."""
    import time
    import urllib.error
    import urllib.request
    import threading
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli import run_server
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.parallel import make_mesh
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber, _Request
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber
    import torch

    data = np.load(inputs)
    out = Path(out)
    n = int(data["n_cases"])
    cases = [dict(wav=data[f"wav{i}"], language=str(data[f"language{i}"]),
                  return_timestamps=bool(data[f"ts{i}"]),
                  max_new_tokens=int(data[f"budget{i}"])) for i in range(n)]
    words_case = dict(wav=data["words_wav"], language="en",
                      return_timestamps="word", max_new_tokens=10)
    mesh = make_mesh((2, 2))
    pipe = WhisperPipeline(ckpt, dtype=torch.float32, batch_size=2,
                           max_new_tokens=10, device="cpu", mesh=mesh)
    draft = load_params(draft_ck, dtype=torch.float32, device="cpu")
    res = {}

    def engine(name, cases, **kw):
        tr = ContinuousTranscriber(pipe, batch_size=4, max_new_tokens=10,
                                   block_steps=3, **kw)
        if not tr.leader:
            tr.follow()
            return
        tr.start()
        try:
            res[name] = _submit_all(tr, cases)
            res[f"{name}_stats"] = dict(tr.stats)
        finally:
            tr.stop()

    engine("greedy", cases + [words_case])
    engine("draft", cases, assistant=draft, gamma=2)
    engine("ngram", cases, ngram_speculative=True, gamma=2)
    tr = BatchingTranscriber(pipe, batch_size=4, max_new_tokens=10,
                             max_wait_ms=200)
    if tr.leader:
        tr.start()
        try:
            res["microbatch"] = _submit_all(tr, cases)
            res["microbatch_stats"] = dict(tr.stats)
            # a request's own error: refused at submission, or (past the
            # check) failed alike on every rank; the next request serves
            res["mb_bad_submit"] = _error_of(
                lambda: tr.submit(cases[0]["wav"], language="xx"))
            bad = _Request(cases[0]["wav"], "xx", "transcribe", False)
            tr._enqueue(bad)
            bad.done.wait(600)
            res["mb_bad_inside"] = bad.error
            res["mb_after_bad"] = tr.submit(cases[0]["wav"], language="en",
                                            max_new_tokens=10, timeout=600)
            # a sampled group, its rows in a fixed order
            group = sampled_requests([c["wav"] for c in cases[:4]])
            tr._publish_dispatch(group)
            res["sampled"] = [r.result["text"] for r in group]
        finally:
            tr.stop()
    else:
        tr.follow()

    # the engine's fallback thread: a request's error inside a published
    # call fails it on every rank, and the engine goes on serving
    tr = ContinuousTranscriber(pipe, batch_size=4, max_new_tokens=10,
                               block_steps=3)
    if tr.leader:
        tr.start()
        try:
            bad = tr._make_request(cases[0]["wav"], "en", "transcribe", False,
                                   10, "sequential", 1, 0.0, 0, None)
            bad.language = "xx"
            tr._enqueue(bad)
            bad.done.wait(600)
            res["engine_bad_inside"] = bad.error
            res["engine_after_bad"] = tr.submit(
                cases[0]["wav"], language="en", max_new_tokens=10,
                timeout=600)
        finally:
            tr.stop()
    else:
        tr.follow()

    # run_server --distributed: rank 0 binds, the others follow
    httpd, tr = run_server.build_server([
        "--model_checkpoint", ckpt, "--device", "cpu", "--dtype", "float32",
        "--host", "127.0.0.1", "--port", "0", "--distributed",
        "--model_parallel", "2", "--scheduler", "continuous",
        "--batch_size", "4", "--block_steps", "3", "--max_new_tokens", "10"])
    if httpd is None:
        tr.follow()
    else:
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            wav = out / "http.wav"
            write_wav(str(wav), cases[0]["wav"], 16000, float32=True)
            port = httpd.server_address[1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/transcribe?language=xx",
                data=wav.read_bytes(), method="POST")
            try:
                urllib.request.urlopen(req, timeout=600)
                res["http_bad"] = {"status": 200}
            except urllib.error.HTTPError as e:
                res["http_bad"] = {"status": e.code,
                                   "error": json.loads(e.read())["error"]}
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/transcribe?language=en"
                "&max_tokens=10", data=wav.read_bytes(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                res["http"] = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            tr.stop()

    # last: a follower fails in a step block
    tr = ContinuousTranscriber(pipe, batch_size=4, max_new_tokens=10,
                               block_steps=3)
    if rank == world - 1:
        def boom(*a, **k):
            raise RuntimeError("injected follower failure")
        tr._stream.handlers["step"] = boom
    if tr.leader:
        tr.start()
        t0 = time.monotonic()
        try:
            tr.submit(cases[0]["wav"], language="en", timeout=600)
            res["failure"] = "no error"
        except RuntimeError as e:
            res["failure"] = str(e)
        res["failure_s"] = time.monotonic() - t0
        try:
            tr.submit(cases[0]["wav"], language="en", timeout=600)
            res["refused"] = "no error"
        except RuntimeError as e:
            res["refused"] = str(e)
        tr.stop()
    else:
        try:
            tr.follow()
            res["follower"] = "stopped"
        except Exception as e:  # noqa: BLE001 — recorded
            res["follower"] = f"{type(e).__name__}: {e}"
    Path(out, f"serve-rank{rank}.json").write_text(json.dumps(res))
    print(f"rank {rank}: serve OK", flush=True)
    sys.stdout.flush()
    os._exit(0)


def main():
    mode, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    # the serving job's collectives give up after a minute: its last phase
    # makes a follower fail
    mesh = _join(rank, world, port, timeout=60 if mode == "serve" else None)
    if mode == "steps":
        steps(rank, world, mesh, *sys.argv[5:7])
    elif mode == "cli":
        cli(rank, world, *sys.argv[5:9])
    elif mode == "tp":
        tp(rank, world, *sys.argv[5:11])
    elif mode == "fsdp":
        fsdp(rank, world, *sys.argv[5:11])
    elif mode == "serve":
        serve(rank, world, *sys.argv[5:9])
    else:
        raise SystemExit(f"unknown mode {mode}")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: {mode} OK", flush=True)


if __name__ == "__main__":
    main()
