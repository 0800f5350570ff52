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

The rank joins the job through the environment torchrun would set, as the
CLIs expect; the port alone is imported (no JAX).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np


def _join(rank, world, port):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    torch.set_num_threads(2)
    from distil_whisper_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed)
    assert maybe_initialize_distributed(force=True, device="cpu")
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


def main():
    mode, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    mesh = _join(rank, world, port)
    if mode == "steps":
        steps(rank, world, mesh, *sys.argv[5:7])
    elif mode == "cli":
        cli(rank, world, *sys.argv[5:9])
    elif mode == "tp":
        tp(rank, world, *sys.argv[5:11])
    else:
        raise SystemExit(f"unknown mode {mode}")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: {mode} OK", flush=True)


if __name__ == "__main__":
    main()
