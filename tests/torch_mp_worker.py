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

    def recording(module, name, prefix):
        """Replace ``module.name`` (a step builder) by one whose train step
        saves every batch it takes, for the one-process replay."""
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

    original = recording(run_distillation, "build_train_step", "batch")
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
    original = recording(run_finetuning, "build_finetune_step", "ft-batch")
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


def main():
    mode, rank, world, port = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    mesh = _join(rank, world, port)
    if mode == "steps":
        steps(rank, world, mesh, *sys.argv[5:7])
    elif mode == "cli":
        cli(rank, world, *sys.argv[5:9])
    else:
        raise SystemExit(f"unknown mode {mode}")
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: {mode} OK", flush=True)


if __name__ == "__main__":
    main()
