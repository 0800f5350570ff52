"""The port's data-parallel paths over two gloo ranks on the CPU
(tests/torch_mp_worker.py, one process a rank), against the JAX package.

- The data-parallel distillation step, plain, QAT (w8a8) and with the int8
  teacher, three steps on global batches whose halves hold different
  label-token counts, equals JAX's ``build_train_step`` on a (2, 1) mesh of
  two CPU devices fed the whole global batch: parameter deltas after steps
  1 and 3 at 1e-5, metrics at 1e-5 relative (the int8 teacher's at 1e-4,
  the int8 lane's tolerance); both ranks hold the same parameters.
- ``run_eval --distributed``: each rank's shard, the counts summed, so both
  ranks report JAX's single-process WER; the ``-{rank}`` files hold JAX's
  predictions in order.
- ``run_pseudo_labelling --distributed``: each rank's manifest and CSV hold
  the contiguous shard of the speaker-sorted rows (``shard_rows``) under
  the ``-{rank}`` suffixes, and concatenated they equal the port's
  one-process run (rows, audio, transcripts, conditioning).
- ``run_distillation --distributed``: its metrics.jsonl losses equal a
  one-process replay of the two ranks' recorded batches, concatenated,
  through the port's step at 1e-4 (JAX's two-process driver,
  tests/mp_worker.py, takes minutes to compile per process, so the port's
  own step, held against JAX above, is the reference); the converter's
  rank 0 export equals the last checkpoint's parameters.
- ``run_finetuning --distributed``: its losses equal the replay likewise.
- ``dryrun_multigpu(2)``.

Ranks write to files, not pipes, and are killed on the way out.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import jax_init_params, to_numpy_tree
from distil_whisper_tpu import training as J
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models import param_axes as j_param_axes
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu.parallel import make_mesh as j_make_mesh
from distil_whisper_tpu.parallel import replicated as j_replicated
from distil_whisper_tpu.parallel import shard_batch as j_shard_batch
from distil_whisper_tpu.parallel import shard_params as j_shard_params
from distil_whisper_tpu.parallel import shardings_for_tree as j_shardings

HERE = Path(__file__).parent
WORKER = HERE / "torch_mp_worker.py"
sys.path.insert(0, str(HERE))
from torch_mp_worker import BASE_OPT, STEP_CASES  # noqa: E402

DIMS = dict(vocab_size=512, num_mel_bins=8, d_model=32, encoder_layers=2,
            decoder_layers=4, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_source_positions=16,
            max_target_positions=32)
JCFG = JConfig(**DIMS)
N_BATCHES = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode, *args, timeout=240):
    """Both ranks of ``mode``; returns their logs.  Fails with the logs when
    a rank fails or outlives ``timeout``."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent), str(HERE), os.environ.get("PYTHONPATH", "")])}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    logs = [tempfile.NamedTemporaryFile("w+", suffix=f"-rank{r}.log",
                                        delete=False) for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), "2", str(port),
         *map(str, args)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.flush()
        outs.append(Path(f.name).read_text())
        f.close()
        os.unlink(f.name)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


# -- the step --------------------------------------------------------------

def global_batch(seed):
    """4 rows, 10 tokens; rank 0's half (rows 0-1) holds far fewer label
    tokens than rank 1's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 512, (4, 10))
    labels[:, :3] = -100
    labels[0, 4:] = -100
    labels[1, -3:] = -100
    return {"input_features":
            rng.standard_normal((4, 8, 32)).astype(np.float32),
            "decoder_input_ids":
            rng.integers(0, 512, (4, 10)).astype(np.int32),
            "labels": labels.astype(np.int32)}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_steps")
    teacher = jax_init_params(JCFG, 0)
    student, scfg = J.init_student_from_teacher(teacher, JCFG,
                                                decoder_layers=2)
    student = jax.tree.map(jnp.asarray, to_numpy_tree(student))
    batches = [global_batch(s) for s in range(N_BATCHES)]
    arrays = {"dims": json.dumps(DIMS), "student_layers": 2,
              "n_batches": N_BATCHES}
    for prefix, tree in (("teacher/", teacher), ("student/", student)):
        arrays.update({prefix + p: np.asarray(x) for p, x in
                       j_tree_paths(to_numpy_tree(tree)).items()})
    for i, b in enumerate(batches):
        arrays[f"split{i}"] = np.asarray([0, 2, 4])
        arrays.update({f"batch{i}/{k}": v for k, v in b.items()})
    np.savez(tmp / "inputs.npz", **arrays)
    spawn("steps", tmp / "inputs.npz", tmp)
    return {"tmp": tmp, "teacher": teacher, "student": student,
            "scfg": scfg, "batches": batches}


def jax_sharded_run(m, opt_kw, dcfg_kw, int8):
    """JAX's step on a (2, 1) mesh of two CPU devices, the global batch
    sharded over 'data', parameters replicated."""
    from distil_whisper_tpu.ops.quant import (quantize_decoder_params,
                                              quantize_encoder_params)
    mesh = j_make_mesh((2, 1), devices=jax.devices()[:2])
    teacher = m["teacher"]
    if int8:   # eager, as the port's (XLA may turn /127 into a product)
        teacher = {**teacher,
                   "encoder": quantize_encoder_params(teacher["encoder"]),
                   "decoder": quantize_decoder_params(teacher["decoder"])}
    teacher = jax.tree.map(lambda x: jax.device_put(x, j_replicated(mesh)),
                           teacher)
    s_axes = j_param_axes(m["scfg"])
    student = j_shard_params(m["student"], s_axes, mesh)
    opt = J.OptimizerConfig(**{**BASE_OPT, **opt_kw})
    tx = J.make_optimizer(opt, student)
    state, tx = J.TrainState.create(student, opt, tx)
    state = J.place_state(state, tx, mesh, j_shardings(s_axes, mesh))
    step, _ = J.build_train_step(m["scfg"], JCFG, J.DistillConfig(**dcfg_kw),
                                 opt, tx)
    step = jax.jit(step)
    trees, metrics = {}, []
    for i, b in enumerate(m["batches"]):
        state, mt = step(state, teacher,
                         j_shard_batch(jax.tree.map(jnp.asarray, b), mesh))
        metrics.append({k: float(v) for k, v in mt.items()})
        if i in (0, N_BATCHES - 1):
            trees[i + 1] = j_tree_paths(to_numpy_tree(state.params))
    return trees, metrics


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_data_parallel_step_matches_jax_sharded_step(step_runs, name):
    opt_kw, dcfg_kw, int8 = STEP_CASES[name]
    j_trees, j_metrics = jax_sharded_run(step_runs, opt_kw, dcfg_kw, int8)
    tmp = step_runs["tmp"]
    ranks = [np.load(tmp / f"{name}-rank{r}.npz") for r in range(2)]
    init = {p: np.asarray(x, np.float32) for p, x in
            j_tree_paths(to_numpy_tree(step_runs["student"])).items()}
    for step in (1, N_BATCHES):
        for p in init:
            ours = ranks[0][f"step{step}/{p}"]
            np.testing.assert_array_equal(ranks[1][f"step{step}/{p}"], ours,
                                          err_msg=f"replicas differ at {p}")
            np.testing.assert_allclose(
                ours - init[p], np.asarray(j_trees[step][p], np.float32)
                - init[p], atol=1e-5, rtol=0, err_msg=f"step {step}: {p}")
    metrics = [json.loads((tmp / f"{name}-rank{r}.json").read_text())
               for r in range(2)]
    assert metrics[0] == metrics[1]
    rtol, atol = (1e-4, 1e-5) if int8 else (1e-5, 1e-6)
    for jm, tm in zip(j_metrics, metrics[0]):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=atol,
                                       err_msg=k)


# -- the CLIs --------------------------------------------------------------

TEXTS = ["the cat sat", "a dog ran fast", "hello world now", "we are here",
         "it is late", "go home soon", "stars shine bright", "rain falls"]


def _tone(seconds, i, rng):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * (200 + 40 * i) * t)
            + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli import create_student_model
    root = tmp_path_factory.mktemp("dp_cli")
    data = root / "data"
    data.mkdir()
    teacher = make_tiny_checkpoint(root / "teacher", encoder_layers=2,
                                   decoder_layers=4)
    student = str(root / "student")
    create_student_model.main(["--teacher_checkpoint", teacher,
                               "--save_dir", student, "--decoder_layers", "2",
                               "--device", "cpu"])
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        secs = 1.5 + 0.5 * (i % 4)
        write_wav(str(data / f"{i}.wav"), _tone(secs, i, rng), 16000)
        stamp = "<|0.00|>" if i % 2 else "<|notimestamps|>"
        end = f"<|{secs:.2f}|>" if i % 2 else ""
        rows.append({"audio": str(data / f"{i}.wav"), "text": text,
                     # two speakers, three rows each in the PL manifest, so
                     # the ranks' contiguous shards split at the speaker
                     # change, where packing restarts anyway
                     "speaker_id": "b" if i < 3 else "a",
                     "whisper_transcript": "<|startoftranscript|><|en|>"
                     f"<|transcribe|>{stamp} {text}{end}<|endoftext|>"})
    for name, sel in (("train", rows), ("eval", rows[:4]),
                      ("pl", rows[:6])):
        (data / f"{name}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in sel))
    out = root / "out"
    spawn("cli", teacher, student, data, out)
    return {"root": root, "data": data, "teacher": teacher,
            "student": student, "out": out, "rows": rows}


def test_run_eval_distributed_sums_to_jax_wer(cli_runs):
    from distil_whisper_tpu.cli.run_eval import main as j_eval
    ref_path = cli_runs["root"] / "jax_eval.json"
    j_eval(["--model_checkpoint", cli_runs["teacher"],
            "--dataset_path", str(cli_runs["data"] / "eval.jsonl"),
            "--mode", "short", "--language", "en", "--batch_size", "2",
            "--max_new_tokens", "8", "--dtype", "float32",
            "--output_json", str(ref_path)])
    ref = json.loads(ref_path.read_text())
    ranks = [json.loads((cli_runs["out"] / "eval" / f"eval-{r}.json")
                        .read_text()) for r in range(2)]
    assert not (cli_runs["out"] / "eval" / "eval.json").exists()
    for key in ("wer", "ier", "ser", "der", "repeated_5grams"):
        assert ranks[0][key] == ranks[1][key] == ref[key], key
    assert ranks[0]["predictions"] + ranks[1]["predictions"] == \
        ref["predictions"]
    assert [r["num_samples"] for r in ranks] == [2, 2]


def _pl_rows(path):
    from distil_whisper_tpu_torch.audio.io import load_audio
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    return [{**r, "audio": load_audio(r["audio"], 16000).tolist()}
            for r in rows]


def test_run_pseudo_labelling_distributed_shards(cli_runs):
    """Rank r labels shard r of the speaker-sorted rows; concatenated, the
    ranks' rows equal one process's, and the summed WER counts its."""
    from distil_whisper_tpu_torch.cli import run_pseudo_labelling
    from distil_whisper_tpu_torch.cli.common import (load_dataset_any,
                                                     shard_rows, sort_rows)
    pl, single = cli_runs["out"] / "pl", cli_runs["root"] / "pl_single"
    run_pseudo_labelling.main([
        "--model_checkpoint", cli_runs["teacher"],
        "--dataset_path", str(cli_runs["data"] / "pl.jsonl"),
        "--output_dir", str(single), "--per_device_batch_size", "2",
        "--language", "en", "--max_new_tokens", "8", "--dtype", "float32",
        "--speaker_id_column_name", "speaker_id", "--compute_wer",
        "--device", "cpu"])
    for name in ("dataset.jsonl", "transcriptions.csv", "pl_stats.json",
                 "audio"):
        assert not (pl / name).exists(), name
    ordered = sort_rows([json.loads(line) for line in
                         (cli_runs["data"] / "pl.jsonl").read_text()
                         .splitlines()], "speaker_id")
    ranks = [_pl_rows(pl / f"dataset-{r}.jsonl") for r in range(2)]
    for r in range(2):
        # no packing across the speaker change: a shard's texts in order
        texts = " ".join(x["text"] for x in shard_rows(ordered, 2, r))
        assert " ".join(x["text"] for x in ranks[r]) == texts
        assert (pl / f"transcriptions-{r}.csv").read_text().count("\n") == \
            len(ranks[r]) + 1
        assert (pl / f"audio-{r}").is_dir()
    ours, ref = ranks[0] + ranks[1], _pl_rows(single / "dataset.jsonl")
    assert [{k: v for k, v in r.items()} for r in ours] == ref
    # the trainer reads the directory: the per-rank manifests in rank order
    assert [r["text"] for r in load_dataset_any(str(pl))] == \
        [r["text"] for r in ref]
    stats = [json.loads((pl / f"pl_stats-{r}.json").read_text())
             for r in range(2)]
    one = json.loads((single / "pl_stats.json").read_text())
    assert stats[0]["wer_counts"] == stats[1]["wer_counts"] == \
        one["wer_counts"]
    assert stats[0]["rows"] + stats[1]["rows"] == one["rows"]


def _pad_cat(parts):
    """Concatenate the ranks' batches, padding the label axis to the
    longest (labels -100, inputs and mask 0: causal positions after the
    last label change nothing before it)."""
    s = max(p["labels"].shape[1] for p in parts)
    fill = {"labels": -100, "decoder_input_ids": 50257,
            "decoder_attention_mask": 0}
    out = {}
    for k in parts[0]:
        if k == "input_features":
            out[k] = np.concatenate([p[k] for p in parts])
            continue
        out[k] = np.concatenate([np.pad(
            p[k], ((0, 0), (0, s - p[k].shape[1])),
            constant_values=fill[k]) for p in parts])
    return out


def test_run_distillation_distributed_equals_replay(cli_runs):
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step)
    out = cli_runs["out"]
    metrics = [json.loads(line) for line in
               (out / "distill" / "metrics.jsonl").read_text().splitlines()]
    train = [m for m in metrics if "train/loss" in m]
    assert [m["step"] for m in train] == [1, 2, 3]
    assert all(len(m["train/step_time_s_ranks"]) == 2 for m in train)
    assert [m for m in metrics if "eval/wer" in m]
    teacher, tcfg = load_params(cli_runs["teacher"], device="cpu")
    student, scfg = load_params(cli_runs["student"], device="cpu")
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                          schedule="constant_with_warmup", precision="full",
                          frozen_prefixes=("encoder",))
    state = TrainState.create(student, opt)
    step, _ = build_train_step(scfg, tcfg, DistillConfig(), opt)
    for i, m in enumerate(train):
        parts = [dict(np.load(out / f"batch-rank{r}-step{i}.npz"))
                 for r in range(2)]
        batch = {k: torch.from_numpy(v) for k, v in _pad_cat(parts).items()}
        assert m["train/label_tokens"] == int((batch["labels"] != -100).sum())
        state, ref = step(state, teacher, batch)
        for k, v in ref.items():
            np.testing.assert_allclose(m[f"train/{k}"], float(v), rtol=1e-4,
                                       err_msg=f"step {i + 1}: {k}")
    # the multi-process ending: the last checkpoint, exported by rank 0
    ckpt = json.loads((out / "cli-rank0.json").read_text())["ckpt"]
    assert Path(ckpt).name == "checkpoint-3"
    assert not (out / "distill" / "end-of-training-weights").exists()
    exported, _ = load_params(str(out / "hf"), device="cpu")
    saved = torch.load(Path(ckpt) / "state.pt", weights_only=True)["params"]
    from distil_whisper_tpu_torch.models.params import tree_paths
    for p, x in tree_paths(exported).items():
        torch.testing.assert_close(x, saved[p].float(), rtol=0, atol=0)


def test_run_finetuning_distributed_equals_replay(cli_runs):
    """``run_finetuning --distributed`` (the unfrozen encoder's gradients
    summed too): its losses equal a one-process replay of the ranks'
    batches, and it ends with its last checkpoint."""
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        OptimizerConfig, TrainState, build_finetune_step)
    out = cli_runs["out"]
    train = [json.loads(line) for line in
             (out / "finetune" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in train] == [1, 2]
    params, cfg = load_params(cli_runs["student"], device="cpu")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=0, total_steps=2,
                          precision="full")
    state = TrainState.create(params, opt)
    step, _ = build_finetune_step(cfg, opt)
    for i, m in enumerate(train):
        parts = [dict(np.load(out / f"ft-batch-rank{r}-step{i}.npz"))
                 for r in range(2)]
        batch = {k: torch.from_numpy(v) for k, v in _pad_cat(parts).items()}
        state, ref = step(state, batch)
        np.testing.assert_allclose(m["train/loss"], float(ref["loss"]),
                                   rtol=1e-4, err_msg=f"step {i + 1}")
    ft = json.loads((out / "cli-rank1.json").read_text())["ft_ckpt"]
    assert Path(ft).name == "checkpoint-2" and (Path(ft) / "state.pt").exists()


def test_dryrun_multigpu_two_ranks():
    from distil_whisper_tpu_torch.parallel.dryrun import (PARAM_TOL,
                                                          dryrun_multigpu)
    report = dryrun_multigpu(2, device="cpu", timeout=240)
    assert report["world"] == 2 and report["backend"] == "gloo"
    for k in ("grad_err", "param_err", "loss_rel_err"):
        assert report[k] <= PARAM_TOL, (k, report[k])
    assert report["worst_element"]["leaf"].startswith("decoder")
    labels = [r["label_tokens"] for r in report["ranks"]]
    assert labels[0] != labels[1]
