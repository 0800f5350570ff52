"""The recipe through the port's CLIs against the JAX package's CLIs on the
same tiny checkpoint and JSONL manifest (CPU, ``--precision full``):
create_student_model -> run_distillation (4 steps over epoch boundaries,
pseudo-labels with timestamps and prompts, a filtered row, eval with WER
and a best checkpoint) -> run_eval.  Students equal exactly; per-step
losses and grad norms, final parameters and eval predictions equal JAX's
at 1e-4; the output directories hold the same checkpoint names.  Each
package's side runs once per module.
"""

import json
import wave
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from helpers import make_tiny_checkpoint
from distil_whisper_tpu.models import load_params as j_load_params
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths

TEXTS = ["the cat sat", "a dog ran fast", "hello world now", "we are here",
         "it is late", "go home soon", "stars shine bright"]


def _write_wav(path, audio):
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    teacher = make_tiny_checkpoint(root / "teacher", encoder_layers=2,
                                   decoder_layers=4)
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(TEXTS):
        secs = 1.5 + 0.5 * (i % 4)
        t = np.arange(int(secs * 16000)) / 16000.0
        audio = (0.2 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                 + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        _write_wav(root / f"{i}.wav", audio)
        stamp = "<|0.00|>" if i % 2 else "<|notimestamps|>"
        end = f"<|{secs:.2f}|>" if i % 2 else ""
        pl = (f"<|startoftranscript|><|en|><|transcribe|>{stamp} {text}{end}"
              "<|endoftext|>")
        if i == 5:
            pl = pl.upper()            # all-caps hallucination: filtered
        rows.append({"audio": str(root / f"{i}.wav"), "text": text,
                     "whisper_transcript": pl,
                     "condition_on_prev": ([50361, 300 + i, 301 + i]
                                           if i % 3 == 0 else None)})
    manifest = root / "train.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    evalset = root / "eval.jsonl"
    evalset.write_text("".join(json.dumps(r) + "\n" for r in rows[:3]))
    return {"root": root, "teacher": teacher, "train": str(manifest),
            "eval": str(evalset)}


def _recipe(ws, side):
    """create student -> distill -> eval through one package's CLIs.

    The JAX trainer's batch is per-device times its mesh's data axis (the
    tests' 8 virtual CPU devices); the port runs on one device, so it is
    given that global batch."""
    import jax
    if side == "jax":
        from distil_whisper_tpu.cli import (create_student_model,
                                            run_distillation, run_eval)
        device, bsz = [], 2
    else:
        from distil_whisper_tpu_torch.cli import (create_student_model,
                                                  run_distillation, run_eval)
        device, bsz = ["--device", "cpu"], 2 * jax.device_count()
    root = ws["root"] / side
    student = str(root / "student")
    create_student_model.main(["--teacher_checkpoint", ws["teacher"],
                               "--save_dir", student,
                               "--decoder_layers", "2"] + device)
    out = root / "distilled"
    final = run_distillation.main([
        "--teacher_checkpoint", ws["teacher"],
        "--student_checkpoint", student,
        "--train_dataset_path", ws["train"],
        "--eval_dataset_path", ws["eval"],
        "--output_dir", str(out),
        "--max_steps", "4", "--per_device_train_batch_size", str(bsz),
        "--per_device_eval_batch_size", str(bsz),
        "--learning_rate", "1e-3", "--warmup_steps", "1",
        "--eval_steps", "4", "--save_steps", "2", "--save_total_limit", "2",
        "--logging_steps", "1", "--language", "en", "--precision", "full",
        "--eval_max_new_tokens", "8", "--max_label_length", "64",
        "--seed", "3"] + device)
    res = run_eval.main(["--model_checkpoint", final,
                         "--dataset_path", ws["eval"], "--mode", "short",
                         "--language", "en", "--batch_size", "2",
                         "--max_new_tokens", "8", "--dtype", "float32",
                         "--output_json", str(root / "eval.json")] + device)
    metrics = [json.loads(line) for line in
               (out / "metrics.jsonl").read_text().splitlines()]
    return {"student": student, "out": out, "final": final, "eval": res,
            "eval_json": json.loads((root / "eval.json").read_text()),
            "train": [m for m in metrics if "train/loss" in m],
            "evals": [m for m in metrics if "eval/wer" in m]}


@pytest.fixture(scope="module")
def runs(workspace):
    return {side: _recipe(workspace, side) for side in ("jax", "port")}


def test_students_equal(runs):
    jp, _ = j_load_params(runs["jax"]["student"])
    tp, _ = j_load_params(runs["port"]["student"])
    jf, tf = j_tree_paths(jp), j_tree_paths(tp)
    assert sorted(jf) == sorted(tf)
    for p in jf:
        np.testing.assert_array_equal(np.asarray(tf[p]), np.asarray(jf[p]), p)
    assert sorted(p.name for p in Path(runs["port"]["student"]).iterdir()) == \
        sorted(p.name for p in Path(runs["jax"]["student"]).iterdir())


def test_step_losses_equal(runs):
    j, t = runs["jax"]["train"], runs["port"]["train"]
    assert [m["step"] for m in t] == [m["step"] for m in j] == [1, 2, 3, 4]
    for jm, tm in zip(j, t):
        for k in ("train/loss", "train/ce_loss", "train/kl_loss",
                  "train/grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)


def test_final_parameters_equal(runs):
    jp, _ = j_load_params(runs["jax"]["final"])
    tp, _ = j_load_params(runs["port"]["final"])
    jf, tf = j_tree_paths(jp), j_tree_paths(tp)
    assert sorted(jf) == sorted(tf)
    moved = 0.0
    init = j_tree_paths(j_load_params(runs["jax"]["student"])[0])
    for p in jf:
        np.testing.assert_allclose(np.asarray(tf[p]), np.asarray(jf[p]),
                                   atol=1e-4, rtol=0, err_msg=p)
        moved = max(moved, float(np.abs(np.asarray(jf[p])
                                        - np.asarray(init[p])).max()))
    assert moved > 1e-3          # the steps did train


def test_checkpoint_directories_equal(runs):
    names = {side: sorted(p.name for p in runs[side]["out"].iterdir()
                          if p.name.startswith("checkpoint-"))
             for side in runs}
    assert names["port"] == names["jax"]
    assert "checkpoint-2" in names["port"] and "checkpoint-4" in names["port"]
    assert any("val-wer" in n for n in names["port"])
    assert (runs["port"]["out"] / "end-of-training-weights" / "vocab.json").exists()


def test_eval_equal(runs):
    j, t = runs["jax"], runs["port"]
    assert [m["step"] for m in t["evals"]] == [m["step"] for m in j["evals"]]
    for jm, tm in zip(j["evals"], t["evals"]):
        np.testing.assert_allclose(tm["eval/wer"], jm["eval/wer"], rtol=1e-6)
        np.testing.assert_allclose(tm["eval/ce_loss"], jm["eval/ce_loss"],
                                   rtol=1e-4)
    assert t["eval_json"]["predictions"] == j["eval_json"]["predictions"]
    assert t["eval"]["wer"] == j["eval"]["wer"]


def test_resume_continues_the_uninterrupted_run(workspace, runs, tmp_path):
    """--resume_from_checkpoint from checkpoint-2 of the port's run: the
    resumed run skips the two batches the checkpoint trained on, so steps
    3 and 4 give the uninterrupted run's losses and final parameters (JAX's
    trainer restarts its data order on resume: ROADMAP.md queue 3)."""
    import shutil
    from distil_whisper_tpu_torch.cli import run_distillation
    out = tmp_path / "resumed"
    out.mkdir()
    shutil.copytree(runs["port"]["out"] / "checkpoint-2", out / "checkpoint-2")
    import jax
    bsz = str(2 * jax.device_count())
    final = run_distillation.main([
        "--teacher_checkpoint", workspace["teacher"],
        "--student_checkpoint", runs["port"]["student"],
        "--train_dataset_path", workspace["train"],
        "--output_dir", str(out), "--resume_from_checkpoint",
        "--max_steps", "4", "--per_device_train_batch_size", bsz,
        "--learning_rate", "1e-3", "--warmup_steps", "1",
        "--eval_steps", "4", "--save_steps", "2", "--save_total_limit", "2",
        "--logging_steps", "1", "--language", "en", "--precision", "full",
        "--max_label_length", "64", "--seed", "3", "--device", "cpu"])
    resumed = [json.loads(line) for line in
               (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in resumed] == [3, 4]
    for m, want in zip(resumed, runs["port"]["train"][2:]):
        for k in ("train/loss", "train/grad_norm"):
            assert m[k] == want[k], k
    a = j_tree_paths(j_load_params(final)[0])
    b = j_tree_paths(j_load_params(runs["port"]["final"])[0])
    for p in a:
        np.testing.assert_array_equal(np.asarray(a[p]), np.asarray(b[p]), p)


# the CLIs other than the trainers, with the arguments they need to parse
OTHER_CLIS = {
    "run_pseudo_labelling": ["--model_checkpoint", "m", "--dataset_path", "d",
                             "--output_dir", "unused"],
    "convert_checkpoint_to_hf": ["--checkpoint_dir", "c",
                                 "--base_checkpoint", "b",
                                 "--save_dir", "unused"],
}


@pytest.mark.parametrize("flags,item", [
    (["--distributed"], "multi-GPU"), (["--model_parallel", "2"], "world size 1"),
    (["--param_sharding", "2d"], "world size 1"),
    (["run_pseudo_labelling", "--distributed"], "multi-GPU"),
    (["convert_checkpoint_to_hf", "--distributed"], "multi-GPU")])
def test_unported_flags_raise_naming_their_item(flags, item):
    """No multi-GPU flag raises NotImplementedError any more:
    ``--distributed`` is ported and, with no multi-GPU job to join, fails
    fast with RuntimeError; ``--model_parallel 2`` and ``--param_sharding
    2d`` are ported and, in a process alone (world size 1), raise
    ValueError: in both trainers, and in the CLI a case names first."""
    import importlib
    from distil_whisper_tpu_torch.cli import run_distillation, run_finetuning
    common = ["--device", "cpu"]
    if flags[0] in OTHER_CLIS:
        main = importlib.import_module(
            f"distil_whisper_tpu_torch.cli.{flags[0]}").main
        calls = [(main, OTHER_CLIS[flags[0]] + flags[1:])]
    else:
        calls = [(run_distillation.main,
                  ["--teacher_checkpoint", "t", "--student_checkpoint", "s",
                   "--train_dataset_path", "d", "--output_dir", "unused"]
                  + flags),
                 (run_finetuning.main,
                  ["--model_checkpoint", "m", "--train_dataset_path", "d",
                   "--output_dir", "unused"] + flags)]
    error = RuntimeError if "--distributed" in flags else ValueError
    for fn, argv in calls:
        with pytest.raises(error, match=item):
            fn(argv + common)


def test_streaming_refuses_preprocessing_only():
    from distil_whisper_tpu_torch.cli import run_distillation
    with pytest.raises(ValueError, match="incompatible with --streaming"):
        run_distillation.main(["--teacher_checkpoint", "t",
                               "--student_checkpoint", "s",
                               "--train_dataset_path", "d",
                               "--output_dir", "unused", "--device", "cpu",
                               "--streaming", "--preprocessing_only"])


SWEEP_SPEC = {"method": "grid",
              "parameters": {"lr": {"values": [1, 2, 3]},
                             "bs": {"values": [8, 16]},
                             "steps": {"value": 5}}}


@pytest.mark.parametrize("method,max_runs,seed", [
    ("grid", 0, 0), ("grid", 4, 0), ("random", 5, 0), ("random", 7, 11)])
def test_sweep_configs_equal_jax(method, max_runs, seed):
    from distil_whisper_tpu.cli.run_sweep import expand_configs as j_expand
    from distil_whisper_tpu_torch.cli.run_sweep import expand_configs
    spec = {**SWEEP_SPEC, "method": method}
    got = expand_configs(spec, max_runs, seed)
    assert got == j_expand(spec, max_runs, seed)
    assert len(got) == (max_runs or 6) and all(c["steps"] == 5 for c in got)


def test_sweep_over_run_eval(workspace, runs, tmp_path):
    """A two-run grid sweep of the port's run_eval over the distilled
    checkpoint: both runs succeed, the metric is read from run_eval's
    result, and best.json holds the smaller."""
    from distil_whisper_tpu_torch.cli.run_sweep import main
    spec = {"program": "eval", "method": "grid",
            "metric": {"name": "wer", "goal": "minimize"},
            "command_args": ["--mode", "short", "--language", "en",
                             "--dtype", "float32", "--batch_size", "2"],
            "parameters": {"max_new_tokens": {"values": [2, 8]}}}
    spec_path = tmp_path / "sweep.json"
    spec_path.write_text(json.dumps(spec))
    best = main(["--sweep_config", str(spec_path),
                 "--output_dir", str(tmp_path / "sweep"), "--",
                 "--model_checkpoint", runs["port"]["final"],
                 "--dataset_path", workspace["eval"], "--device", "cpu"])
    rows = [json.loads(line) for line in
            (tmp_path / "sweep" / "sweep_results.jsonl").read_text()
            .splitlines()]
    assert [r["status"] for r in rows] == ["ok", "ok"]
    assert [r["config"] for r in rows] == [{"max_new_tokens": 2},
                                           {"max_new_tokens": 8}]
    assert all(isinstance(r["value"], float) for r in rows)
    assert best == json.loads((tmp_path / "sweep" / "best.json").read_text())
    assert best["value"] == min(r["value"] for r in rows)
    assert (tmp_path / "sweep" / "run-001" / "result.json").exists()


def test_converted_checkpoints_reload_equal(workspace, runs, tmp_path):
    """convert_checkpoint_to_hf on the port's distillation: the output dir
    (its newest checkpoint, step 4) gives the end-of-training weights bit
    for bit, a named checkpoint dir its own params in fp32; a checkpoint
    of another architecture is refused."""
    import torch
    from distil_whisper_tpu_torch.cli import convert_checkpoint_to_hf
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.models.params import tree_paths
    out = runs["port"]["out"]
    base = runs["port"]["student"]

    def convert(src, dst):
        convert_checkpoint_to_hf.main(["--checkpoint_dir", str(src),
                                       "--base_checkpoint", base,
                                       "--save_dir", str(tmp_path / dst),
                                       "--device", "cpu"])
        return tree_paths(load_params(str(tmp_path / dst), device="cpu")[0])

    latest = convert(out, "latest")
    final = tree_paths(load_params(runs["port"]["final"], device="cpu")[0])
    assert sorted(latest) == sorted(final)
    for p in final:
        assert torch.equal(latest[p], final[p]), p
    # a named checkpoint dir: its own params, in fp32
    step2 = convert(out / "checkpoint-2", "step2")
    sd = torch.load(out / "checkpoint-2" / "state.pt", weights_only=True)
    for p, x in sd["params"].items():
        assert torch.equal(step2[p], x.float()), p
    assert (tmp_path / "latest" / "vocab.json").exists()
    # the teacher has 4 decoder layers where the checkpoint has 2
    with pytest.raises(ValueError, match="architecture"):
        convert_checkpoint_to_hf.main([
            "--checkpoint_dir", str(out),
            "--base_checkpoint", workspace["teacher"],
            "--save_dir", str(tmp_path / "bad"), "--device", "cpu"])


def test_converted_checkpoint_loads_in_jax(runs, tmp_path):
    """JAX's load_params on the converted directory: teacher-forced logits
    within 1e-5 of the port's on the same weights."""
    import jax.numpy as jnp
    import torch
    from distil_whisper_tpu.models.whisper import decode as j_decode
    from distil_whisper_tpu.models.whisper import encode as j_encode
    from distil_whisper_tpu_torch.cli import convert_checkpoint_to_hf
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.models.whisper import decode, encode
    dst = str(tmp_path / "hf")
    convert_checkpoint_to_hf.main(["--checkpoint_dir",
                                   str(runs["port"]["out"]),
                                   "--base_checkpoint", runs["port"]["student"],
                                   "--save_dir", dst, "--device", "cpu"])
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32)
    ids = rng.integers(0, 50257, (2, 6)).astype(np.int32)
    jp, jcfg = j_load_params(dst)
    jl, _ = j_decode(jp["decoder"], jcfg, jnp.asarray(ids),
                     enc=j_encode(jp["encoder"], jcfg, jnp.asarray(mel)))
    tp, tcfg = load_params(dst, device="cpu")
    with torch.no_grad():
        tl, _ = decode(tp["decoder"], tcfg, torch.from_numpy(ids).long(),
                       enc=encode(tp["encoder"], tcfg, torch.from_numpy(mel)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_stage1_to_stage3_streaming_qat(workspace, runs, tmp_path):
    """The recipe's first and third stages through the port alone: the
    teacher pseudo-labels the manifest, and the student distils from that
    manifest with --streaming --quantize_student w8a8 (the random teacher's
    labels are far from the texts, so the WER filter is opened)."""
    import jax
    from distil_whisper_tpu_torch.cli import (run_distillation,
                                              run_pseudo_labelling)
    manifest = run_pseudo_labelling.main([
        "--model_checkpoint", workspace["teacher"],
        "--dataset_path", workspace["train"],
        "--output_dir", str(tmp_path / "pl"), "--language", "en",
        "--max_new_tokens", "8", "--dtype", "float32",
        "--per_device_batch_size", "4", "--no_concatenate_audio",
        "--device", "cpu"])
    rows = [json.loads(line) for line in Path(manifest).read_text()
            .splitlines()]
    assert [r["text"] for r in rows] == TEXTS
    out = tmp_path / "distilled"
    final = run_distillation.main([
        "--teacher_checkpoint", workspace["teacher"],
        "--student_checkpoint", runs["port"]["student"],
        "--train_dataset_path", manifest, "--output_dir", str(out),
        "--streaming", "--shuffle_buffer_size", "4",
        "--quantize_student", "w8a8", "--max_steps", "2",
        "--per_device_train_batch_size", str(2 * jax.device_count()),
        "--learning_rate", "1e-3", "--warmup_steps", "0",
        "--save_steps", "100", "--logging_steps", "1", "--language", "en",
        "--precision", "full", "--max_label_length", "64",
        "--wer_threshold", "1000", "--seed", "3", "--device", "cpu"])
    metrics = [json.loads(line) for line in
               (out / "metrics.jsonl").read_text().splitlines()]
    losses = [m["train/loss"] for m in metrics if "train/loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    moved = j_tree_paths(j_load_params(final)[0])
    init = j_tree_paths(j_load_params(runs["port"]["student"])[0])
    assert np.abs(np.asarray(moved["decoder.layers.fc1.kernel"])
                  - np.asarray(init["decoder.layers.fc1.kernel"])).max() > 0
