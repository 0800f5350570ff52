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


@pytest.mark.parametrize("flags,item", [
    (["--distributed"], "multi-GPU"), (["--model_parallel", "2"], "multi-GPU"),
    (["--param_sharding", "2d"], "multi-GPU"), (["--streaming"], "streaming"),
    (["--quantize_student", "w8a8"], "QAT")])
def test_unported_flags_raise_naming_their_item(flags, item):
    from distil_whisper_tpu_torch.cli import run_distillation, run_finetuning
    common = ["--output_dir", "unused", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        run_distillation.main(["--teacher_checkpoint", "t",
                               "--student_checkpoint", "s",
                               "--train_dataset_path", "d"] + common + flags)
    if "--streaming" not in flags:
        with pytest.raises(NotImplementedError, match=item):
            run_finetuning.main(["--model_checkpoint", "m",
                                 "--train_dataset_path", "d"] + common + flags)
