"""The port's pseudo-labelling CLI vs the JAX package's on one tiny fp32
checkpoint (tests/helpers.py::make_tiny_checkpoint) and one JSONL manifest
of 16-bit WAV clips from two speakers and some without one (CPU).

Each case runs both CLIs once per module (the port's in a child process,
beside JAX's): with speaker packing (the
default ``--concatenate_audio``, WER on), without it, with beams 2, and with
two featurizer workers.  The port's manifest rows equal JAX's Arrow rows:
``whisper_transcript``, ``text`` and ``condition_on_prev`` row for row, and
the stored audio (a float32 WAV in the port) bit for bit against JAX's
``audio.array``; the CSVs are equal byte for byte; the logged WER counts
are equal.  JAX's batch is per-device times its 8 virtual devices, so the
port is given that batch.  With workers, batches of different workers
interleave in arrival order, so those rows are compared as sorted sets.
"""

import contextlib
import csv
import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import ChildCall

SPEAKERS = ["b", "a", "b", None, "a", "b", "a", None, "b"]
SECONDS = [6, 9, 12, 4, 14, 7, 10, 5, 3]
TEXTS = ["the cat sat", "a dog ran fast", "hello world now"]

CASES = {
    "packed": ["--compute_wer", "--speaker_id_column_name", "speaker_id"],
    "no_concatenate": ["--no_concatenate_audio", "--compute_wer"],
    "beams_2": ["--num_beams", "2", "--speaker_id_column_name", "speaker_id",
                "--no_timestamps"],
    "workers_2": ["--featurizer_workers", "2",
                  "--speaker_id_column_name", "speaker_id"],
}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from distil_whisper_tpu_torch.audio.io import write_wav
    root = tmp_path_factory.mktemp("pl")
    ckpt = make_tiny_checkpoint(root / "ck")
    rng = np.random.default_rng(0)
    rows = []
    for i, (spk, secs) in enumerate(zip(SPEAKERS, SECONDS)):
        t = np.arange(secs * 16000) / 16000.0
        audio = (0.2 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                 + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        write_wav(str(root / f"{i}.wav"), audio, 16000)
        rows.append({"audio": str(root / f"{i}.wav"),
                     "text": TEXTS[i % len(TEXTS)], "speaker_id": spk})
    manifest = root / "train.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"root": root, "ckpt": ckpt, "manifest": str(manifest)}


@contextlib.contextmanager
def _log_records():
    """The log records emitted inside the block, at INFO and above."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.INFO)
    root.addHandler(handler)
    try:
        yield records
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


def _run(workspace, name, side):
    import jax
    out = workspace["root"] / name / side
    argv = ["--model_checkpoint", workspace["ckpt"],
            "--dataset_path", workspace["manifest"],
            "--output_dir", str(out), "--language", "en",
            "--max_new_tokens", "8", "--dtype", "float32",
            "--logging_steps", "1"] + CASES[name]
    with _log_records() as records:
        if side == "jax":
            from distil_whisper_tpu.cli.run_pseudo_labelling import main
            res = main(argv + ["--per_device_batch_size", "1"])
        else:
            from distil_whisper_tpu_torch.cli.run_pseudo_labelling import main
            res = main(argv + ["--per_device_batch_size",
                               str(jax.device_count()), "--device", "cpu"])
    wer = [r.getMessage() for r in records
           if r.getMessage().startswith("PL WER")]
    return {"out": out, "result": res, "wer": wer,
            "csv": (out / "transcriptions.csv").read_text()}


def _port_runs(ws):
    """The port's CLI on every case, in a child process (JSON in and
    out)."""
    ws = {**ws, "root": Path(ws["root"])}
    return {name: _run(ws, name, "port") for name in CASES}


@pytest.fixture(scope="module")
def runs(workspace):
    """Both CLIs on every case, once per module: the port's in a child
    process while JAX's run here."""
    port = ChildCall("test_torch_pseudo_labelling", "_port_runs",
                     {k: str(v) for k, v in workspace.items()})
    res = {(name, "jax"): _run(workspace, name, "jax") for name in CASES}
    for name, r in port.result().items():
        res[name, "port"] = {**r, "out": Path(r["out"])}
    return res


def _jax_rows(path):
    import datasets
    ds = datasets.load_from_disk(path)
    return [{"audio": np.asarray(r["audio"]["array"], np.float32),
             "text": r["text"], "whisper_transcript": r["whisper_transcript"],
             "condition_on_prev": r["condition_on_prev"]} for r in ds]


def _port_rows(path):
    from distil_whisper_tpu_torch.audio.io import read_wav
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    for r in rows:
        r["audio"], rate = read_wav(r["audio"])
        assert rate == 16000
    return rows


def _key(r):
    return (r["text"], r["whisper_transcript"], str(r["condition_on_prev"]),
            r["audio"].tobytes())


@pytest.mark.parametrize("name", list(CASES))
def test_rows_equal_jax(runs, name):
    j = _jax_rows(runs[name, "jax"]["result"])
    t = _port_rows(runs[name, "port"]["result"])
    assert runs[name, "port"]["result"].endswith("dataset.jsonl")
    assert len(t) == len(j) > 1
    if name == "workers_2":
        j, t = sorted(j, key=_key), sorted(t, key=_key)
    for i, (a, b) in enumerate(zip(j, t)):
        for k in ("text", "whisper_transcript", "condition_on_prev"):
            assert b[k] == a[k], (i, k)
        assert b["audio"].dtype == np.float32
        np.testing.assert_array_equal(b["audio"].view(np.uint32),
                                      a["audio"].view(np.uint32))
    assert any(r["condition_on_prev"] for r in t) == (name != "no_concatenate")
    if name == "packed":
        # three rows of speaker a (two packed), b's, then the speakerless
        assert [r["text"] for r in t][0] == "a dog ran fast a dog ran fast"
        assert t[-1]["text"] == "the cat sat a dog ran fast"


@pytest.mark.parametrize("name", list(CASES))
def test_csv_equal_jax(runs, name):
    j, t = runs[name, "jax"]["csv"], runs[name, "port"]["csv"]
    if name == "workers_2":
        # the index column counts rows in arrival order
        def body(text):
            return sorted(tuple(r[1:]) for r in csv.reader(text.splitlines()))
        assert body(t) == body(j)
    else:
        assert t == j
    assert t.splitlines()[0] == "index,whisper_transcript,text"


@pytest.mark.parametrize("name", ["packed", "no_concatenate"])
def test_wer_counts_equal_jax(runs, name):
    j, t = runs[name, "jax"]["wer"], runs[name, "port"]["wer"]
    assert len(t) == 1 and t == j
    counts = re.search(r"S=(\d+) I=(\d+) D=(\d+)", t[0]).groups()
    stats = json.loads((runs[name, "port"]["out"] / "pl_stats.json")
                       .read_text())
    w = stats["wer_counts"]
    assert (str(w["substitutions"]), str(w["insertions"]),
            str(w["deletions"])) == counts
    assert stats["rows"] == len(_port_rows(runs[name, "port"]["result"]))

