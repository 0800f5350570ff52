"""The port's streaming input pipeline and pseudo-labelling featurizer
workers vs the JAX package's (CPU).

The shuffle buffer draws JAX's permutation for the same seed; the
prefetcher keeps order and raises the producer's error; ``streaming_batches``
filters, repeats and emits a last partial batch as JAX's does.  The
subprocess featurizers, given one JSONL manifest (a row list in the port,
a ``datasets.Dataset`` in JAX), give JAX's batches worker for worker: the
speaker sort (rows without a speaker last), the contiguous worker split,
the packing, the int16 PCM.  A worker imports neither the model nor the
attention and MLP modules, loads no kernel and never initialises CUDA.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from distil_whisper_tpu.training import data_stream as J
from distil_whisper_tpu_torch.training import data_stream as T


@pytest.mark.parametrize("n,buffer_size,seed", [(100, 16, 0), (37, 5, 3),
                                                (10, 32, 1)])
def test_shuffle_buffer_matches_jax(n, buffer_size, seed):
    items = list(range(n))
    got = list(T.ShuffleBuffer(items, buffer_size, np.random.default_rng(seed)))
    want = list(J.ShuffleBuffer(items, buffer_size, np.random.default_rng(seed)))
    assert got == want
    assert sorted(got) == items and (n <= 1 or got != items)


def test_prefetcher_preserves_order():
    def gen():
        for i in range(5):
            time.sleep(0.01)
            yield i
    assert list(T.Prefetcher(gen, depth=2)) == [0, 1, 2, 3, 4]


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise ValueError("boom")
    out = []
    with pytest.raises(ValueError, match="boom"):
        for x in T.Prefetcher(gen, depth=2):
            out.append(x)
    assert out == [1]


def _both(fn):
    return fn(J.streaming_batches), fn(T.streaming_batches)


def test_streaming_batches_filter_and_repeat_match_jax():
    rows = [{"x": i} for i in range(10)]

    def run(streaming_batches):
        it = streaming_batches(
            rows, lambda r: None if r["x"] % 2 else {"v": r["x"]},
            lambda s: [x["v"] for x in s], batch_size=3,
            shuffle_buffer_size=4, seed=5, repeat=True)
        return [next(it) for _ in range(6)]

    want, got = _both(run)
    assert got == want
    assert all(len(b) == 3 for b in got)          # repeat: full batches only
    assert all(v % 2 == 0 for b in got for v in b)


def test_streaming_batches_final_partial_batch():
    rows = [{"x": i} for i in range(5)]

    def run(streaming_batches):
        return list(streaming_batches(rows, lambda r: {"v": r["x"]},
                                      lambda s: [x["v"] for x in s],
                                      batch_size=2))

    want, got = _both(run)
    assert got == want == [[0, 1], [2, 3], [4]]


def _write_manifest(root: Path):
    """Ten 16-bit WAV clips of 4-12 s from speakers b, a and none, unsorted."""
    from distil_whisper_tpu_torch.audio.io import write_wav
    rng = np.random.default_rng(0)
    speakers = ["b", "a", None, "b", "a", "a", None, "b", "a", "b"]
    rows = []
    for i, spk in enumerate(speakers):
        secs = 4 + (i * 5) % 9
        t = np.arange(secs * 16000) / 16000.0
        audio = (0.2 * np.sin(2 * np.pi * (150 + 30 * i) * t)
                 + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        write_wav(str(root / f"{i}.wav"), audio, 16000)
        rows.append({"audio": str(root / f"{i}.wav"), "text": f"clip {i}",
                     "speaker_id": spk})
    path = root / "m.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _spec(manifest, concatenate, speaker_col="speaker_id"):
    return dict(dataset_path=manifest, split=None, audio_col="audio",
                text_col="text", speaker_col=speaker_col,
                concatenate=concatenate, sampling_rate=16000,
                n_samples=480000, local_bsz=2, host_shard=(0, 1))


def _by_worker(batches):
    out = {}
    for b in batches:
        out.setdefault(b["worker"], []).append(b)
    return out


@pytest.mark.parametrize("concatenate,workers", [(True, 2), (False, 3)])
def test_featurizer_workers_match_jax(tmp_path, concatenate, workers):
    from distil_whisper_tpu.training.pl_workers import (
        worker_feature_batches as j_batches)
    from distil_whisper_tpu_torch.training.pl_workers import (
        worker_feature_batches as t_batches)
    spec = _spec(_write_manifest(tmp_path), concatenate)
    want = _by_worker(j_batches(spec, workers))
    got = _by_worker(t_batches(spec, workers))
    assert sorted(got) == sorted(want) == list(range(workers))
    for wid in want:
        assert len(got[wid]) == len(want[wid])
        for g, w in zip(got[wid], want[wid]):
            assert (g["n"], g["lens"], g["texts"], g["cond"]) == \
                (w["n"], w["lens"], w["texts"], w["cond"])
            np.testing.assert_array_equal(g["wav16"], w["wav16"])
    texts = [t for wid in sorted(got) for b in got[wid] for t in b["texts"]]
    if concatenate:
        # speaker a's clips, then b's, then the speakerless ones, packed
        # to 30 s inside each worker's contiguous shard
        assert texts[0].startswith("clip 1") and "clip 2" in texts[-1]
    else:
        assert len(texts) == 10


def test_featurizer_worker_error_is_raised(tmp_path):
    from distil_whisper_tpu_torch.training.pl_workers import (
        worker_feature_batches)
    spec = _spec(str(tmp_path / "missing.jsonl"), True)
    with pytest.raises(RuntimeError, match="featurizer worker 0 failed"):
        list(worker_feature_batches(spec, 1))


_LIGHT = """
import queue, sys
import torch
def no_cuda(*a, **k):
    raise AssertionError("a featurizer worker initialised CUDA")
torch.cuda._lazy_init = no_cuda
torch.cuda.init = no_cuda
from distil_whisper_tpu_torch.training.pl_workers import _worker
q = queue.Queue()
_worker(q, 0, 1, {spec!r})
items = []
while not q.empty():
    items.append(q.get())
assert items[-1] == {{"worker": 0, "end": True}}, items[-1]
heavy = [m for m in sys.modules if m.startswith((
    "distil_whisper_tpu_torch.models", "distil_whisper_tpu_torch.generation",
    "distil_whisper_tpu_torch.training.distill",
    "distil_whisper_tpu_torch.ops.encoder_attention",
    "distil_whisper_tpu_torch.ops.int8"))]
assert not heavy, heavy
# the audio package imports the kernel loader, which built and loaded nothing
from distil_whisper_tpu_torch.ops import _build
assert not _build._libs and not _build.build_logs
print("OK", len(items) - 1)
"""


def test_featurizer_worker_is_import_light(tmp_path):
    """The worker body in a fresh interpreter, with CUDA's initialisation
    made to raise: it finishes, no model, generation or attention module
    was imported, and no kernel library was built or loaded."""
    spec = _spec(_write_manifest(tmp_path), True)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _LIGHT.format(spec=spec)],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "OK" and int(proc.stdout.split()[1]) > 0
