"""The port's artifact publishing (utils/publish.py), as tests/test_publish.py
holds the JAX package's: the local mirror (incremental copies by atomic
rename, then the whole output directory), the Hub publisher's call sequence
against a fake client, failures contained by the safe wrapper, both
backends at once, and the pseudo-labelling CLI with ``--publish_dir``
(CPU).
"""

import json
import logging
from pathlib import Path

import numpy as np

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from helpers import make_tiny_checkpoint
from distil_whisper_tpu_torch.utils.publish import (
    HubPublisher, LocalMirrorPublisher, make_publisher)


def test_local_mirror_incremental_and_finalize(tmp_path):
    out = tmp_path / "run"
    (out / "sub").mkdir(parents=True)
    (out / "a.csv").write_text("x,y\n1,2\n")
    (out / "sub" / "b.txt").write_text("hello")

    pub = LocalMirrorPublisher(str(tmp_path / "mirror"))
    pub.publish(out, [out / "a.csv"], "flush 1")
    assert (tmp_path / "mirror" / "a.csv").read_text() == "x,y\n1,2\n"
    assert not (tmp_path / "mirror" / "sub" / "b.txt").exists()

    # overwrite on re-publish; no .tmp leftovers (atomic rename)
    (out / "a.csv").write_text("x,y\n1,2\n3,4\n")
    pub.publish(out, [out / "a.csv"], "flush 2")
    assert (tmp_path / "mirror" / "a.csv").read_text() == "x,y\n1,2\n3,4\n"

    pub.finalize(out, "done")
    assert (tmp_path / "mirror" / "sub" / "b.txt").read_text() == "hello"
    assert not list((tmp_path / "mirror").rglob("*.tmp"))


class _FakeApi:
    def __init__(self):
        self.calls = []

    def create_repo(self, repo_id, repo_type=None, private=None,
                    exist_ok=None):
        self.calls.append(("create_repo", repo_id, repo_type, private,
                           exist_ok))

    def upload_file(self, path_or_fileobj=None, path_in_repo=None,
                    repo_id=None, repo_type=None, commit_message=None):
        self.calls.append(("upload_file", path_in_repo, repo_id, repo_type))

    def upload_folder(self, folder_path=None, repo_id=None, repo_type=None,
                      commit_message=None):
        self.calls.append(("upload_folder", folder_path, repo_id, repo_type))


def test_hub_publisher_call_sequence(tmp_path):
    out = tmp_path / "run"
    out.mkdir()
    (out / "transcriptions.csv").write_text("i,t\n")

    api = _FakeApi()
    pub = HubPublisher("org/pl-labels", api=api)
    assert api.calls[0] == ("create_repo", "org/pl-labels", "dataset", True,
                            True)
    pub.publish(out, [out / "transcriptions.csv"], "step 50")
    assert api.calls[1] == ("upload_file", "transcriptions.csv",
                            "org/pl-labels", "dataset")
    # missing file is skipped, not an error (CSV may not exist yet)
    pub.publish(out, [out / "nope.csv"], "step 100")
    pub.finalize(out, "done")
    assert api.calls[-1] == ("upload_folder", str(out), "org/pl-labels",
                             "dataset")


def test_safe_wrapper_contains_failures(tmp_path, caplog):
    class _Boom:
        def publish(self, *a, **k):
            raise OSError("network down")

        def finalize(self, *a, **k):
            raise OSError("network down")

    from distil_whisper_tpu_torch.utils import publish as P
    pub = P._SafePublisher(_Boom())
    with caplog.at_level(logging.ERROR, logger="distil_whisper_tpu_torch"):
        pub.publish(tmp_path, [], "m")   # must not raise
        pub.finalize(tmp_path, "m")
    assert pub.failures == 2
    assert any("publish failed" in r.message for r in caplog.records)


def test_make_publisher_off_by_default():
    assert make_publisher() is None


def test_make_publisher_fans_out_to_both_backends(tmp_path, monkeypatch):
    """--publish_dir and --push_to_hub together: both backends get every
    call, and a failing one does not stop the other."""
    from distil_whisper_tpu_torch.utils import publish as P
    api = _FakeApi()
    monkeypatch.setattr(P, "HubPublisher",
                        lambda repo, token=None, private=True:
                        HubPublisher(repo, token=token, private=private,
                                     api=api))
    out = tmp_path / "run"
    out.mkdir()
    (out / "a.csv").write_text("x\n")
    pub = make_publisher(publish_dir=str(tmp_path / "mirror"),
                         push_to_hub="org/r")
    pub.publish(out, [out / "a.csv"], "m")
    assert (tmp_path / "mirror" / "a.csv").exists()
    assert ("upload_file", "a.csv", "org/r", "dataset") in api.calls
    api.upload_folder = None            # the Hub side now fails
    pub.finalize(out, "done")           # contained; the mirror still runs
    assert pub.failures == 1


def test_pl_cli_publishes_mirror(tmp_path):
    """run_pseudo_labelling --publish_dir: the mirror holds the flushed CSV,
    the manifest and the audio it names."""
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli.run_pseudo_labelling import main
    ckpt = make_tiny_checkpoint(tmp_path / "teacher")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        write_wav(str(tmp_path / f"{i}.wav"),
                  0.1 * rng.standard_normal(16000 * (2 + i)), 16000)
        rows.append({"audio": str(tmp_path / f"{i}.wav"), "text": "hello"})
    (tmp_path / "m.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    mirror = tmp_path / "mirror"
    out = main(["--model_checkpoint", ckpt,
                "--dataset_path", str(tmp_path / "m.jsonl"),
                "--output_dir", str(tmp_path / "pl"), "--language", "en",
                "--max_new_tokens", "4", "--dtype", "float32",
                "--per_device_batch_size", "2", "--logging_steps", "1",
                "--publish_dir", str(mirror), "--device", "cpu"])
    assert (mirror / "transcriptions.csv").read_text() == \
        (tmp_path / "pl" / "transcriptions.csv").read_text()
    manifest = (mirror / "dataset.jsonl").read_text().splitlines()
    assert manifest == Path(out).read_text().splitlines() and manifest
    assert len(list((mirror / "audio").glob("*.wav"))) == len(manifest)
    assert all(json.loads(r)["whisper_transcript"] for r in manifest)
