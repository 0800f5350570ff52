"""The port's HTTP front end and ``cli/run_server`` on both schedulers
(CPU, fp32, tiny checkpoint, a real ThreadingHTTPServer on an ephemeral
port).  Mirrors the HTTP cases of tests/test_serving.py,
tests/test_serving_engine.py and tests/test_serving_speculative.py."""

import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint

from distil_whisper_tpu_torch.cli.run_server import build_server
from distil_whisper_tpu_torch.serving import (ServerOverloadedError,
                                              make_http_server)


def _wav_bytes(seconds=1.0, rate=16000, freq=220.0):
    t = np.arange(int(seconds * rate)) / rate
    pcm = (0.2 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _as_json(result):
    """A result as the HTTP layer sends it (tuples become lists)."""
    return json.loads(json.dumps(result))


def _status(url, body=None):
    """The HTTP error status (and headers, body) a request gets."""
    try:
        if body is None:
            urllib.request.urlopen(url, timeout=60)
        else:
            _post(url, body, timeout=60)
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())
    raise AssertionError(f"{url} succeeded")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_tiny_checkpoint(tmp_path_factory.mktemp("http") / "ck")


@pytest.fixture(scope="module", params=["microbatch", "continuous"])
def server(request, ckpt):
    httpd, transcriber = build_server([
        "--model_checkpoint", ckpt, "--host", "127.0.0.1", "--port", "0",
        "--device", "cpu", "--dtype", "float32",
        "--batch_size", "2", "--max_wait_ms", "50", "--max_new_tokens", "6",
        "--language", "en", "--max_body_mb", "2",
        "--scheduler", request.param, "--block_steps", "3"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", transcriber
    httpd.shutdown()
    httpd.server_close()
    transcriber.stop()
    th.join(timeout=60)
    assert not th.is_alive()


def test_healthz_and_stats(server):
    base, tr = server
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["batch_size"] == 2
    with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
        snap = json.loads(r.read())
    assert snap["scheduler"] == ("continuous" if "lanes" in snap
                                 else "microbatch")
    assert snap["max_queue"] == 16 and "stats" in snap


def test_post_equals_the_transcriber(server):
    base, tr = server
    wav = _wav_bytes(freq=330.0)
    status, _, body = _post(base + "/v1/transcribe?language=en&timestamps=1",
                            wav)
    out = json.loads(body)
    assert status == 200 and out["latency_ms"] > 0
    direct = _as_json(tr.submit(wav, language="en", return_timestamps=True,
                                timeout=300))
    assert {k: out[k] for k in direct} == direct
    assert "chunks" in out


def test_stream_final_line_equals_blocking(server):
    base, tr = server
    wav = _wav_bytes(freq=275.0)
    status, headers, body = _post(
        base + "/v1/transcribe?language=en&stream=1", wav)
    assert status == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in body.splitlines() if x]
    assert lines[-1]["final"] is True
    assert all(not x["final"] for x in lines[:-1])
    _, _, blocking = _post(base + "/v1/transcribe?language=en", wav)
    assert lines[-1]["text"] == json.loads(blocking)["text"]


def test_error_mapping(server):
    """404 for unknown paths, 413 before the body is read, 400 for bad
    audio and bad arguments."""
    base, _ = server
    assert _status(base + "/nope")[0] == 404
    assert _status(base + "/v1/nope", b"x")[0] == 404
    assert _status(base + "/v1/transcribe", b"\0" * 3_000_000)[0] == 413
    wav = _wav_bytes()
    for query in ("", "?beams=0", "?top_k=5", "?mode=bogus",
                  "?mode=sequential&timestamps=word",
                  "?temperature=0.7&beams=2"):
        body = b"not a wav" if not query else wav
        code, _, err = _status(base + "/v1/transcribe" + query, body)
        assert code == 400 and "error" in err, query


def test_overload_is_503_with_retry_after(server):
    base, tr = server
    old, tr.max_queue = tr.max_queue, 0
    try:
        for query in ("", "?stream=1"):
            code, headers, _ = _status(base + "/v1/transcribe" + query,
                                       _wav_bytes())
            assert code == 503 and headers["Retry-After"] == "1"
        assert tr.stats["rejected"] >= 2
    finally:
        tr.max_queue = old


def test_deadline_is_504_and_counted_cancelled(server):
    base, tr = server
    before = tr.stats["cancelled"]
    code, _, _ = _status(base + "/v1/transcribe?language=en&timeout_s=0.001",
                         _wav_bytes(freq=350.0))
    assert code == 504
    assert tr.stats["cancelled"] == before + 1
    status, _, body = _post(base + "/v1/transcribe?language=en",
                            _wav_bytes())
    assert status == 200 and "text" in json.loads(body)


def test_word_beam_and_sampling_over_http(server):
    base, tr = server
    wav = _wav_bytes(freq=318.0)
    for query, kw in (("timestamps=word", dict(return_timestamps="word")),
                      ("beams=2", dict(num_beams=2)),
                      ("temperature=0.8&top_k=8&seed=1",
                       dict(temperature=0.8, top_k=8, seed=1))):
        status, _, body = _post(base + "/v1/transcribe?language=en&" + query,
                                wav)
        out = json.loads(body)
        direct = _as_json(tr.submit(wav, language="en", timeout=300, **kw))
        assert status == 200
        assert {k: out[k] for k in direct} == direct, query


def test_http_error_mapping_without_a_model():
    """503 + Retry-After and 504 on both waiting styles, /v1/stats from
    snapshot(), with a stub transcriber."""
    class Stub:
        batch_size = 2
        stats = {"requests": 0}
        pipe = None

        def snapshot(self):
            return {"scheduler": "stub", "queue_depth": 7}

        def submit(self, body, timeout=None, **kw):
            if timeout is not None:
                raise TimeoutError("deadline exceeded")
            raise ServerOverloadedError("backlog full")

        def submit_stream(self, body, timeout=None, **kw):
            return self.submit(body, timeout=timeout, **kw)

    httpd = make_http_server(Stub(), "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for stream in ("", "&stream=1"):
            code, headers, _ = _status(base + "/v1/transcribe?x=1" + stream,
                                       b"x")
            assert code == 503 and headers["Retry-After"] == "1"
            code, _, _ = _status(
                base + "/v1/transcribe?timeout_s=5" + stream, b"x")
            assert code == 504
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            assert json.loads(r.read())["queue_depth"] == 7
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)


@pytest.mark.parametrize("argv", [
    ["--ngram_speculative", "--assistant_checkpoint", "x"],
    ["--adaptive_gamma"],
])
def test_run_server_refuses_bad_flag_combinations(ckpt, argv):
    with pytest.raises(SystemExit):
        build_server(["--model_checkpoint", ckpt, "--device", "cpu",
                      "--port", "0", *argv])


@pytest.mark.parametrize("scheduler", ["microbatch", "continuous"])
def test_run_server_speculative_equals_plain(ckpt, tmp_path_factory,
                                             scheduler):
    """--assistant_checkpoint and --ngram_speculative serve the plain
    server's text on both schedulers."""
    draft = make_tiny_checkpoint(tmp_path_factory.mktemp("d") / "ck",
                                 decoder_layers=1, seed=7)
    wavs = [_wav_bytes(freq=f) for f in (230.0, 370.0)]
    common = ["--model_checkpoint", ckpt, "--host", "127.0.0.1", "--port",
              "0", "--device", "cpu", "--dtype", "float32", "--batch_size",
              "2", "--max_new_tokens", "6", "--language", "en",
              "--scheduler", scheduler, "--gamma", "3"]
    texts = {}
    for name, extra in (("plain", []), ("draft", ["--assistant_checkpoint",
                                                   draft]),
                        ("ngram", ["--ngram_speculative"])):
        httpd, tr = build_server(common + extra)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            texts[name] = [json.loads(_post(base + "/v1/transcribe", w)[2])
                           ["text"] for w in wavs]
            if name != "plain":
                with urllib.request.urlopen(base + "/v1/stats",
                                            timeout=60) as r:
                    assert json.loads(r.read())["speculative"]["method"] \
                        == name
        finally:
            httpd.shutdown()
            httpd.server_close()
            tr.stop()
            th.join(timeout=60)
    assert texts["draft"] == texts["plain"] == texts["ngram"]
