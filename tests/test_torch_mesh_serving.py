"""Both serving schedulers and ``run_server`` under a mesh, on the CPU,
against the JAX package's pipeline.

One job of four gloo ranks (tests/torch_mp_worker.py, mode ``serve``) on
a (2, 2) mesh, global rank 0 leading and the others following its
command stream (``parallel/lockstep.py``):

- the continuous engine, 4 lanes (2 a data rank), tensor parallel over
  the model axis: the staggered cases of tests/test_torch_serving_engine.py
  (greedy and timestamped, mixed languages and budgets) give the JAX
  pipeline's texts and offsets, with a word-timestamp request (the
  fallback thread, concurrent with the lanes) equal to the one-process
  pipeline's; draft and n-gram speculation give the same texts;
- the micro-batch scheduler: the JAX pipeline's results, and a sampled
  group's texts equal to one process's for the same seed;
- a request whose own options fail (an unknown language), refused at
  submission or failed inside a published call on every rank, leaves
  both schedulers and the HTTP server serving;
- ``run_server --distributed --model_parallel 2``: a POST over loopback
  answered with the same text;
- last, a follower whose step block raises: the leader's submission
  fails within the process group's timeout (60 s here) and a later one is
  refused.

The JAX references are computed while the ranks run.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import serving_cases, serving_goldens, tone

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE))
from test_torch_tensor_parallel import finish, start  # noqa: E402

WORLD = 4


def _jsonable(x):
    """A result as it comes back through JSON (tuples become lists)."""
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def mesh_serve(tmp_path_factory):
    from distil_whisper_tpu.models import load_params as jax_load_params
    from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
    root = tmp_path_factory.mktemp("mesh_serve")
    ck = make_tiny_checkpoint(root / "ck")
    draft_ck = make_tiny_checkpoint(root / "draft", decoder_layers=1, seed=7)
    cases = serving_cases()
    words_wav = tone(1.4, 330.0, seed=21)
    arrays = {"n_cases": len(cases), "words_wav": words_wav}
    for i, c in enumerate(cases):
        arrays.update({f"wav{i}": c["wav"], f"language{i}": c["language"],
                       f"ts{i}": c["return_timestamps"],
                       f"budget{i}": c["max_new_tokens"]})
    np.savez(root / "inputs.npz", **arrays)
    out = root / "out"
    out.mkdir()
    procs, logs = start("serve", root / "inputs.npz", ck, draft_ck, out)
    try:
        jparams, jcfg = jax_load_params(ck)
        jpipe = JPipeline(ck, dtype=jnp.float32, batch_size=2,
                          max_new_tokens=10, params=jparams, cfg=jcfg)
        golden = [_jsonable(g) for g in
                  serving_goldens(tmp_path_factory, ck, cases, jpipe)]
    finally:
        finish(procs, logs, timeout=600)
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    pipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=2,
                           max_new_tokens=10, device="cpu")
    words = _jsonable(pipe(words_wav, language="en", max_new_tokens=10,
                           return_timestamps="word"))
    plain = pipe(cases[0]["wav"], language="en", max_new_tokens=10)["text"]
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    from torch_mp_worker import sampled_requests
    group = sampled_requests([c["wav"] for c in cases[:4]])
    BatchingTranscriber(pipe, batch_size=4, max_new_tokens=10) \
        ._publish_dispatch(group)
    res = [json.loads((out / f"serve-rank{r}.json").read_text())
           for r in range(WORLD)]
    return dict(golden=golden, words=words, plain=plain, res=res,
                n=len(cases), sampled=[r.result["text"] for r in group])


def test_mesh_engine_matches_jax_pipeline(mesh_serve):
    """The engine on a (2, 2) mesh, 2 lanes a data rank: texts and
    offsets equal the JAX pipeline's; the word-timestamp request served
    by the fallback thread beside the lanes equals the one-process
    pipeline's."""
    lead = mesh_serve["res"][0]
    got = lead["greedy"]
    n = mesh_serve["n"]
    for i in range(n):
        assert got[i] == mesh_serve["golden"][i], f"case {i}"
    for key in ("text", "chunks"):
        assert got[n][key] == mesh_serve["words"][key]
    stats = lead["greedy_stats"]
    assert stats["admitted"] == n and stats["max_inflight"] <= 4
    assert stats["fb_batches"] == 1


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_mesh_engine_speculative_equals_greedy(mesh_serve, method):
    """Draft and n-gram lanes on the mesh give the greedy texts (and the
    JAX pipeline's), timestamped requests riding the lanes."""
    lead = mesh_serve["res"][0]
    assert lead[method] == mesh_serve["golden"]
    assert lead[f"{method}_stats"]["ts_fallback"] == 0
    if method == "draft":
        assert lead["draft_stats"]["drafted"] > 0


def test_mesh_microbatch_matches_jax_pipeline(mesh_serve):
    """The micro-batch scheduler under the mesh: each group's rows split
    over the data axis, its tokens gathered; the JAX pipeline's results."""
    lead = mesh_serve["res"][0]
    assert lead["microbatch"] == mesh_serve["golden"]
    assert lead["microbatch_stats"]["batches"] >= 2


def test_mesh_sampled_microbatch_equals_one_process(mesh_serve):
    """A sampled micro-batch group (temperature 1, one seed) on the (2, 2)
    mesh gives one process's texts: its rows' draws do not depend on how
    the data axis would split them."""
    got = mesh_serve["res"][0]["sampled"]
    assert got == mesh_serve["sampled"]
    assert len(set(got)) > 1      # the rows drew apart


def test_mesh_request_errors_keep_serving(mesh_serve):
    """An unknown language: refused at submission, or, past that check,
    failed inside a published call on every rank alike (the micro-batch
    group; the engine's fallback thread), and the next request still
    serves; over HTTP a 400, then the POST answers 200."""
    lead = mesh_serve["res"][0]
    for key in ("mb_bad_submit", "mb_bad_inside", "engine_bad_inside"):
        assert "unknown language 'xx'" in lead[key], key
    assert lead["mb_bad_submit"].startswith("ValueError")
    assert lead["mb_after_bad"]["text"] == mesh_serve["plain"]
    assert lead["engine_after_bad"]["text"] == mesh_serve["plain"]
    assert lead["http_bad"]["status"] == 400
    assert "unknown language 'xx'" in lead["http_bad"]["error"]


def test_mesh_run_server_answers_http(mesh_serve):
    """``run_server --distributed`` on four ranks: rank 0 answers a POST
    over loopback with the one-process text; the followers stop with it."""
    assert mesh_serve["res"][0]["http"]["text"] == mesh_serve["plain"]


def test_mesh_follower_failure_fails_the_leader(mesh_serve):
    """A follower whose step block raises: the leader's submission fails
    (no hang past the 60 s process-group timeout), a later submission is
    refused, and every follower's loop ends with an error."""
    lead = mesh_serve["res"][0]
    assert lead["failure"] != "no error"
    assert lead["failure_s"] < 90
    assert "closed" in lead["refused"] or "crashed" in lead["refused"]
    assert "injected follower failure" in mesh_serve["res"][-1]["follower"]
    for r in mesh_serve["res"][1:]:
        assert r["follower"] != "stopped"


# -- plain unit tests: no process group ----------------------------------

def test_lockstep_without_a_mesh_runs_locally():
    """In one process a call runs its handler (or ``run``) and nothing is
    published; stop is a no-op."""
    from distil_whisper_tpu_torch.parallel.lockstep import Lockstep
    seen = []
    stream = Lockstep({"add": lambda a, b=0: seen.append(a + b) or a + b})
    assert stream.call("add", 2, b=3) == 5
    assert stream.call("add", 1, run=lambda: "mine") == "mine"
    assert seen == [5] and stream.closed is None and not stream.distributed
    stream.stop()
    assert stream.closed is None


def test_lockstep_commands_keep_tensors_exact():
    """A command's header carries each tensor's shape and dtype; the bytes
    a broadcast carries rebuild it on a follower bit for bit (bf16, int8,
    int64, bool, and numpy audio back on the host), nested in lists and
    dicts."""
    import pickle
    from distil_whisper_tpu_torch.parallel.lockstep import (_pack, _refs,
                                                            _unpack, as_bytes)
    g = torch.Generator().manual_seed(0)
    obj = {"mel": torch.randn(2, 3, generator=g).bfloat16(),
           "rows": [torch.tensor([1, 2], dtype=torch.int64),
                    torch.tensor([-3], dtype=torch.int8)], "lang": "en",
           "flags": torch.tensor([True, False]),
           "audio": [tone(0.5, 200.0, 1)]}
    sent = []
    header = pickle.loads(pickle.dumps(_pack(obj, sent)))
    got = [torch.empty(r.shape, dtype=getattr(torch, r.dtype))
           for r in _refs(header)]
    for a, b in zip(got, sent):       # what the broadcast does
        as_bytes(a).copy_(as_bytes(b.contiguous()))
    back = _unpack(header, iter(got))
    assert back["lang"] == "en" and torch.equal(back["flags"], obj["flags"])
    assert isinstance(back["audio"][0], np.ndarray)
    np.testing.assert_array_equal(back["audio"][0], obj["audio"][0])
    for a, b in ((obj["mel"], back["mel"]), (obj["rows"][0], back["rows"][0]),
                 (obj["rows"][1], back["rows"][1])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engine_lanes_must_divide_the_data_axis():
    """An engine over a mesh whose data axis does not divide the lanes
    raises ValueError (lanes are split evenly over the data ranks)."""
    from types import SimpleNamespace
    from distil_whisper_tpu_torch.serving_engine import \
        ContinuousBatchingEngine

    class FakeMesh:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (2, 1)[dim]

        def get_coordinate(self):
            return [0, 0]

    pipe = SimpleNamespace(cfg=None, tokenizer=None, dtype=torch.float32,
                           device="cpu", mesh=FakeMesh())
    with pytest.raises(ValueError, match="3 lanes do not divide"):
        ContinuousBatchingEngine(pipe, lanes=3)
