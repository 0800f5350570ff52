"""The port's micro-batching scheduler and serving helpers (CPU, fp32,
tiny checkpoint).

The helpers equal JAX's exactly on grids of inputs (errors included); the
scheduler equals JAX's ``WhisperPipeline`` on the same converted weights
and the port's pipeline on every other route.  Mirrors tests/test_serving.py,
tests/test_serving_sampling.py, tests/test_serving_speculative.py and
tests/test_adaptive_gamma.py.
"""

import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import (serving_cases, serving_goldens, submit_all,
                                tone, torch_params)

import distil_whisper_tpu.serving as J
from distil_whisper_tpu_torch import serving as S
from distil_whisper_tpu_torch.models import load_params
from distil_whisper_tpu_torch.pipeline import WhisperPipeline
from distil_whisper_tpu_torch.serving import (BatchingTranscriber,
                                              ServerOverloadedError)


def _outcome(fn, *args):
    """``fn(*args)``'s value, or its exception's class name and message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared below
        return (type(e).__name__, str(e))


def _both(name, *args):
    assert _outcome(getattr(S, name), *args) == \
        _outcome(getattr(J, name), *args), (name, args)


# ----------------------------------------------------------------------
# helpers, exactly JAX's
# ----------------------------------------------------------------------


def test_estimate_accept_equals_jax():
    for g in (1, 2, 3, 4, 5, 8, 10):
        for r in (-0.5, 0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0, 1.5):
            assert S.estimate_accept(r, g) == J.estimate_accept(r, g)


def test_optimal_gamma_and_gamma_step_equal_jax():
    for levels in ([2, 5, 10], [1, 2, 4], [2, 4, 8]):
        for a in (0.0, 0.05, 0.3, 0.6, 0.8, 0.9, 0.95, 0.99, 1.0):
            for cost in (0.0, 0.05, 2 / 32, 0.5, 1.0):
                assert (S.optimal_gamma(a, levels, cost)
                        == J.optimal_gamma(a, levels, cost))
                for idx in range(len(levels)):
                    for margin in (1.02, 10.0):
                        st_s = {"gamma_raises": 0, "gamma_drops": 0}
                        st_j = dict(st_s)
                        assert (S._gamma_step(a, levels, idx, cost, st_s,
                                              margin)
                                == J._gamma_step(a, levels, idx, cost, st_j,
                                                 margin))
                        assert st_s == st_j


def test_coerce_helpers_equal_jax():
    for v in ("word", "WORD", " word ", "1", "true", "yes", "on", "0",
              "false", "no", "off", "", "char", "Words", True, False, 0, 1):
        _both("_coerce_timestamps", v)
    for v in (1, 2, "3", 0, -1, "x"):
        _both("_coerce_beams", v)
    for mode in ("chunked", "sequential", "bogus"):
        for ts in (False, True, "word"):
            _both("_coerce_mode", mode, ts)
            for t in (0.0, 0.7, -1.0):
                for k in (0, 50, -3):
                    for beams in (1, 2):
                        _both("_coerce_sampling", t, k, beams, mode, ts)
    assert issubclass(S.ServerOverloadedError, RuntimeError)


# ----------------------------------------------------------------------
# the scheduler against JAX's pipeline
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX pipeline's goldens on the staggered cases (the module's one
    JAX run, shared with the other scheduler modules) and the port's
    pipeline on the converted JAX parameters."""
    from distil_whisper_tpu.models import load_params as jax_load_params
    from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
    root = tmp_path_factory.mktemp("microbatch")
    ck = make_tiny_checkpoint(root / "ck")
    jparams, jcfg = jax_load_params(ck)
    jpipe = JPipeline(ck, dtype=jnp.float32, batch_size=2, max_new_tokens=10,
                      params=jparams, cfg=jcfg)
    cases = serving_cases()
    golden = serving_goldens(tmp_path_factory, ck, cases, jpipe)
    _, cfg = load_params(ck, device="cpu")
    pipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=2,
                           max_new_tokens=10, params=torch_params(jparams),
                           cfg=cfg, device="cpu")
    draft_ck = make_tiny_checkpoint(root / "draft", decoder_layers=1, seed=7)
    return dict(ck=ck, jpipe=jpipe, pipe=pipe, cases=cases, golden=golden,
                draft_ck=draft_ck,
                draft=load_params(draft_ck, dtype=torch.float32,
                                  device="cpu"))


@pytest.fixture(scope="module")
def server(setup):
    """One started micro-batch scheduler for the tests that do not need
    their own: batch 4, a 200 ms window, budget 10."""
    tr = BatchingTranscriber(setup["pipe"], batch_size=4, max_wait_ms=200,
                             max_new_tokens=10).start()
    yield tr
    tr.stop()


def _expected(pipe, wav, budget, language="en", ts=False, **kw):
    return pipe(wav, language=language, return_timestamps=ts,
                max_new_tokens=budget, **kw)


def test_microbatch_matches_jax_pipeline_staggered(setup):
    """8 requests through batches of 2, staggered arrivals, mixed
    languages, timestamps and budgets: text and offsets equal JAX's."""
    tr = BatchingTranscriber(setup["pipe"], batch_size=2, max_wait_ms=200,
                             max_new_tokens=10).start()
    try:
        results = submit_all(tr, setup["cases"])
        for i, (got, want) in enumerate(zip(results, setup["golden"])):
            assert got == want, f"case {i}: {got} != {want}"
        assert tr.stats["requests"] == 8
        assert 1 <= tr.stats["max_batch"] <= 2
    finally:
        tr.stop()


@pytest.mark.parametrize("variant", ["plain", "ngram_adaptive", "draft"])
def test_stats_and_snapshot_keys_match_jax(setup, variant):
    """The stats dict and snapshot have JAX's keys (the JAX transcriber is
    constructed, not started)."""
    from distil_whisper_tpu.models import load_params as jax_load_params
    kw = dict(batch_size=2, max_new_tokens=10)
    jkw = dict(kw)
    if variant == "ngram_adaptive":
        kw.update(ngram_speculative=True, adaptive_gamma=True)
        jkw = dict(kw)
    elif variant == "draft":
        kw["assistant"] = setup["draft"]
        jkw["assistant"] = jax_load_params(setup["draft_ck"])
    ours = BatchingTranscriber(setup["pipe"], **kw)
    theirs = J.BatchingTranscriber(setup["jpipe"], **jkw)
    assert set(ours.stats) == set(theirs.stats)
    a, b = ours.snapshot(), theirs.snapshot()
    assert set(a) == set(b)
    assert set(a.get("speculative", {})) == set(b.get("speculative", {}))
    assert ours.max_queue == theirs.max_queue


# ----------------------------------------------------------------------
# the scheduler against the port's pipeline
# ----------------------------------------------------------------------


def test_microbatch_concurrent_requests_share_a_batch(setup, server):
    wavs = [tone(1.0, 200.0 + 30 * i, i) for i in range(4)]
    before = server.stats["batches"]
    out = submit_all(server, [dict(wav=w, language="en") for w in wavs],
                     stagger=0.0)
    for w, o in zip(wavs, out):
        assert o == _expected(setup["pipe"], w, 10)
    assert server.stats["max_batch"] >= 2, server.stats
    assert server.stats["batches"] - before <= 3


def test_microbatch_long_form_and_stream(setup, server):
    """A >31 s file takes the chunked pipeline; stream=1 yields one final
    item equal to the blocking result."""
    pipe = setup["pipe"]
    wav = tone(40.0, 230.0, 8)
    before = server.stats["long_form"]
    out = server.submit(wav, language="en", return_timestamps=True,
                        timeout=600)
    assert out == _expected(pipe, wav, 10, ts=True)
    assert server.stats["long_form"] == before + 1
    short = tone(1.0, 260.0, 9)
    items = list(server.submit_stream(short, language="en", timeout=600))
    assert len(items) == 1 and items[0]["final"] is True
    assert {k: v for k, v in items[0].items() if k != "final"} == \
        _expected(pipe, short, 10)


@pytest.mark.parametrize("route", ["beam", "sequential"])
def test_microbatch_beam_and_sequential(setup, server, route):
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                      SequentialTranscriber)
    pipe = setup["pipe"]
    if route == "beam":
        wav = tone(1.0, 318.0, 3)
        out = server.submit(wav, language="en", num_beams=2,
                            max_new_tokens=6, timeout=600)
        assert out == _expected(pipe, wav, 6,
                                generate_kwargs={"num_beams": 2})
        return
    wav = tone(33.0, 240.0, 4)
    out = server.submit(wav, language="en", mode="sequential",
                        max_new_tokens=6, timeout=600)
    direct = SequentialTranscriber(
        pipe.params, pipe.cfg, pipe.tokenizer,
        SequentialOptions(max_new_tokens=6), language="en", batch_size=1,
        dtype=pipe.dtype, device="cpu").transcribe(
            [compute_mel(wav, pipe.cfg, pad_to_chunk=False,
                         device="cpu")[0]])[0]
    assert out["language"] == "en"
    assert out["text"] == direct["text"]
    assert [s["tokens"] for s in out["segments"]] == \
        [[int(t) for t in s["tokens"]] for s in direct["segments"]]


def test_microbatch_word_ts_burst_is_microbatched(setup, server):
    pipe = setup["pipe"]
    wavs = [tone(1.0, 205.0 + 25 * i, 20 + i) for i in range(3)]
    out = submit_all(server, [dict(wav=w, language="en",
                                   return_timestamps="word") for w in wavs],
                     stagger=0.0)
    for w, o in zip(wavs, out):
        direct = pipe(w, language="en", return_timestamps="word",
                      max_new_tokens=10)
        assert {k: o[k] for k in direct} == direct
    assert server.stats["word_ts_max_batch"] >= 2, server.stats


def test_microbatch_sampled_requests(setup, server):
    pipe = setup["pipe"]
    wav = tone(1.0, 260.0, 0)
    a = server.submit(wav, language="en", temperature=0.8, top_k=8, seed=123,
                      timeout=600)
    b = server.submit(wav, language="en", temperature=0.8, top_k=8, seed=123,
                      timeout=600)
    assert a == b, "same seed must reproduce"
    greedy = _expected(pipe, wav, 10)
    near = server.submit(wav, language="en", temperature=1e-4, seed=7,
                         timeout=600)
    assert near == greedy
    assert server.stats["sampled"] >= 3
    with pytest.raises(ValueError, match="beam"):
        server.submit(wav, language="en", temperature=0.7, num_beams=2)
    with pytest.raises(ValueError, match="top_k requires"):
        server.submit(wav, language="en", top_k=10)
    with pytest.raises(ValueError, match="single-window"):
        server.submit(tone(35.0, 220.0, 1), language="en", temperature=0.7)


def test_microbatch_max_queue_and_deadline(setup):
    tr = BatchingTranscriber(setup["pipe"], batch_size=2, max_wait_ms=300,
                             max_new_tokens=6, max_queue=0).start()
    try:
        with pytest.raises(ServerOverloadedError):
            tr.submit(tone(1.0, 300.0, 0), language="en")
        assert tr.stats["rejected"] == 1
        tr.max_queue = 16
        with pytest.raises(TimeoutError):
            tr.submit(tone(1.0, 300.0, 1), language="en", timeout=0.001)
        assert tr.stats["cancelled"] == 1
        wav = tone(1.0, 500.0, 2)
        assert tr.submit(wav, language="en", timeout=600) == \
            _expected(setup["pipe"], wav, 6)
    finally:
        tr.stop()


def test_microbatch_int8_kv_equals_int8_pipeline(setup):
    pipe = setup["pipe"]
    cfg = pipe.cfg.replace(quantize_self_kv=True, quantize_cross_kv=True)
    qpipe = WhisperPipeline(None, dtype=torch.float32, batch_size=2,
                            max_new_tokens=8, params=pipe.params, cfg=cfg,
                            tokenizer=pipe.tokenizer, device="cpu")
    tr = BatchingTranscriber(qpipe, batch_size=2, max_wait_ms=200,
                             max_new_tokens=8).start()
    try:
        wavs = [tone(1.0, 210.0 + 40 * i, seed=10 + i) for i in range(3)]
        out = submit_all(tr, [dict(wav=w, language="en") for w in wavs],
                         stagger=0.0)
        for w, o in zip(wavs, out):
            assert o == _expected(qpipe, w, 8)
    finally:
        tr.stop()


# ----------------------------------------------------------------------
# speculation and the gamma controller on whole batches
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_microbatch_speculative_matches_greedy(setup, method):
    pipe = setup["pipe"]
    kw = (dict(assistant=setup["draft"]) if method == "draft"
          else dict(ngram_speculative=True, max_ngram=2))
    tr = BatchingTranscriber(pipe, batch_size=2, max_wait_ms=100,
                             max_new_tokens=10, gamma=3, **kw).start()
    try:
        waves = [tone(1.0, f, i) for i, f in enumerate((270.0, 340.0, 410.0))]
        budgets = [10, 5, 8]
        out = submit_all(tr, [dict(wav=w, language="en", max_new_tokens=b)
                              for w, b in zip(waves, budgets)], stagger=0.0)
        for w, b, o in zip(waves, budgets, out):
            assert o == _expected(pipe, w, b)
        ts = tr.submit(waves[0], language="en", return_timestamps=True,
                       timeout=600)
        assert ts == _expected(pipe, waves[0], 10, ts=True)
        assert tr.stats["speculative_batches"] >= 2
        assert 0 <= tr.stats["accepted"] <= tr.stats["drafted"]
        assert tr.snapshot()["speculative"]["method"] == method
    finally:
        tr.stop()


@pytest.mark.parametrize("accept", [1.0, 0.0])
def test_microbatch_synthetic_acceptance_pins_rate(setup, accept):
    tr = BatchingTranscriber(setup["pipe"], batch_size=2, max_new_tokens=9,
                             assistant=setup["draft"], gamma=3,
                             synthetic_acceptance=accept).start()
    try:
        tr.submit(tone(1.0, 290.0, 11), language="en", timeout=600)
        d, a = tr.stats["drafted"], tr.stats["accepted"]
        assert d > 0
        if accept == 1.0:
            assert a / d > 0.5, tr.stats
        else:
            assert a == 0, tr.stats
    finally:
        tr.stop()


def _spec_pipe(setup, budget):
    pipe = setup["pipe"]
    return WhisperPipeline(None, dtype=torch.float32, batch_size=2,
                           max_new_tokens=budget, params=pipe.params,
                           cfg=pipe.cfg, tokenizer=pipe.tokenizer,
                           device="cpu")


def _drive(tr, n, budget):
    return submit_all(tr, [dict(wav=tone(1.0, 200.0 + 30 * i, seed=i),
                                language="en", max_new_tokens=budget)
                           for i in range(n)], stagger=0.0)


@pytest.mark.parametrize("accept,end", [(0.95, 8), (0.05, 2)])
def test_microbatch_controller_moves_gamma(setup, accept, end):
    kw = dict(draft_cost=0.05) if accept > 0.5 else {}
    tr = BatchingTranscriber(_spec_pipe(setup, 48), batch_size=2,
                             max_new_tokens=48, assistant=setup["draft"],
                             gamma=4, adaptive_gamma=True,
                             synthetic_acceptance=accept, **kw).start()
    try:
        assert tr._gamma_levels == [2, 4, 8]
        _drive(tr, 6, 48)
        key = "gamma_raises" if accept > 0.5 else "gamma_drops"
        assert tr.stats[key] >= 1, tr.stats
        assert tr.stats["gamma_current"] == end, tr.stats
        snap = tr.snapshot()["speculative"]
        assert snap["adaptive"] is True and snap["gamma_current"] == end
    finally:
        tr.stop()


def test_microbatch_identity_across_gamma_switches(setup):
    """Outputs equal the pipeline's greedy at every rung and across a
    switch (the rung move is forced between drives)."""
    pipe = _spec_pipe(setup, 8)
    tr = BatchingTranscriber(pipe, batch_size=2, max_new_tokens=8,
                             assistant=setup["draft"], gamma=4,
                             adaptive_gamma=True).start()
    try:
        out = _drive(tr, 4, 8)
        tr._gamma_idx = 0          # the controller's drop rung (gamma 2)
        out += _drive(tr, 4, 8)
        for i, o in enumerate(out):
            assert o == _expected(pipe, tone(1.0, 200.0 + 30 * (i % 4),
                                             seed=i % 4), 8)
    finally:
        tr.stop()


def test_worker_keeps_serving_after_a_failed_group(setup, monkeypatch):
    """An exception inside a group errors that group's requests only; the
    worker serves the next batch."""
    real, calls = S.generate, []

    def fail_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*a, **k)

    monkeypatch.setattr(S, "generate", fail_once)
    tr = BatchingTranscriber(setup["pipe"], batch_size=2, max_wait_ms=10,
                             max_new_tokens=6).start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            tr.submit(tone(1.0, 300.0, 0), language="en", timeout=120)
        wav = tone(1.0, 310.0, 1)
        assert tr.submit(wav, language="en", timeout=120) == \
            _expected(setup["pipe"], wav, 6)
    finally:
        tr.stop()


def test_counters_survive_concurrent_updates(setup):
    """Kernel launch counts and scheduler stats are bumped from several
    threads (step loop, featurizer, fallback, clients): no update is lost
    under a short switch interval with more threads than cores."""
    import sys
    import threading
    from types import SimpleNamespace
    from distil_whisper_tpu_torch.ops import _build
    wrapper = SimpleNamespace(launches=0)
    tr = BatchingTranscriber(setup["pipe"], batch_size=2)
    n_threads, n = 16, 2000

    def work():
        for _ in range(n):
            _build.count_launch(wrapper)
            tr._bump("cancelled")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == tr.stats["cancelled"] == n_threads * n
