"""The port's continuous-batching engine (CPU, fp32, tiny checkpoint).

Held against JAX's ``WhisperPipeline`` on the same converted weights (the
JAX engine's own tests pin JAX's engine to that pipeline), against the
port's pipeline for every other route, and against JAX's formulas for the
synthetic coins.  Mirrors tests/test_serving_engine.py,
tests/test_serving_sampling.py and tests/test_adaptive_gamma.py.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import serving_cases, submit_all, tone, torch_params

from distil_whisper_tpu_torch.models import load_params
from distil_whisper_tpu_torch.pipeline import WhisperPipeline
from distil_whisper_tpu_torch.serving import ServerOverloadedError
from distil_whisper_tpu_torch.serving_engine import (
    ContinuousTranscriber, _EngineRequest, periodic_oracle, sample_lanes,
    sample_uniforms, synthetic_agree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX pipeline's goldens on the staggered cases (the module's one
    JAX run) and the port's pipeline on the JAX parameters, converted."""
    from distil_whisper_tpu.models import load_params as jax_load_params
    from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
    root = tmp_path_factory.mktemp("engine")
    ck = make_tiny_checkpoint(root / "ck")
    jparams, jcfg = jax_load_params(ck)
    jpipe = JPipeline(ck, dtype=jnp.float32, batch_size=2, max_new_tokens=10,
                      params=jparams, cfg=jcfg)
    cases = serving_cases()
    golden = [jpipe(c["wav"], language=c["language"],
                    return_timestamps=c["return_timestamps"],
                    max_new_tokens=c["max_new_tokens"]) for c in cases]
    _, cfg = load_params(ck, device="cpu")
    pipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=2,
                           max_new_tokens=10, params=torch_params(jparams),
                           cfg=cfg, device="cpu")
    draft_ck = make_tiny_checkpoint(root / "draft", decoder_layers=1, seed=7)
    return dict(ck=ck, jpipe=jpipe, pipe=pipe, cases=cases, golden=golden,
                draft_ck=draft_ck,
                draft=load_params(draft_ck, dtype=torch.float32,
                                  device="cpu"))


def _expected(pipe, wav, budget, language="en", ts=False):
    return pipe(wav, language=language, return_timestamps=ts,
                max_new_tokens=budget)


# ----------------------------------------------------------------------
# against JAX's pipeline
# ----------------------------------------------------------------------


def test_engine_matches_jax_pipeline_staggered(setup):
    """8 requests through 2 lanes, staggered arrivals, mixed languages,
    timestamps and budgets: text and offsets equal JAX's pipeline."""
    tr = ContinuousTranscriber(setup["pipe"], batch_size=2, max_new_tokens=10,
                               block_steps=3).start()
    try:
        results = submit_all(tr, setup["cases"])
        for i, (got, want) in enumerate(zip(results, setup["golden"])):
            assert got == want, f"case {i}: {got} != {want}"
        assert tr.stats["admitted"] == 8
        assert tr.stats["max_inflight"] <= 2
        assert tr.stats["tokens_out"] > 0
    finally:
        tr.stop()


@pytest.mark.parametrize("variant", ["plain", "ngram_adaptive", "draft"])
def test_stats_and_snapshot_keys_match_jax(setup, variant):
    """The port's stats dict and /v1/stats snapshot have JAX's keys (the
    JAX transcriber is constructed, not started)."""
    from distil_whisper_tpu.models import load_params as jax_load_params
    from distil_whisper_tpu.serving_engine import ContinuousTranscriber as J
    kw = dict(batch_size=2, max_new_tokens=10, block_steps=3)
    jkw = dict(kw)
    if variant == "ngram_adaptive":
        kw.update(ngram_speculative=True, adaptive_gamma=True)
        jkw = dict(kw)
    elif variant == "draft":
        kw["assistant"] = setup["draft"]
        jkw["assistant"] = jax_load_params(setup["draft_ck"])
    ours = ContinuousTranscriber(setup["pipe"], **kw)
    theirs = J(setup["jpipe"], **jkw)
    assert set(ours.stats) == set(theirs.stats)
    a, b = ours.snapshot(), theirs.snapshot()
    assert set(a) == set(b)
    assert set(a.get("speculative", {})) == set(b.get("speculative", {}))
    assert ours.engine.t_buf == theirs.engine.t_buf
    assert ours.engine.p_max == theirs.engine.p_max


# ----------------------------------------------------------------------
# against the port's pipeline
# ----------------------------------------------------------------------


def test_engine_streaming_partials(setup):
    """submit_stream yields growing partials, then a final result equal to
    the blocking one."""
    tr = ContinuousTranscriber(setup["pipe"], batch_size=2, max_new_tokens=10,
                               block_steps=2).start()
    try:
        wav = tone(1.2, 260.0, seed=5)
        items = list(tr.submit_stream(wav, language="en", timeout=600))
        assert items[-1]["final"] is True
        assert all(not it["final"] for it in items[:-1])
        assert len(items) >= 2, "expected at least one partial"
        texts = [it["text"] for it in items]
        assert all(texts[i + 1].startswith(texts[i])
                   for i in range(len(texts) - 1))
        solo = tr.submit(wav, language="en", timeout=600)
        assert items[-1]["text"] == solo["text"]
    finally:
        tr.stop()


def test_engine_long_form_in_lanes(setup):
    """A >31 s file rides the lanes as strided windows and equals the
    chunked pipeline; a short request beside it is not blocked."""
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=10,
                               block_steps=3).start()
    try:
        wav, short = tone(55.0, 220.0, seed=42), tone(1.0, 300.0, seed=43)
        out = submit_all(tr, [dict(wav=wav, language="en",
                                   return_timestamps=True),
                              dict(wav=short, language="en")], stagger=0.2)
        assert out[0] == _expected(pipe, wav, 10, ts=True)
        assert out[1] == _expected(pipe, short, 10)
        assert tr.stats["long_form"] == 1
        assert tr.stats["admitted"] >= 3
    finally:
        tr.stop()


def test_engine_long_form_streaming(setup):
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=10,
                               block_steps=3).start()
    try:
        wav = tone(55.0, 240.0, seed=44)
        items = list(tr.submit_stream(wav, language="en", timeout=600))
        assert items[-1]["final"] is True
        assert items[-1]["text"] == _expected(pipe, wav, 10)["text"]
        assert all(not it["final"] for it in items[:-1])
    finally:
        tr.stop()


def test_engine_int8_kv_lanes_equal_int8_pipeline(setup):
    """int8 self-KV and cross-K/V lanes (quantized per-lane cache writes,
    int8 cross rows and scales written into the lanes) equal the int8
    pipeline."""
    pipe = setup["pipe"]
    cfg = pipe.cfg.replace(quantize_self_kv=True, quantize_cross_kv=True)
    qpipe = WhisperPipeline(None, dtype=torch.float32, batch_size=2,
                            max_new_tokens=8, params=pipe.params, cfg=cfg,
                            tokenizer=pipe.tokenizer, device="cpu")
    tr = ContinuousTranscriber(qpipe, batch_size=2, max_new_tokens=8,
                               block_steps=3).start()
    try:
        wavs = [tone(1.0, 210.0 + 40 * i, seed=10 + i) for i in range(4)]
        out = submit_all(tr, [dict(wav=w, language="en") for w in wavs])
        for w, o in zip(wavs, out):
            assert o == _expected(qpipe, w, 8)
        assert "k_q" in tr.engine._state["cache"]
        assert "k_q" in tr.engine._state["cross"]
    finally:
        tr.stop()


@pytest.mark.parametrize("route", ["beam", "word", "sequential"])
def test_engine_fallback_routes(setup, route):
    """Beams, word timestamps and mode=sequential run on the fallback
    thread with the pipeline's (or SequentialTranscriber's) result, while a
    plain request beside them keeps riding the lanes."""
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                      SequentialTranscriber)
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=2,
                               max_new_tokens=6).start()
    try:
        wav = tone(33.0 if route == "sequential" else 1.0, 318.0, 3)
        short = tone(1.0, 440.0, 4)
        kw = {"beam": dict(num_beams=2),
              "word": dict(return_timestamps="word"),
              "sequential": dict(mode="sequential", max_new_tokens=6)}[route]
        out = submit_all(tr, [dict(wav=wav, language="en", **kw),
                              dict(wav=short, language="en")], stagger=0.0)
        if route == "sequential":
            direct = SequentialTranscriber(
                pipe.params, pipe.cfg, pipe.tokenizer,
                SequentialOptions(max_new_tokens=6), language="en",
                batch_size=1, dtype=pipe.dtype, device="cpu").transcribe(
                    [compute_mel(wav, pipe.cfg, pad_to_chunk=False,
                                 device="cpu")[0]])[0]
            assert out[0]["text"] == direct["text"]
            assert [s["tokens"] for s in out[0]["segments"]] == \
                [[int(t) for t in s["tokens"]] for s in direct["segments"]]
        else:
            gk = {"num_beams": 2} if route == "beam" else None
            direct = pipe(wav, language="en", max_new_tokens=6,
                          return_timestamps=kw.get("return_timestamps",
                                                   False),
                          generate_kwargs=gk)
            # the micro-batched word path also names the language
            assert {k: out[0][k] for k in direct} == direct
        assert out[1] == _expected(pipe, short, 6)
        key = {"beam": "beam", "word": "word_ts",
               "sequential": "sequential"}[route]
        assert tr.stats[key] == 1
        assert tr.snapshot()["fallback_depth"] == 0
    finally:
        tr.stop()


def test_engine_word_ts_burst_is_microbatched(setup):
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=2,
                               max_new_tokens=6).start()
    try:
        # hold the fallback thread's first batch back until the burst is in
        # its queue, so that the burst is drained together
        gate = threading.Event()
        real = pipe.transcribe_words_batch

        def gated(*a, **k):
            gate.wait(60)
            return real(*a, **k)

        wavs = [tone(1.0, 260.0 + 40 * i, 10 + i) for i in range(4)]
        pipe.transcribe_words_batch = gated
        try:
            threads = []
            results = [None] * 4

            def post(i):
                results[i] = tr.submit(wavs[i], language="en",
                                       return_timestamps="word", timeout=600)

            for i in range(4):
                threads.append(threading.Thread(target=post, args=(i,)))
                threads[-1].start()
            deadline = time.time() + 60
            while tr.stats["word_ts"] < 4 and time.time() < deadline:
                time.sleep(0.01)
            gate.set()
            for th in threads:
                th.join(timeout=600)
        finally:
            pipe.transcribe_words_batch = real
        for w, res in zip(wavs, results):
            direct = pipe(w, language="en", return_timestamps="word",
                          max_new_tokens=6)
            assert {k: res[k] for k in direct} == direct
        assert tr.stats["fb_max_batch"] >= 2, tr.stats
    finally:
        tr.stop()


def test_engine_backpressure_cancel_and_snapshot(setup):
    """max_queue shedding, a deadline counted as cancelled, and the
    snapshot after the engine drained."""
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=2,
                               max_new_tokens=6, max_queue=0).start()
    try:
        with pytest.raises(ServerOverloadedError):
            tr.submit(tone(1.0, 300.0, 0), language="en")
        assert tr.stats["rejected"] == 1
        tr.max_queue = 16
        with pytest.raises(TimeoutError):
            tr.submit(tone(1.0, 300.0, 1), language="en", timeout=0.0)
        assert tr.stats["cancelled"] == 1
        wav = tone(1.0, 500.0, 2)
        assert tr.submit(wav, language="en", timeout=600) == \
            _expected(pipe, wav, 6)
        deadline = time.time() + 60
        while time.time() < deadline and tr.snapshot()["free_lanes"] != 2:
            time.sleep(0.05)
        snap = tr.snapshot()
        assert snap["scheduler"] == "continuous"
        assert snap["lanes"] == 2 and snap["free_lanes"] == 2
        assert snap["inflight"] == 0 and snap["pending_windows"] == 0
        assert snap["max_queue"] == 16
    finally:
        tr.stop()


def test_engine_reclaims_cancelled_inflight_lane(setup):
    """Cancelling a live lane frees it, and a request admitted over the
    orphaned lane state decodes exactly its pipeline tokens."""
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=2,
                               max_new_tokens=6)
    tr.engine.init_state()
    wavs = [tone(1.0, f, s) for s, f in enumerate((260.0, 390.0, 520.0))]
    r1, r2, r3 = (_EngineRequest(w, "en", "transcribe", False, None,
                                 threading.Event()) for w in wavs)
    tr._pending += [r1, r2]
    tr._admit_pending()
    assert len(tr._inflight) == 2 and not tr._free
    lane1 = next(l for l, r in tr._inflight.items() if r is r1)
    tr._complete((tr.engine.step(), dict(tr._inflight)))   # r1 mid-decode
    tr._cancel(r1)
    tr._reclaim_cancelled()
    assert tr._free == [lane1] and list(tr._inflight.values()) == [r2]
    tr._pending.append(r3)
    tr._admit_pending()
    assert tr._inflight[lane1] is r3
    for _ in range(20):
        if r2.done.is_set() and r3.done.is_set():
            break
        tr._complete((tr.engine.step(), dict(tr._inflight)))
    assert r2.result == _expected(pipe, wavs[1], 6)
    assert r3.result == _expected(pipe, wavs[2], 6)
    assert tr.stats["cancelled"] == 1


def test_engine_block_syncs_with_the_host_once(setup, monkeypatch):
    """A block never reads the device from the host (no ``item``,
    ``tolist``, ``bool`` ...); ``unpack`` reads it once."""
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=4,
                               max_new_tokens=10)
    tr.engine.init_state()
    tr._pending += [_EngineRequest(tone(1.0, f, 0), "en", "transcribe",
                                   ts, None, threading.Event())
                    for f, ts in ((300.0, True), (420.0, False))]
    tr._admit_pending()
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    packed = tr.engine.step(sampling=True)
    assert calls == []
    tr.engine.unpack(packed)
    # one copy to the host, viewed as numpy there
    assert calls == ["cpu", "numpy"], calls


def test_engine_worker_crash_fails_submitters(setup, monkeypatch):
    """An exception in the step loop errors out every waiting submitter
    and every later one; nothing hangs."""
    tr = ContinuousTranscriber(setup["pipe"], batch_size=2, block_steps=2,
                               max_new_tokens=6)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(tr.engine, "step", boom)
    tr.start()
    try:
        with pytest.raises(RuntimeError, match="injected"):
            tr.submit(tone(1.0, 300.0, 0), language="en", timeout=120)
        with pytest.raises(RuntimeError, match="worker crashed"):
            tr.submit(tone(1.0, 300.0, 0), language="en", timeout=120)
    finally:
        tr.stop()


# ----------------------------------------------------------------------
# sampled lanes
# ----------------------------------------------------------------------


def test_engine_sampled_lanes_mixed_with_greedy(setup):
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=10,
                               block_steps=3).start()
    try:
        wav_g, wav_s = tone(1.0, 220.0, 3), tone(1.3, 410.0, 4)
        sampled = dict(wav=wav_s, language="en", temperature=0.9, top_k=8,
                       seed=11)
        out = submit_all(tr, [dict(wav=wav_g, language="en"), sampled],
                         stagger=0.0)
        # the greedy neighbour is unchanged
        assert out[0] == _expected(pipe, wav_g, 10)
        # the same seed reproduces, alone and beside another lane
        alone = submit_all(tr, [sampled])[0]
        beside = submit_all(tr, [dict(sampled), dict(wav=wav_g,
                                                     language="en")],
                            stagger=0.0)[0]
        assert out[1] == alone == beside
        # another seed draws other tokens
        other = submit_all(tr, [dict(sampled, seed=12)])[0]
        assert other != alone
        # temperature -> 0 collapses onto the greedy tokens
        near = tr.submit(wav_g, language="en", temperature=1e-4, seed=9,
                         timeout=600)
        assert near == out[0]
        assert tr.stats["sampled"] >= 5
        with pytest.raises(ValueError, match="top_k_max"):
            tr.submit(wav_g, language="en", temperature=0.7,
                      top_k=tr.engine.k_max + 1)
    finally:
        tr.stop()


def test_sampled_draws_follow_the_categorical_law():
    """Gumbel-max over the hashed uniforms draws each token at its
    probability (20000 draws, |frequency - p| < 0.015, about 4 standard
    errors), never outside the top k, and the uniforms are the same for the
    same (seed, gen_idx) in any batch."""
    n, v = 20000, 6
    logits = torch.log(torch.tensor([0.4, 0.25, 0.15, 0.1, 0.06, 0.04]))
    scores = logits.expand(n, v)
    gen_idx = torch.arange(n)
    lo, hi = torch.full((n,), 1234), torch.full((n,), 7)
    for k, probs in ((0, torch.softmax(logits, 0)),
                     (3, torch.softmax(logits[:3], 0))):
        draws = sample_lanes(scores, torch.ones(n), torch.full((n,), k),
                             lo, hi, gen_idx, k_max=4)
        freq = torch.bincount(draws, minlength=v).float() / n
        want = torch.zeros(v)
        want[:len(probs)] = probs
        assert (freq - want).abs().max() < 0.015, (k, freq, want)
    u = sample_uniforms(lo, hi, gen_idx, 50)
    assert 0 < u.min() and u.max() < 1
    sub = sample_uniforms(lo[7:9], hi[7:9], gen_idx[7:9], 50)
    assert torch.equal(sub, u[7:9])
    assert not torch.equal(sample_uniforms(lo + 1, hi, gen_idx, 50), u)


# ----------------------------------------------------------------------
# speculative lanes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_engine_speculative_matches_greedy(setup, method):
    """Speculative lanes emit the greedy tokens under staggered admission
    and mixed budgets; timestamped requests ride the same lanes."""
    pipe = setup["pipe"]
    kw = (dict(assistant=setup["draft"]) if method == "draft"
          else dict(ngram_speculative=True, max_ngram=2))
    tr = ContinuousTranscriber(pipe, batch_size=2, block_steps=4,
                               max_new_tokens=10, gamma=3, **kw).start()
    try:
        waves = [tone(1.0, f, i)
                 for i, f in enumerate((270.0, 340.0, 410.0, 520.0))]
        budgets = [10, 5, 8, 10]
        out = submit_all(tr, [dict(wav=w, language="en", max_new_tokens=b)
                              for w, b in zip(waves, budgets)], stagger=0.3)
        for w, b, o in zip(waves, budgets, out):
            assert o == _expected(pipe, w, b)
        ts = tr.submit(waves[0], language="en", return_timestamps=True,
                       timeout=600)
        assert ts == _expected(pipe, waves[0], 10, ts=True)
        assert tr.stats["ts_fallback"] == 0
        snap = tr.snapshot()["speculative"]
        assert snap["method"] == method and snap["gamma"] == 3
        if method == "draft":
            assert tr.stats["drafted"] > 0
        assert 0 <= tr.stats["accepted"] <= tr.stats["drafted"]
    finally:
        tr.stop()


@pytest.mark.parametrize("accept", [1.0, 0.0])
def test_engine_synthetic_acceptance_pins_rate(setup, accept):
    tr = ContinuousTranscriber(setup["pipe"], batch_size=2, block_steps=4,
                               max_new_tokens=9, assistant=setup["draft"],
                               gamma=3, synthetic_acceptance=accept).start()
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


def test_synthetic_coin_hash_equals_jax():
    """The engine's coins and periodic oracle are JAX's uint32 formulas
    (serving_engine.py's ``_agree`` and ``_oracle_p``) on a grid of
    (position, lane)."""
    pos = np.arange(0, 4096, 7, dtype=np.int32)
    lanes = np.arange(16, dtype=np.int32)
    p, lane = (a.ravel() for a in np.meshgrid(pos, lanes, indexing="ij"))
    h = (jnp.asarray(p).astype(jnp.uint32) * jnp.uint32(2654435761)
         + jnp.asarray(lane).astype(jnp.uint32) * jnp.uint32(97423))
    u = (h >> jnp.uint32(8)).astype(jnp.float32) / jnp.float32(2 ** 24)
    for prob in (0.0, 0.3, 0.8, 1.0):
        ours = synthetic_agree(torch.from_numpy(p).long(),
                               torch.from_numpy(lane).long(), prob)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(u < prob))
    want = (((jnp.asarray(p) + 31 * jnp.asarray(lane)) % 16)
            * jnp.int32(131) % jnp.int32(389)) % 400 + 10
    got = periodic_oracle(torch.from_numpy(p).long(),
                          torch.from_numpy(lane).long(), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_ngram_periodic_oracle_accepts(setup):
    tr = ContinuousTranscriber(setup["pipe"], batch_size=2, block_steps=4,
                               max_new_tokens=24, ngram_speculative=True,
                               gamma=3, max_ngram=2,
                               synthetic_period=6).start()
    try:
        tr.submit(tone(1.0, 290.0, 31), language="en", timeout=600)
        assert tr.stats["drafted"] > 0
        assert tr.stats["accepted"] > 0, tr.stats
    finally:
        tr.stop()


def test_engine_speculative_routes_sampling_to_fallback(setup):
    pipe = setup["pipe"]
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=8,
                               block_steps=3, assistant=setup["draft"],
                               gamma=3).start()
    try:
        wav = tone(1.0, 330.0, 5)
        a = tr.submit(wav, language="en", temperature=0.8, seed=21,
                      timeout=600)
        b = tr.submit(wav, language="en", temperature=0.8, seed=21,
                      timeout=600)
        assert a == b
        assert tr.stats["sampled_fallback"] == 2
        assert tr.submit(wav, language="en", timeout=600) == \
            _expected(pipe, wav, 8)
        assert tr.stats["drafted"] > 0
    finally:
        tr.stop()


# ----------------------------------------------------------------------
# adaptive gamma (tests/test_adaptive_gamma.py on the engine)
# ----------------------------------------------------------------------


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


@pytest.mark.parametrize("accept,levels_end", [(0.95, 8), (0.05, 2)])
def test_engine_controller_moves_gamma(setup, accept, levels_end):
    """High acceptance with a cheap draft raises gamma to the top rung; low
    acceptance drops it to the bottom."""
    pipe = _spec_pipe(setup, 48)
    kw = dict(draft_cost=0.05) if accept > 0.5 else {}
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=48,
                               block_steps=10, assistant=setup["draft"],
                               gamma=4, adaptive_gamma=True,
                               synthetic_acceptance=accept, **kw).start()
    try:
        assert tr._gamma_levels == [2, 4, 8]
        _drive(tr, 6, 48)
        key = "gamma_raises" if accept > 0.5 else "gamma_drops"
        assert tr.stats[key] >= 1, tr.stats
        assert tr.stats["gamma_current"] == levels_end, tr.stats
        snap = tr.snapshot()["speculative"]
        assert snap["adaptive"] is True
        assert snap["gamma_current"] == levels_end
    finally:
        tr.stop()


def test_engine_identity_across_gamma_switches(setup):
    """Real draft, controller on: random weights rarely agree, so gamma
    drops mid-traffic; every output still equals the pipeline's greedy."""
    pipe = _spec_pipe(setup, 8)
    tr = ContinuousTranscriber(pipe, batch_size=2, max_new_tokens=8,
                               block_steps=6, assistant=setup["draft"],
                               gamma=4, adaptive_gamma=True).start()
    try:
        out = _drive(tr, 6, 8)
        for i, o in enumerate(out):
            assert o == _expected(pipe, tone(1.0, 200.0 + 30 * i, seed=i), 8)
        assert tr.stats["gamma_drops"] >= 1, tr.stats
    finally:
        tr.stop()
