"""Port sequential long-form vs the JAX package (CPU, fp32).

Segments (tokens, text, start and end to 1e-6) equal JAX's at temperature
0, with condition-on-prev, with an initial prompt and with beam search at
the t = 0 rung.  The temperature ladder's decisions (accept, fallback,
silence skip, prompt reset, the trailing double-timestamp drop) are held
on canned window outputs given to both transcribers: sampled rungs cannot
match JAX draw for draw.
"""

import numpy as np
import jax
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.audio.mel import log_mel_spectrogram
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation.sequential import (
    SequentialOptions as JSeqOpts, SequentialTranscriber as JTranscriber)
from distil_whisper_tpu.tokenizer import WhisperTokenizer as JTokenizer
from distil_whisper_tpu.tokenizer.bpe import ByteLevelBPE as JBPE
from distil_whisper_tpu.tokenizer.bpe import bytes_to_unicode
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                  SequentialTranscriber,
                                                  compression_ratio)
from distil_whisper_tpu_torch.tokenizer import WhisperTokenizer
from distil_whisper_tpu_torch.tokenizer.bpe import ByteLevelBPE

EOS, TS0 = 300, 401
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=EOS,
            decoder_start_token_id=3, begin_suppress_tokens=())
# the test vocabulary's layout: <|notimestamps|> 400, timestamps from 401
ADDED = {"<|endoftext|>": EOS, "<|startoftranscript|>": 3,
         "<|startofprev|>": 390, "<|nospeech|>": 399,
         "<|notimestamps|>": 400}
VOCAB = {u: i for i, u in enumerate(bytes_to_unicode().values())}

# name: (options, initial prompt tokens)
CASES = {
    "greedy": (dict(), None),
    "condition_on_prev": (dict(condition_on_prev_tokens=True), None),
    "initial_prompt": (dict(condition_on_prev_tokens=True), [72, 101, 32, 98]),
    "beam2": (dict(num_beams=2), None),
}


def _transcriber(jax_side, params, **kw):
    if jax_side:
        return JTranscriber(params, JConfig(**ARCH), JTokenizer(JBPE(VOCAB, []),
                                                                ADDED),
                            JSeqOpts(**kw), batch_size=2)
    return SequentialTranscriber(params, WhisperConfig(**ARCH),
                                 WhisperTokenizer(ByteLevelBPE(VOCAB, []), ADDED),
                                 SequentialOptions(**kw), batch_size=2,
                                 device="cpu")


def _segments(results):
    return [[(s["tokens"], s["text"], s["start"], s["end"], s["temperature"])
             for s in r["segments"]] for r in results]


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert [s[:2] for s in o] == [s[:2] for s in r]
        assert [s[4] for s in o] == [s[4] for s in r]
        np.testing.assert_allclose([s[2:4] for s in o], [s[2:4] for s in r],
                                   atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jp = jax_init_params(JConfig(**ARCH), 5)
    rng = np.random.default_rng(6)
    # two files of 70 s and 45 s: the 45 s file ends first and leaves a
    # ragged group of one
    feats = [np.array(log_mel_spectrogram(
        (0.1 * rng.standard_normal(int(sec * 16000))).astype(np.float32),
        JConfig(**ARCH), pad_to_chunk=False)[0]) for sec in (70.0, 45.0)]
    golden, transcribers = {}, {}
    for case, (kw, prompt) in CASES.items():
        opts = dict(temperatures=(0.0,), max_new_tokens=40, **kw)
        key = tuple(sorted(opts.items()))
        if key not in transcribers:   # one JAX program per prompt layout
            transcribers[key] = _transcriber(True, jp, **opts)
        golden[case] = _segments(transcribers[key].transcribe(
            feats, initial_prompt_tokens=prompt))
    return torch_params(jp), feats, golden


@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_match_jax(setup, case):
    tp, feats, golden = setup
    kw, prompt = CASES[case]
    tr = _transcriber(False, tp, temperatures=(0.0,), max_new_tokens=40, **kw)
    ours = _segments(tr.transcribe(feats, initial_prompt_tokens=prompt))
    assert sum(len(r) for r in ours) > 2, "too few segments to hold anything"
    _assert_same(ours, golden[case])


# ----------------------------------------------------------------------
# the ladder on canned window outputs
# ----------------------------------------------------------------------


def _canned_window_outputs():
    """A stand-in for ``_run_window``: each row's outcome (accepted, low
    logprob, repetitive text, silence; segment layout ending on one or two
    timestamps) is drawn from a seed made of the call number, the row, the
    rung and the row's prompt, so that two transcribers that make the same
    calls get the same outputs and two that differ part at once."""
    calls = [0]

    def run(mels, prompts, pads, temperature, rng):
        calls[0] += 1
        n = len(prompts)
        out = {"sequences": np.zeros((n, 448), np.int64),
               "seq_len": np.zeros(n, np.int64),
               "sum_logprobs": np.zeros(n, np.float32),
               "no_speech_prob": np.zeros(n, np.float32)}
        for row in range(n):
            prompt = [int(t) for t in prompts[row]]
            seed = [calls[0], row, int(round(100 * temperature)),
                    sum(prompt) % 9973, int(pads[row])]
            r = np.random.default_rng(seed)
            kind = r.choice(["good", "lowlogprob", "lowlogprob",
                             "repetitive", "silence"])
            if kind == "repetitive":
                gen = [TS0] + [97] * 60 + [TS0 + 300, EOS]
            else:
                gen, t = [], int(r.integers(0, 40))
                for _ in range(int(r.integers(1, 4))):
                    gen += [TS0 + t] + list(r.integers(33, 120, 5))
                    t += int(r.integers(20, 400))
                    gen += [TS0 + t]
                if r.random() < 0.5:      # a single ending timestamp
                    gen += list(r.integers(33, 120, 3)) + [TS0 + t + 10]
                gen.append(EOS)
            seq = prompt + gen
            out["sequences"][row, :len(seq)] = seq
            out["seq_len"][row] = len(seq)
            per_token = {"lowlogprob": -1.6, "silence": -1.3}.get(kind, -0.2)
            out["sum_logprobs"][row] = per_token * len(gen) - r.random()
            out["no_speech_prob"][row] = 0.9 if kind == "silence" else 0.01
        return out

    return run


@pytest.mark.parametrize("condition_on_prev", [False, True])
def test_ladder_decisions_match_jax(setup, condition_on_prev):
    tp, _, _ = setup
    feats = [np.zeros((80, frames), np.float32)
             for frames in (7000, 4500, 3100, 9000, 500)]
    kw = dict(condition_on_prev_tokens=condition_on_prev, max_new_tokens=40)
    results = []
    for jax_side in (True, False):
        # the canned windows never read the JAX transcriber's params
        tr = _transcriber(jax_side, None if jax_side else tp, **kw)
        tr._run_window = _canned_window_outputs()
        results.append(tr.transcribe(feats))
    golden, ours = results
    temps = {s["temperature"] for r in ours for s in r["segments"]}
    assert len(temps) >= 3, f"the canned ladder took too few rungs: {temps}"
    for o, g in zip(ours, golden):
        assert o["text"] == g["text"]
        assert len(o["segments"]) == len(g["segments"])
        for so, sg in zip(o["segments"], g["segments"]):
            assert so.keys() == sg.keys()
            for key in so:
                assert so[key] == pytest.approx(sg[key], abs=1e-6), key


def test_compression_ratio_matches_jax():
    from distil_whisper_tpu.generation.sequential import (
        compression_ratio as j_ratio)
    for text in ("", "hello world", "a" * 200, "the cat sat on the mat " * 5):
        assert compression_ratio(text) == j_ratio(text)


# ----------------------------------------------------------------------
# speculation at the temperature-0 rung (tests/test_longform.py's
# sequential identity cases): condition-on-prev prompts, left-padded, with
# a ragged last group
# ----------------------------------------------------------------------

SPEC_OPTS = dict(temperatures=(0.0,), max_new_tokens=16,
                 condition_on_prev_tokens=True)


@pytest.fixture(scope="module")
def spec_golden(setup):
    """JAX's n-gram speculative transcriber (its segments are JAX's greedy
    rung's) and its counters, and a 1-layer draft for the port."""
    from distil_whisper_tpu.training import init_student_from_teacher
    _, feats, _ = setup
    jp = jax_init_params(JConfig(**ARCH), 5)
    jdraft, _ = init_student_from_teacher(jp, JConfig(**ARCH),
                                          decoder_layers=1)
    tr = JTranscriber(jp, JConfig(**ARCH), JTokenizer(JBPE(VOCAB, []), ADDED),
                      JSeqOpts(**SPEC_OPTS), batch_size=2,
                      speculative_method="ngram", gamma=3, max_ngram=2)
    return (_segments(tr.transcribe(feats)), dict(tr.spec_stats)), \
        torch_params(jdraft)


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_speculative_rung_matches_plain_and_jax(setup, spec_golden, method):
    """The speculative t = 0 rung gives the plain rung's segments and JAX's,
    and for the n-gram method JAX's counters (the draft's part from JAX's
    on purpose, see
    test_torch_speculative.py::test_reference_draft_reads_stale_slots)."""
    tp, feats, _ = setup
    golden, draft = spec_golden
    plain = _transcriber(False, tp, **SPEC_OPTS)
    assistant = (draft, WhisperConfig(**ARCH).replace(decoder_layers=1))
    tr = SequentialTranscriber(
        tp, WhisperConfig(**ARCH),
        WhisperTokenizer(ByteLevelBPE(VOCAB, []), ADDED),
        SequentialOptions(**SPEC_OPTS), batch_size=2, device="cpu",
        speculative_method=method, gamma=3, max_ngram=2,
        assistant=assistant if method == "draft" else None)
    ours = tr.transcribe(feats)
    reference = plain.transcribe(feats)
    assert _segments(ours) == _segments(reference)
    for o, r in zip(ours, reference):
        for so, sr in zip(o["segments"], r["segments"]):
            assert abs(so["avg_logprob"] - sr["avg_logprob"]) < 2e-3
            assert abs(so["no_speech_prob"] - sr["no_speech_prob"]) < 1e-5
    _assert_same(_segments(ours), golden[0])
    stats = tr.spec_stats
    if method == "ngram":
        assert stats == golden[1]
    else:
        assert stats["drafted"] == 3 * stats["rounds"]
    assert stats["rounds"] > 0 and 0 <= stats["accepted"] <= stats["drafted"]


def test_speculative_ladder_falls_back_to_sampling(setup):
    """Sampled rungs (t > 0) take the plain sampling path: a ladder whose
    t = 0 rung always fails ends on the sampled rung, and the speculative
    counters count the t = 0 rung's rows only."""
    tp, feats, _ = setup
    kw = dict(temperatures=(0.0, 1.0), max_new_tokens=12,
              compression_ratio_threshold=-1.0, logprob_threshold=None,
              no_speech_threshold=None)
    tr = SequentialTranscriber(
        tp, WhisperConfig(**ARCH),
        WhisperTokenizer(ByteLevelBPE(VOCAB, []), ADDED),
        SequentialOptions(**kw), batch_size=2, device="cpu",
        speculative_method="ngram")
    calls = []
    run = tr._run_window
    tr._run_window = lambda *a: calls.append(a[3]) or run(*a)
    results = tr.transcribe(feats[1:])
    segs = results[0]["segments"]
    assert segs and all(s["temperature"] == 1.0 for s in segs)
    assert calls and set(calls) == {0.0, 1.0}
    assert tr.spec_stats["rounds"] > 0
