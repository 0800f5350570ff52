"""Port WhisperPipeline vs the JAX pipeline (CPU, fp32) on the tiny random
checkpoint: equal text short-form and chunked, equal timestamped chunks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
from distil_whisper_tpu_torch.pipeline import WhisperPipeline

SR = 16000


def _tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (220 + 60 * np.sin(0.5 * t)) * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    from helpers import make_tiny_checkpoint
    ck = make_tiny_checkpoint(tmp_path_factory.mktemp("pipe") / "tiny")
    jpipe = JPipeline(ck, dtype=jnp.float32, batch_size=8, max_new_tokens=24)
    tpipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=8,
                            max_new_tokens=24, device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("seconds", [5.0, 70.0])
def test_text_matches_jax(pipes, seconds):
    jpipe, tpipe = pipes
    audio = _tone(seconds, 0)
    golden = jpipe(audio, language="en")
    ours = tpipe(audio, language="en")
    assert ours == golden
    assert isinstance(ours["text"], str)


@pytest.mark.parametrize("seconds", [5.0, 70.0])
def test_timestamped_chunks_match_jax(pipes, seconds):
    jpipe, tpipe = pipes
    audio = _tone(seconds, 1)
    golden = jpipe(audio, language="en", return_timestamps=True)
    ours = tpipe(audio, language="en", return_timestamps=True)
    assert ours["text"] == golden["text"]
    assert ours["chunks"] == golden["chunks"]


def test_language_detection_matches_jax(pipes):
    jpipe, tpipe = pipes
    audio = _tone(4.0, 2)
    assert tpipe(audio) == jpipe(audio)


@pytest.mark.parametrize("language", ["en", None])
def test_list_input_matches_one_by_one(pipes, language):
    """A list of audios shares batches of windows (and of language
    detection); each result equals the single-file call."""
    _, tpipe = pipes
    audios = [_tone(4.0, 3), _tone(40.0, 4), _tone(9.0, 5)]
    together = tpipe(audios, language=language, batch_size=2)
    assert together == [tpipe(a, language=language) for a in audios]


def test_not_yet_ported_options_raise(pipes):
    """Beam search, word timestamps and speculative decoding are ported now;
    what raises is JAX's argument errors for speculation, in the pipeline
    and in sequential long-form: an unknown method, a draft without an
    assistant, an assistant beside the n-gram method, and speculation with
    beam search."""
    from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                      SequentialTranscriber)
    _, tpipe = pipes
    common = dict(params=tpipe.params, cfg=tpipe.cfg,
                  tokenizer=tpipe.tokenizer, device="cpu")
    assistant = (tpipe.params, tpipe.cfg)
    for kw in (dict(speculative_method="nope"),
               dict(speculative_method="draft"),
               dict(speculative_method="ngram", assistant=assistant)):
        with pytest.raises(ValueError):
            WhisperPipeline(None, dtype=torch.float32, **common, **kw)
        with pytest.raises(ValueError):
            SequentialTranscriber(tpipe.params, tpipe.cfg, tpipe.tokenizer,
                                  device="cpu", **kw)
    with pytest.raises(ValueError):
        SequentialTranscriber(tpipe.params, tpipe.cfg, tpipe.tokenizer,
                              SequentialOptions(num_beams=2),
                              speculative_method="ngram", device="cpu")
    WhisperPipeline(None, dtype=torch.float32, **common,
                    speculative_method="ngram")
    SequentialTranscriber(tpipe.params, tpipe.cfg, tpipe.tokenizer,
                          speculative_method="draft", assistant=assistant,
                          device="cpu")


# ----------------------------------------------------------------------
# speculative decoding of the greedy windows (tests/test_longform.py's
# identity cases): the same result as the plain port pipeline and as JAX's
# n-gram speculative pipeline, and for the n-gram method JAX's acceptance
# counts (the draft's counters part from JAX's on purpose, see
# test_torch_speculative.py::test_reference_draft_reads_stale_slots)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec(pipes):
    from distil_whisper_tpu.training import init_student_from_teacher
    from torch_port_helpers import torch_params
    jpipe, tpipe = pipes
    jdraft, _ = init_student_from_teacher(jpipe.params, jpipe.cfg,
                                          decoder_layers=1)
    audio = _tone(70.0, 6)
    jspec = JPipeline(None, params=jpipe.params, cfg=jpipe.cfg,
                      tokenizer=jpipe.tokenizer, dtype=jnp.float32,
                      batch_size=2, max_new_tokens=12,
                      speculative_method="ngram", gamma=3, max_ngram=2)
    golden = (jspec(audio, language="en", return_timestamps=True),
              dict(jspec.spec_stats))
    draft = (torch_params(jdraft), tpipe.cfg.replace(decoder_layers=1))
    return audio, golden, draft


@pytest.mark.parametrize("method", ["ngram", "draft"])
def test_speculative_matches_plain_and_jax(pipes, spec, method):
    _, tpipe = pipes
    audio, golden, draft = spec
    common = dict(params=tpipe.params, cfg=tpipe.cfg,
                  tokenizer=tpipe.tokenizer, dtype=torch.float32,
                  batch_size=2, max_new_tokens=12, device="cpu")
    plain = WhisperPipeline(None, **common)
    ours = WhisperPipeline(None, **common, speculative_method=method, gamma=3,
                           max_ngram=2,
                           assistant=draft if method == "draft" else None)
    result = ours(audio, language="en", return_timestamps=True)
    assert result == plain(audio, language="en", return_timestamps=True)
    assert result == golden[0]
    if method == "ngram":
        assert ours.spec_stats == golden[1]
    stats = ours.spec_stats
    assert 0 <= stats["accepted"] <= stats["drafted"] and stats["drafted"] > 0
