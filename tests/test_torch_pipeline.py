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
    """Beam search and word timestamps are ported now (held against JAX in
    tests/test_torch_beam.py and test_torch_word_timestamps.py); speculative
    decoding, in the pipeline and in sequential long-form, still raises."""
    from distil_whisper_tpu_torch.generation import SequentialTranscriber
    _, tpipe = pipes
    with pytest.raises(NotImplementedError):
        WhisperPipeline(None, dtype=torch.float32, params=tpipe.params,
                        cfg=tpipe.cfg, tokenizer=tpipe.tokenizer,
                        speculative_method="ngram", device="cpu")
    with pytest.raises(NotImplementedError):
        SequentialTranscriber(tpipe.params, tpipe.cfg, tpipe.tokenizer,
                              speculative_method="draft", device="cpu")
