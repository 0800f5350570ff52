"""Port word timestamps vs the JAX package (CPU, fp32): cross-attention
probabilities to 1e-5, the host helpers (median filter, DTW, token times)
equal on seeded inputs, and the pipeline's ``return_timestamps="word"``
words and times equal to the JAX pipeline's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import word_timestamps as JW
from distil_whisper_tpu.models.whisper import (
    cross_attention_weights as j_cross_weights)
from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import word_timestamps as TW
from distil_whisper_tpu_torch.models.whisper import cross_attention_weights
from distil_whisper_tpu_torch.pipeline import WhisperPipeline

ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=3, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3)
SR = 16000


@pytest.fixture(scope="module")
def weights_setup():
    cfg = JConfig(**ARCH)
    jp = jax_init_params(cfg, 3)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    tokens = rng.integers(0, 300, (2, 11))
    golden = np.asarray(j_cross_weights(jp["decoder"], cfg,
                                        jnp.asarray(tokens),
                                        enc=jnp.asarray(enc)))
    return torch_params(jp), enc, tokens, golden


def test_cross_attention_weights_match_jax(weights_setup):
    tp, enc, tokens, golden = weights_setup
    ours = cross_attention_weights(tp["decoder"], WhisperConfig(**ARCH),
                                   torch.from_numpy(tokens),
                                   enc=torch.from_numpy(enc))
    assert ours.shape == golden.shape == (3, 2, 4, 11, 1500)
    np.testing.assert_allclose(ours.numpy(), golden, atol=1e-5)


def test_selected_heads_are_slices_of_the_full_tensor(weights_setup):
    """Heads kept layer by layer (in the caller's order) equal the slices
    of every layer's probabilities."""
    tp, enc, tokens, _ = weights_setup
    cfg = WhisperConfig(**ARCH)
    heads = ((2, 1), (1, 3), (2, 0))
    full = cross_attention_weights(tp["decoder"], cfg,
                                   torch.from_numpy(tokens),
                                   enc=torch.from_numpy(enc))
    sel = TW.selected_cross_weights(tp["decoder"], cfg,
                                    torch.from_numpy(tokens), heads,
                                    enc=torch.from_numpy(enc))
    want = torch.stack([full[l, :, h] for l, h in heads], dim=1)
    assert torch.equal(sel, want)


@pytest.mark.parametrize("seed", range(3))
def test_host_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    np.testing.assert_array_equal(TW.median_filter(x, 7),
                                  JW.median_filter(x, 7))
    cost = rng.standard_normal((9, 30))
    for a, b in zip(TW.dtw(cost), JW.dtw(cost)):
        np.testing.assert_array_equal(a, b)
    w = rng.random((2, 4, 14, 60)).astype(np.float32)
    kw = dict(num_input_ids=3, seq_lens=np.array([15, 9]),
              num_frames=[100, 80])
    np.testing.assert_array_equal(TW.token_timestamps_from_weights(w, **kw),
                                  JW.token_timestamps_from_weights(w, **kw))
    heads = TW.default_alignment_heads(WhisperConfig(**ARCH))
    assert heads == JW.default_alignment_heads(JConfig(**ARCH))


def _tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (220 + 60 * np.sin(0.5 * t)) * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    from helpers import make_tiny_checkpoint
    ck = make_tiny_checkpoint(tmp_path_factory.mktemp("words") / "tiny")
    jpipe = JPipeline(ck, dtype=jnp.float32, batch_size=8, max_new_tokens=24)
    tpipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=8,
                            max_new_tokens=24, device="cpu")
    audios = {"short": _tone(6.0, 1), "long": _tone(40.0, 2)}
    golden = {name: jpipe(a, language="en", return_timestamps="word")
              for name, a in audios.items()}
    return tpipe, audios, golden


@pytest.mark.parametrize("name", ["short", "long"])
def test_pipeline_words_match_jax(pipes, name):
    tpipe, audios, golden = pipes
    ours = tpipe(audios[name], language="en", return_timestamps="word")
    assert ours["chunks"], "no words: the test would hold nothing"
    assert ours == golden[name]


def test_words_batch_equals_one_by_one(pipes):
    tpipe, audios, golden = pipes
    wavs = [audios["short"], _tone(3.0, 5)]
    batch = tpipe.transcribe_words_batch(wavs, languages=["en", "en"])
    assert {k: v for k, v in batch[0].items() if k != "language"} \
        == golden["short"]
    one = tpipe(wavs[1], language="en", return_timestamps="word")
    assert {k: v for k, v in batch[1].items() if k != "language"} == one
