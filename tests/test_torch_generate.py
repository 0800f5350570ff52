"""Port greedy generation vs the JAX package (CPU, fp32): token-identical
``sequences`` / ``seq_len`` and matching ``sum_logprobs`` / ``no_speech_prob``,
plus the logits processors position for position."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import encode_and_generate as j_generate
from distil_whisper_tpu.generation import logits as JL
from distil_whisper_tpu.models import init_params as j_init_params
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import GenerationOptions
from distil_whisper_tpu_torch.generation import encode_and_generate
from distil_whisper_tpu_torch.generation import logits as TL

# small vocabulary with the real tail layout: text < eos < specials <
# <|notimestamps|> (400) < 1501 timestamps (401..)
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
CFG, JCFG = WhisperConfig(**ARCH), JConfig(**ARCH)
PROMPT = [[3, 310, 320], [3, 310, 320]]


@pytest.fixture(scope="module")
def setup():
    jp = j_init_params(JCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    mel = (0.5 * rng.standard_normal((2, 80, 3000))).astype(np.float32)
    return jp, torch_params(jp), mel


CASES = {
    "plain": dict(max_new_tokens=24),
    "timestamps": dict(max_new_tokens=24, return_timestamps=True),
    "forced": dict(max_new_tokens=12, forced_decoder_ids=((3, 42), (5, 300)),
                   suppress_tokens=(7, 8), min_new_tokens=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_and_generate_token_identical(setup, case):
    jp, tp, mel = setup
    kw = dict(CASES[case], no_speech_token_id=350)
    jout = j_generate(jp, JCFG, jnp.asarray(mel), jnp.asarray(PROMPT),
                      JOpts.from_config(JCFG, **kw))
    tout = encode_and_generate(tp, CFG, mel, PROMPT,
                               GenerationOptions.from_config(CFG, **kw),
                               device="cpu")
    np.testing.assert_array_equal(tout.sequences.numpy(),
                                  np.asarray(jout.sequences))
    np.testing.assert_array_equal(tout.seq_len.numpy(),
                                  np.asarray(jout.seq_len))
    np.testing.assert_allclose(tout.sum_logprobs.numpy(),
                               np.asarray(jout.sum_logprobs), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(tout.no_speech_prob.numpy(),
                               np.asarray(jout.no_speech_prob), atol=1e-4)
    if case == "forced":   # EOS forced at position 5: rows stop, pad after
        seqs = tout.sequences.numpy()
        assert (seqs[:, 3] == 42).all() and (seqs[:, 5] == 300).all()
        assert (tout.seq_len.numpy() == 6).all()
        assert (seqs[:, 6:] == CFG.pad_token_id).all()


def test_sampling_not_ported_yet(setup):
    """Sampling is ported now (``tests/test_torch_sampling.py`` holds its
    distribution); this test keeps its name and checks what the JAX pipeline
    relies on: sampling at temperature 0 is greedy decoding."""
    _, tp, mel = setup
    sampled = encode_and_generate(
        tp, CFG, mel, PROMPT,
        GenerationOptions.from_config(CFG, max_new_tokens=12, do_sample=True),
        temperature=0.0, device="cpu")
    greedy = encode_and_generate(
        tp, CFG, mel, PROMPT,
        GenerationOptions.from_config(CFG, max_new_tokens=12), device="cpu")
    assert torch.equal(sampled.sequences, greedy.sequences)


def _scores(seed, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.vocab_size)).astype(np.float32) * 3


@pytest.mark.parametrize("gen_idx", [0, 1, 3])
def test_simple_processors_match_jax(gen_idx):
    s = _scores(gen_idx)
    pairs = [
        (JL.suppress_tokens(jnp.asarray(s), (5, 9, 1000)),
         TL.suppress_tokens(torch.from_numpy(s), (5, 9, 1000))),
        (JL.suppress_tokens_at_begin(jnp.asarray(s), gen_idx, (220, 300)),
         TL.suppress_tokens_at_begin(torch.from_numpy(s), gen_idx, (220, 300))),
        (JL.force_tokens(jnp.asarray(s), gen_idx, ((3, 17), (4, 18)), 1),
         TL.force_tokens(torch.from_numpy(s), gen_idx, ((3, 17), (4, 18)), 1)),
        (JL.min_new_tokens(jnp.asarray(s), gen_idx, 2, 300),
         TL.min_new_tokens(torch.from_numpy(s), gen_idx, 2, 300)),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(6))
def test_timestamp_rules_match_jax(seed):
    """Random FSM states (text / single / paired timestamps) at random
    generation indices: -inf lands on the same positions."""
    rng = np.random.default_rng(100 + seed)
    b = 8
    ts0 = CFG.timestamp_begin
    s = _scores(seed, b)
    s[:, ts0:] += rng.uniform(-6, 2)        # move the timestamp mass around
    prev = np.where(rng.random(b) < 0.5, rng.integers(ts0, ts0 + 200, b),
                    rng.integers(0, 300, b))
    prevprev = np.where(rng.random(b) < 0.5,
                        rng.integers(ts0, ts0 + 200, b),
                        rng.integers(0, 300, b))
    last_ts = np.where(rng.random(b) < 0.7, rng.integers(ts0, ts0 + 200, b), 0)
    for gen_idx in (0, 1, 2, 5):
        jstate = JL.TimestampState(jnp.asarray(prev, jnp.int32),
                                   jnp.asarray(prevprev, jnp.int32),
                                   jnp.asarray(last_ts, jnp.int32))
        tstate = TL.TimestampState(torch.from_numpy(prev),
                                   torch.from_numpy(prevprev),
                                   torch.from_numpy(last_ts))
        j = np.asarray(JL.timestamp_rules(jnp.asarray(s), gen_idx, jstate,
                                          JCFG))
        t = TL.timestamp_rules(torch.from_numpy(s), gen_idx, tstate,
                               CFG).numpy()
        np.testing.assert_array_equal(np.isneginf(t), np.isneginf(j))
        np.testing.assert_array_equal(t[~np.isneginf(t)], j[~np.isneginf(j)])


def test_timestamp_state_update_matches_jax():
    tok = np.array([5, CFG.timestamp_begin + 3, 300, CFG.timestamp_begin])
    j = JL.TimestampState.init(4).update(jnp.asarray(tok), CFG.timestamp_begin)
    j = j.update(jnp.asarray(tok[::-1].copy()), CFG.timestamp_begin)
    t = TL.TimestampState.init(4).update(torch.from_numpy(tok),
                                         CFG.timestamp_begin)
    t = t.update(torch.from_numpy(tok[::-1].copy()), CFG.timestamp_begin)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
