"""Port sampling and left-padded prompts (CPU, fp32).

Sampling cannot match JAX token for token (threefry keys against a torch
generator), so it is held by its distribution: a chi-square test of 20k
draws against softmax(s / T), top-k never leaving the k best, and one seed
reproducing its draws.  Greedy generation with ``pad_len`` / ``sot_slot``
prompts is held against JAX token for token, ``no_speech_prob`` to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import encode_and_generate as j_generate
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                  encode_and_generate)
from distil_whisper_tpu_torch.generation.generate import _select

ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
CFG, JCFG = WhisperConfig(**ARCH), JConfig(**ARCH)
# condition-on-prev layout: [pad | <|startofprev|> ctx | SOT ...], SOT at 3
PADDED = [[0, 0, 0, 3, 310, 320], [0, 390, 17, 3, 310, 320]]
PAD_LEN = [3, 1]
N_DRAWS = 20000


def _scores(vocab=40, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((2.0 * rng.standard_normal(vocab))
                            .astype(np.float32))


@pytest.mark.parametrize("temperature", [0.4, 1.0])
def test_draws_follow_the_tempered_softmax(temperature):
    s = _scores()
    opts = GenerationOptions(do_sample=True)
    gen = torch.Generator().manual_seed(11)
    draws = _select(s.expand(N_DRAWS, -1), temperature, gen, opts)
    counts = np.bincount(draws.numpy(), minlength=s.numel())
    p = torch.softmax(s / temperature, dim=-1).double().numpy()
    keep = p > 1e-3
    # categories below 1e-3 are pooled into one
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(p[keep], p[~keep].sum()) * N_DRAWS
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue > 1e-3


def test_top_k_never_leaves_the_k_best():
    s = _scores(seed=1)
    opts = GenerationOptions(do_sample=True, top_k=5)
    draws = _select(s.expand(N_DRAWS, -1), 1.5, torch.Generator().manual_seed(2),
                    opts)
    best = set(torch.topk(s, 5).indices.tolist())
    seen = set(draws.unique().tolist())
    assert seen <= best and len(seen) == 5


def test_one_seed_reproduces_its_draws():
    s = _scores(seed=2).expand(64, -1)
    opts = GenerationOptions(do_sample=True, top_k=10)
    a = _select(s, 0.8, torch.Generator().manual_seed(5), opts)
    b = _select(s, 0.8, torch.Generator().manual_seed(5), opts)
    c = _select(s, 0.8, torch.Generator().manual_seed(6), opts)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def setup():
    jp = jax_init_params(JCFG, 1)
    rng = np.random.default_rng(7)
    mel = (0.5 * rng.standard_normal((2, 80, 3000))).astype(np.float32)
    golden = {}
    for sot_slot in (3, None):
        kw = dict(max_new_tokens=16, return_timestamps=True,
                  no_speech_token_id=350)
        out = j_generate(jp, JCFG, jnp.asarray(mel), jnp.asarray(PADDED),
                         JOpts.from_config(JCFG, **kw),
                         pad_len=jnp.asarray(PAD_LEN), sot_slot=sot_slot)
        golden[sot_slot] = {f: np.asarray(getattr(out, f))
                            for f in out._fields}
    return torch_params(jp), mel, golden


@pytest.mark.parametrize("sot_slot", [3, None])
def test_padded_prompts_match_jax(setup, sot_slot):
    """Left-padded prompts: tokens identical; no_speech_prob read at
    ``sot_slot``, or at ``pad_len[b]`` without it."""
    tp, mel, golden = setup
    opts = GenerationOptions.from_config(CFG, max_new_tokens=16,
                                         return_timestamps=True,
                                         no_speech_token_id=350)
    out = encode_and_generate(tp, CFG, mel, PADDED, opts, pad_len=PAD_LEN,
                              sot_slot=sot_slot, device="cpu")
    ref = golden[sot_slot]
    np.testing.assert_array_equal(out.sequences.numpy(), ref["sequences"])
    np.testing.assert_array_equal(out.seq_len.numpy(), ref["seq_len"])
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               ref["no_speech_prob"], atol=1e-6)
    np.testing.assert_allclose(out.sum_logprobs.numpy(), ref["sum_logprobs"],
                               atol=1e-4, rtol=1e-5)


def test_sampled_generation_is_reproducible(setup):
    """generate() samples from the generator it is given: one seed gives one
    sequence, another seed another; the prompt stays in place."""
    tp, mel, _ = setup
    opts = GenerationOptions.from_config(CFG, max_new_tokens=12,
                                         do_sample=True, top_k=50)

    def run(seed):
        return encode_and_generate(
            tp, CFG, mel, PADDED, opts, temperature=1.0, pad_len=PAD_LEN,
            generator=torch.Generator().manual_seed(seed),
            device="cpu").sequences

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a[:, :6].tolist() == PADDED
