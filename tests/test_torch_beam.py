"""Port beam search vs the JAX package (CPU, fp32): token-identical
sequences and seq_len for K 2 and 4, with and without timestamps, with
left-padded prompts and with an int8 self-KV cache, through the blocked
loop (``encode_and_beam_search``) and the plain one
(``beam_search_eager``); scores, sum_logprobs and no_speech_prob to 1e-5.
K = 1 gives the greedy tokens."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation.beam import (
    encode_and_beam_search as j_beam)
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                  encode_and_beam_search,
                                                  encode_and_generate)
from distil_whisper_tpu_torch.generation.beam import beam_search_eager
from distil_whisper_tpu_torch.models import whisper as TW

# small vocabulary with the real tail layout: text < eos (300) < specials <
# <|notimestamps|> (400) < 1501 timestamps (401..)
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
PROMPT = [[3, 310, 320], [3, 310, 320]]
# condition-on-prev layout: [pad | <|startofprev|> ctx | SOT ...], SOT at 3
PADDED = [[0, 0, 0, 3, 310, 320], [0, 390, 17, 3, 310, 320]]
PAD_LEN, SOT_SLOT = [3, 1], 3

# name: (num_beams, timestamps, padded prompts, int8 self-KV); K 2 and 4
# each run with and without timestamps (one JAX compile a case)
CASES = {
    "k2": (2, False, False, False),
    "k4_timestamps": (4, True, False, False),
    "k2_pad_len_timestamps": (2, True, True, False),
    "k4_pad_len_int8_self_kv": (4, False, True, True),
}


def _eager_route(tp, cfg, mel, prompt, opts, **kw):
    """The plain loop on the port's encoder states."""
    enc = TW.encode(tp["encoder"], cfg, torch.from_numpy(mel))
    return beam_search_eager(tp["decoder"], cfg, enc, torch.tensor(prompt),
                             opts, **{k: torch.tensor(v) if k == "pad_len"
                                      else v for k, v in kw.items()})


def _run(case, jp, tp, mel, jax_side, route="blocked"):
    k, timestamps, padded, int8 = CASES[case]
    arch = dict(ARCH, quantize_self_kv=int8)
    kw = dict(max_new_tokens=20, return_timestamps=timestamps,
              no_speech_token_id=350)
    prompt = PADDED if padded else PROMPT
    extra = dict(pad_len=PAD_LEN, sot_slot=SOT_SLOT) if padded else {}
    if jax_side:
        cfg = JConfig(**arch)
        if padded:
            extra["pad_len"] = jnp.asarray(PAD_LEN)
        out = j_beam(jp, cfg, jnp.asarray(mel), jnp.asarray(prompt),
                     JOpts.from_config(cfg, **kw), num_beams=k, **extra)
        return {f: np.asarray(getattr(out, f)) for f in out._fields}
    cfg = WhisperConfig(**arch)
    opts = GenerationOptions.from_config(cfg, **kw)
    if route == "eager":
        out = _eager_route(tp, cfg, mel, prompt, opts, num_beams=k, **extra)
    else:
        out = encode_and_beam_search(tp, cfg, mel, prompt, opts,
                                     num_beams=k, device="cpu", **extra)
    return {f: getattr(out, f).numpy() for f in out._fields}


@pytest.fixture(scope="module")
def setup():
    jp = jax_init_params(JConfig(**ARCH), 1)
    rng = np.random.default_rng(7)
    mel = (0.5 * rng.standard_normal((2, 80, 3000))).astype(np.float32)
    # the random model never emits EOS; an EOS embedding turned round and
    # scaled by 3 makes hypotheses finish at different lengths, so the
    # finished set, the stop rule and the live-beam fallback all take part
    emb = np.asarray(jp["decoder"]["tok_emb"]).copy()
    emb[ARCH["eos_token_id"]] *= -3.0
    jp_eos = {**jp, "decoder": {**jp["decoder"], "tok_emb": jnp.asarray(emb)}}
    tp_eos = torch_params(jp_eos)
    golden = {case: _run(case, jp_eos, tp_eos, mel, True) for case in CASES}
    return torch_params(jp), (jp_eos, tp_eos), mel, golden


@pytest.mark.parametrize(
    "case,route", [(c, "blocked") for c in sorted(CASES)]
    + [(c, "eager") for c in sorted(CASES)],
    ids=sorted(CASES) + [f"{c}-eager" for c in sorted(CASES)])
def test_beam_search_matches_jax(setup, case, route):
    _, (jp, tp), mel, golden = setup
    ours, ref = _run(case, jp, tp, mel, False, route), golden[case]
    np.testing.assert_array_equal(ours["sequences"], ref["sequences"])
    np.testing.assert_array_equal(ours["seq_len"], ref["seq_len"])
    for field in ("scores", "sum_logprobs", "no_speech_prob"):
        np.testing.assert_allclose(ours[field], ref[field], atol=1e-5,
                                   rtol=1e-5, err_msg=field)


@pytest.mark.parametrize("timestamps", [False, True])
def test_one_beam_gives_the_greedy_tokens(setup, timestamps):
    """With no EOS inside the budget (the random model emits none), one beam
    follows the argmax path: the tokens of greedy generate()."""
    tp, _, mel, _ = setup
    cfg = WhisperConfig(**ARCH)
    opts = GenerationOptions.from_config(cfg, max_new_tokens=20,
                                         return_timestamps=timestamps)
    beam = encode_and_beam_search(tp, cfg, mel, PROMPT, opts, num_beams=1,
                                  device="cpu")
    greedy = encode_and_generate(tp, cfg, mel, PROMPT, opts, device="cpu")
    assert (greedy.sequences[:, 3:] != cfg.eos_token_id).all()
    assert torch.equal(beam.sequences, greedy.sequences)
    assert torch.equal(beam.seq_len, greedy.seq_len)
