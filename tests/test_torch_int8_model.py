"""Port int8 inference stack vs the JAX package (CPU, fp32, test-tiny
widths): quantized encode, int8 self-KV / cross-KV decode, the int8 lm head,
and greedy generation with all five int8 flags.

Both sides get one quantized tree (JAX quantizes, ``torch_params``
converts) except where the port's own quantization is the subject.  On the
CPU both take the unfused int8 MLP (``dense_int8 -> gelu -> dense_int8``),
JAX because its Pallas path is TPU-only, the port because its kernel is
CUDA-only; the integer products are exact on both sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import np_tree_equal, to_numpy_tree, torch_params
import distil_whisper_tpu.models.whisper as JW
from distil_whisper_tpu.config import PRESETS as JPRESETS
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import encode_and_generate as j_generate
from distil_whisper_tpu.models import init_params as j_init_params
from distil_whisper_tpu.ops import quant as JQ
from distil_whisper_tpu_torch.config import PRESETS
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                  encode_and_generate)
from distil_whisper_tpu_torch.models import whisper as TW
from distil_whisper_tpu_torch.ops import quant as TQ

CFG, JCFG = PRESETS["test-tiny"], JPRESETS["test-tiny"]
INT8 = dict(quantize_encoder=True, quantize_decoder=True,
            quantize_lm_head=True, quantize_cross_kv=True,
            quantize_self_kv=True)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def setup():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    jq = JQ.maybe_quantize_encoder(jp, JCFG.replace(**INT8))
    rng = np.random.default_rng(5)
    mel = (0.5 * rng.standard_normal((2, 80, 3000))).astype(np.float32)
    return jp, jq, torch_params(jq), mel


@pytest.mark.parametrize("flash", [False, True])
def test_quantized_encode_matches_jax(setup, flash):
    """JAX ``encode`` on the quantized encoder (its CPU path: attention_block
    with int8 projections) against the port with the fused attention (plain
    attention on the CPU) off and on.  The int8 products are exact; fp32
    LayerNorm, gelu and attention round in another order, which can move a
    requantization quantum: relative L2 <= 1e-4, max abs <= 2e-3."""
    _, jq, tq, mel = setup
    golden = np.asarray(JW.encode(jq["encoder"], JCFG, jnp.asarray(mel)))
    ours = TW.encode(tq["encoder"], CFG.replace(use_flash_encoder=flash),
                     torch.from_numpy(mel)).numpy()
    assert ours.shape == golden.shape == (2, 1500, 64)
    assert _rel_l2(ours, golden) <= 1e-4
    np.testing.assert_allclose(ours, golden, atol=2e-3)


@pytest.mark.parametrize("depth", [2, 5])
def test_int8_caches_decode_matches_jax(depth):
    """int8 decoder weights, int8 cross K/V and the int8 self-KV cache:
    prefill, then four cached single-token steps (depth 5 is JAX's deep
    carry branch; the port's layer loop serves both).  Logits within 1e-4;
    the int8 cache bytes and scales equal JAX's (a byte may differ by one
    where fp32 rounding ties, at most 1 in 1000)."""
    cfg = CFG.replace(decoder_layers=depth, quantize_cross_kv=True,
                      quantize_self_kv=True)
    jcfg = JCFG.replace(decoder_layers=depth, quantize_cross_kv=True,
                        quantize_self_kv=True)
    jdec = JQ.quantize_decoder_params(
        j_init_params(jcfg, jax.random.PRNGKey(depth))["decoder"])
    tdec = torch_params(jdec)
    rng = np.random.default_rng(7)
    enc = (0.3 * rng.standard_normal((2, 1500, 64))).astype(np.float32)
    jcross = JW.cross_kv(jdec, jcfg, jnp.asarray(enc))
    tcross = TW.cross_kv(tdec, cfg, torch.from_numpy(enc))
    _assert_int8_equal(tcross, jcross)
    jcache = JW.init_cache(jcfg, 2, max_len=16)
    tcache = TW.init_cache(cfg, 2, max_len=16)
    assert tcache["k_q"].dtype == torch.int8
    toks = rng.integers(0, 51865, size=(2, 3))
    for step, tok in enumerate([toks] + [toks[:, :1] + i for i in range(4)]):
        pos = 0 if step == 0 else 2 + step
        golden, jcache = JW.decode(jdec, jcfg, jnp.asarray(tok), cross=jcross,
                                   cache=jcache, pos_offset=pos)
        ours, tcache = TW.decode(tdec, cfg, torch.from_numpy(tok),
                                 cross=tcross, cache=tcache, pos_offset=pos)
        np.testing.assert_allclose(ours.numpy(), np.asarray(golden),
                                   atol=1e-4, rtol=1e-4)
    _assert_int8_equal(tcache, jcache)


def _assert_int8_equal(ours, golden):
    assert sorted(ours) == sorted(golden)
    for name in ours:
        a, b = ours[name].numpy(), np.asarray(golden[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("batch", [8, 9, 2])
def test_int8_lm_head_matches_jax(setup, batch):
    """At batch 8 and 9 the int8 logits (gated on; 9 x 5 tokens are padded
    to a multiple of 8 for the int8 product); at batch 2 the exact tied
    embedding, equal to the port's own unquantized head."""
    jp, _, _, _ = setup
    jdec = JQ.quantize_lm_head_params(jp["decoder"])
    tdec = torch_params(jdec)
    rng = np.random.default_rng(11)
    enc = (0.3 * rng.standard_normal((batch, 1500, 64))).astype(np.float32)
    toks = rng.integers(0, 51865, size=(batch, 5))
    golden, _ = JW.decode(jdec, JCFG, jnp.asarray(toks), enc=jnp.asarray(enc))
    ours, _ = TW.decode(tdec, CFG, torch.from_numpy(toks),
                        enc=torch.from_numpy(enc))
    np.testing.assert_allclose(ours.numpy(), np.asarray(golden), atol=1e-4,
                               rtol=1e-4)
    exact = {k: v for k, v in tdec.items() if not k.startswith("tok_emb_")}
    plain, _ = TW.decode(exact, CFG, torch.from_numpy(toks),
                         enc=torch.from_numpy(enc))
    if batch < 8:
        assert torch.equal(ours, plain)
    else:
        assert not torch.equal(ours, plain)
        assert (ours.argmax(-1) == plain.argmax(-1)).float().mean() >= 0.9


# small vocabulary with the real tail layout (tests/test_torch_generate.py)
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300), **INT8)
GCFG, GJCFG = WhisperConfig(**ARCH), JConfig(**ARCH)


@pytest.mark.parametrize("timestamps", [False, True])
def test_full_int8_stack_greedy_token_identical(timestamps):
    """All five flags, batch 8 (the int8 lm head engages), 12 new tokens:
    JAX's ``encode_and_generate`` on ``maybe_quantize_encoder`` and the
    port's on its own quantization of the same weights give the same
    tokens."""
    jp = j_init_params(GJCFG, jax.random.PRNGKey(1))
    jq = JQ.maybe_quantize_encoder(jp, GJCFG)
    tq = TQ.maybe_quantize_encoder(torch_params(jp), GCFG)
    np_tree_equal(tq, torch_params(jq))
    rng = np.random.default_rng(3)
    mel = (0.5 * rng.standard_normal((8, 80, 3000))).astype(np.float32)
    prompt = [[3, 310, 320]] * 8
    kw = dict(max_new_tokens=12, return_timestamps=timestamps,
              no_speech_token_id=350)
    jout = j_generate(jq, GJCFG, jnp.asarray(mel), jnp.asarray(prompt),
                      JOpts.from_config(GJCFG, **kw))
    tout = encode_and_generate(tq, GCFG, mel, prompt,
                               GenerationOptions.from_config(GCFG, **kw),
                               device="cpu")
    js, ts = np.asarray(jout.sequences), tout.sequences.numpy()
    # A random tiny model's logits are nearly uniform, so two tokens can lie
    # within an int8 quantum (~1e-3) of each other, and fp32 rounding on one
    # side moves a quantum.  A row may part from JAX only there: the port's
    # raw logit gap at the first difference must be below 5e-3, and is
    # reported; every other row is identical.
    parted = []
    for r in np.flatnonzero((js != ts).any(axis=1)):
        c = int(np.argmax(js[r] != ts[r]))
        gap = _port_logit_gap(tq, mel, prompt, ts, r, c, js[r, c])
        parted.append((int(r), c, int(js[r, c]), int(ts[r, c]), gap))
    assert all(abs(g) < 5e-3 for *_, g in parted) and len(parted) <= 1, (
        f"rows part from JAX at (row, col, JAX token, port token, port logit "
        f"gap): {parted}")
    same = [r for r in range(8) if r not in {p[0] for p in parted}]
    np.testing.assert_array_equal(tout.seq_len.numpy()[same],
                                  np.asarray(jout.seq_len)[same])
    # requantization quanta that fp32 rounding moves (int8 logits, ~1e-3 a
    # logit) show in the sum of 12 log-probs of about -6.6 each
    np.testing.assert_allclose(tout.sum_logprobs.numpy()[same],
                               np.asarray(jout.sum_logprobs)[same], rtol=1e-4)
    assert tout.sequences.shape == (8, 15)


def _port_logit_gap(tq, mel, prompt, seq, row, col, other):
    """Replay the port's cached greedy decode up to ``col`` and return its
    raw logit of its own token minus that of ``other`` in ``row``."""
    enc = TW.encode(tq["encoder"], GCFG, torch.from_numpy(mel))
    cross = TW.cross_kv(tq["decoder"], GCFG, enc)
    p = len(prompt[0])
    cache = TW.init_cache(GCFG, len(prompt), max_len=seq.shape[1])
    logits, cache = TW.decode(tq["decoder"], GCFG, torch.tensor(prompt),
                              cross=cross, cache=cache)
    for pos in range(p, col):
        logits, cache = TW.decode(tq["decoder"], GCFG,
                                  torch.from_numpy(seq[:, pos:pos + 1]),
                                  cross=cross, cache=cache, pos_offset=pos)
    last = logits[row, -1]
    return float(last[seq[row, col]] - last[other])
