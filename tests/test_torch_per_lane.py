"""Per-lane decode cursors of the port (CPU).

``decode`` takes ``pos_offset`` as a [B] tensor: each lane writes its K/V,
takes its positions and masks its attention at its own cursor, for any
number of new tokens, and together with ``pad_len``.  Held here:

* uniform per-lane cursors give the int cursor's logits and cache bit for
  bit (the same ops on the same values), in fp32 and in bf16 (whose
  single-token step takes ``decode_attention`` with a per-lane mask row),
  with and without the int8 self cache;
* lanes at staggered cursors equal solo batch-1 runs of each lane at 1e-6,
  with and without the int8 self cache;
* per-lane cursors with ``pad_len`` equal JAX's ``jax.vmap`` of a batch-1
  decode with a scalar cursor at 1e-6 (JAX never passes both to one call);
* ``causal_mask`` with a [B] offset equals JAX's;
* a cache write past the end raises, never clamps.

Every comparison here is deterministic: the port's own ops against each
other, or against one fixed JAX program at a tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models import whisper as JW
from distil_whisper_tpu.ops.attention import causal_mask as j_causal_mask
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.models import whisper as W
from distil_whisper_tpu_torch.ops.attention import causal_mask

ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=())
CFG, JCFG = WhisperConfig(**ARCH), JConfig(**ARCH)
B, T_CACHE, PREFILL = 3, 24, 8


@pytest.fixture(scope="module")
def setup():
    jp = jax_init_params(JCFG, 4)
    rng = np.random.default_rng(11)
    enc = (0.5 * rng.standard_normal((B, 40, 64))).astype(np.float32)
    toks = rng.integers(4, 290, (B, T_CACHE))
    # JAX's vmapped batch-1 decode with a scalar cursor and pad_len: the
    # left-padded prompt layout [pad.. | tokens], then a 3-token window at
    # each lane's own cursor
    pad = np.array([2, 0, 5])
    cur = np.array([8, 6, 10])
    win = rng.integers(4, 290, (B, 3))
    jcross = JW.cross_kv(jp["decoder"], JCFG, jnp.asarray(enc))

    def lane(cross, prompt, window, pad_len, pos):
        cross = jax.tree.map(lambda x: x[:, None], cross)
        cache = JW.init_cache(JCFG, 1, max_len=T_CACHE)
        _, cache = JW.decode(jp["decoder"], JCFG, prompt[None], cross=cross,
                             cache=cache, pos_offset=0,
                             pad_len=pad_len[None])
        logits, _ = JW.decode(jp["decoder"], JCFG, window[None], cross=cross,
                              cache=cache, pos_offset=pos,
                              pad_len=pad_len[None])
        return logits[0]

    prompts = toks[:, :12].copy()
    for b in range(B):
        prompts[b, :pad[b]] = 0
    golden = jax.jit(jax.vmap(lane, in_axes=(1, 0, 0, 0, 0)))(
        jcross, jnp.asarray(prompts), jnp.asarray(win), jnp.asarray(pad),
        jnp.asarray(cur))
    return dict(tp=torch_params(jp)["decoder"], enc=torch.from_numpy(enc),
                toks=torch.from_numpy(toks), prompts=torch.from_numpy(prompts),
                pad=torch.from_numpy(pad), cur=torch.from_numpy(cur),
                win=torch.from_numpy(win), golden=np.asarray(golden))


def _cfg(int8_cache):
    return CFG.replace(quantize_self_kv=int8_cache)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def test_causal_mask_per_lane_matches_jax():
    offset = np.array([0, 3, 7])
    ours = causal_mask(4, 12, torch.from_numpy(offset))
    assert ours.shape == (3, 1, 4, 12)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(j_causal_mask(4, 12, offset)))
    np.testing.assert_array_equal(causal_mask(4, 12, 3).numpy(),
                                  np.asarray(j_causal_mask(4, 12, 3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8_cache", [False, True])
def test_uniform_cursors_equal_int_cursor_bitwise(setup, dtype, int8_cache):
    cfg = _cfg(int8_cache)
    if dtype == torch.bfloat16:
        cfg = cfg.replace(fast_bf16_attention=True)
    dec = _cast(setup["tp"], dtype)
    cross = W.cross_kv(dec, cfg, setup["enc"].to(dtype))
    toks = setup["toks"]
    runs = []
    for per_lane in (False, True):
        cache = W.init_cache(cfg, B, dtype=dtype, max_len=T_CACHE)
        W.decode(dec, cfg, toks[:, :PREFILL], cross=cross, cache=cache,
                 pos_offset=0, dtype=dtype)
        out, pos = [], PREFILL
        for s in (1, 3, 1, 2):          # single-token steps and windows
            at = torch.full((B,), pos) if per_lane else pos
            logits, _ = W.decode(dec, cfg, toks[:, pos:pos + s], cross=cross,
                                 cache=cache, pos_offset=at, dtype=dtype)
            out.append(logits)
            pos += s
        runs.append((out, cache))
    (a, cache_a), (b, cache_b) = runs
    for la, lb in zip(a, b):
        assert torch.equal(la, lb)
    for name in cache_a:
        assert torch.equal(cache_a[name], cache_b[name]), name


@pytest.mark.parametrize("int8_cache", [False, True])
def test_staggered_lanes_equal_solo_runs(setup, int8_cache):
    """After a common prefill of 8 tokens the lanes move to cursors 8, 5
    and 11 (lane 1 drops three slots, as after a rejected verify window;
    lane 2 writes three more) and step by windows of 3, 1 and 3 tokens.
    Each lane's logits equal a batch-1 run of that lane alone that makes
    the same writes at an int cursor."""
    cfg = _cfg(int8_cache)
    dec, toks = setup["tp"], setup["toks"]
    cross = W.cross_kv(dec, cfg, setup["enc"])
    cache = W.init_cache(cfg, B, max_len=T_CACHE)
    W.decode(dec, cfg, toks[:, :PREFILL], cross=cross, cache=cache)
    writes = [[(0, PREFILL)] for _ in range(B)]
    cur = torch.tensor([5, 2, 8])
    steps = []
    for s in (3, 3, 1, 3):
        window = torch.stack([toks[b, int(cur[b]):int(cur[b]) + s]
                              for b in range(B)])
        logits, _ = W.decode(dec, cfg, window, cross=cross, cache=cache,
                             pos_offset=cur)
        for b in range(B):
            writes[b].append((int(cur[b]), s))
        steps.append(logits)
        cur = cur + s
    for b in range(B):
        lane_cross = {k: v[:, b:b + 1] for k, v in cross.items()}
        solo_cache = W.init_cache(cfg, 1, max_len=T_CACHE)
        for n, (c, s) in enumerate(writes[b]):
            solo, _ = W.decode(dec, cfg, toks[b:b + 1, c:c + s],
                               cross=lane_cross, cache=solo_cache,
                               pos_offset=c)
            if n >= 2:               # the steps from the staggered cursors
                np.testing.assert_allclose(steps[n - 1][b:b + 1].numpy(),
                                           solo.numpy(), atol=1e-6, rtol=0)


def test_per_lane_cursors_with_pad_len_match_jax_vmap(setup):
    dec = setup["tp"]
    cross = W.cross_kv(dec, CFG, setup["enc"])
    cache = W.init_cache(CFG, B, max_len=T_CACHE)
    W.decode(dec, CFG, setup["prompts"], cross=cross, cache=cache,
             pad_len=setup["pad"])
    logits, _ = W.decode(dec, CFG, setup["win"], cross=cross, cache=cache,
                         pos_offset=setup["cur"], pad_len=setup["pad"])
    np.testing.assert_allclose(logits.numpy(), setup["golden"], atol=1e-6,
                               rtol=0)


def test_cache_write_past_end_raises(setup):
    dec = setup["tp"]
    cross = W.cross_kv(dec, CFG, setup["enc"])
    toks = setup["toks"]
    cache = W.init_cache(CFG, B, max_len=10)
    W.decode(dec, CFG, toks[:, :PREFILL], cross=cross, cache=cache)
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises((IndexError, RuntimeError)):
        W.decode(dec, CFG, toks[:, :3], cross=cross, cache=cache,
                 pos_offset=torch.tensor([0, 8, 2]))
    with pytest.raises((IndexError, RuntimeError)):
        W.decode(dec, CFG, toks[:, :3], cross=cross, cache=cache,
                 pos_offset=8)
    # nothing was clamped onto earlier slots of the lanes that fit
    for k in cache:
        assert torch.equal(cache[k][:, :, :PREFILL], before[k][:, :, :PREFILL])
