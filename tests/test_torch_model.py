"""Port Whisper model vs the JAX package (CPU, fp32, preset test-tiny).

Both sides get one parameter tree (JAX init, converted leaf for leaf).  The
port's fused encoder path on the CPU runs the kernel's plain version; JAX's
runs its Pallas kernel forced on in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import np_tree_equal, to_numpy_tree, torch_params
import distil_whisper_tpu.models.whisper as JW
from distil_whisper_tpu.config import PRESETS as JPRESETS
from distil_whisper_tpu.models import init_params as j_init_params
from distil_whisper_tpu.models import load_params as j_load_params
from distil_whisper_tpu.models.init import sinusoidal_positions as j_sinusoids
from distil_whisper_tpu_torch.config import PRESETS
from distil_whisper_tpu_torch.models import init_params, load_params
from distil_whisper_tpu_torch.models import whisper as TW
from distil_whisper_tpu_torch.models.init import sinusoidal_positions
from distil_whisper_tpu_torch.models.params import tree_paths, unflatten_paths
from distil_whisper_tpu_torch.ops import encoder_attention as tenc

CFG = PRESETS["test-tiny"]
JCFG = JPRESETS["test-tiny"]


@pytest.fixture(scope="module")
def setup():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((2, 80, 3000)).astype(np.float32)
    tokens = rng.integers(0, 51865, size=(2, 6)).astype(np.int64)
    enc = np.array(JW.encode(jp["encoder"], JCFG, jnp.asarray(mel)))
    return jp, torch_params(jp), mel, tokens, enc


def test_encode_fused_matches_pallas_interpret(setup, monkeypatch):
    jp, tp, mel, _, _ = setup
    monkeypatch.setattr(JW, "_flash_available", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        golden = np.asarray(JW.encode(
            jp["encoder"], JCFG.replace(use_flash_encoder=True),
            jnp.asarray(mel)))
    ours = TW.encode(tp["encoder"], CFG.replace(use_flash_encoder=True),
                     torch.from_numpy(mel)).numpy()
    assert ours.shape == golden.shape == (2, 1500, 64)
    np.testing.assert_allclose(ours, golden, atol=5e-5, rtol=1e-4)
    assert tenc.encoder_attention.launches == 0


def test_encode_einsum_path_matches_jax(setup):
    _, tp, mel, _, enc = setup
    ours = TW.encode(tp["encoder"], CFG, torch.from_numpy(mel))
    np.testing.assert_allclose(ours.numpy(), enc, atol=5e-5, rtol=1e-4)


def test_cross_kv_matches_jax(setup):
    jp, tp, _, _, enc = setup
    golden = JW.cross_kv(jp["decoder"], JCFG, jnp.asarray(enc))
    ours = TW.cross_kv(tp["decoder"], CFG, torch.from_numpy(enc))
    for name in ("k", "v"):
        assert ours[name].shape == (2, 2, 1500, 64)
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.asarray(golden[name]), atol=1e-5,
                                   rtol=1e-5)


def test_decode_uncached_matches_jax(setup):
    jp, tp, _, tokens, enc = setup
    golden, _ = JW.decode(jp["decoder"], JCFG, jnp.asarray(tokens),
                          enc=jnp.asarray(enc))
    ours, cache = TW.decode(tp["decoder"], CFG, torch.from_numpy(tokens),
                            enc=torch.from_numpy(enc))
    assert cache is None
    np.testing.assert_allclose(ours.numpy(), np.asarray(golden), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("left_pad", [False, True])
def test_prefill_and_cached_steps_match_jax(setup, left_pad):
    """Prefill (S>1) then three cached single-token steps; with ``left_pad``
    the prompts carry per-row left padding (``pad_len``)."""
    jp, tp, _, tokens, enc = setup
    jcross = JW.cross_kv(jp["decoder"], JCFG, jnp.asarray(enc))
    tcross = TW.cross_kv(tp["decoder"], CFG, torch.from_numpy(enc))
    pad = np.array([0, 2]) if left_pad else None
    jpad = None if pad is None else jnp.asarray(pad)
    tpad = None if pad is None else torch.from_numpy(pad)
    jcache = JW.init_cache(JCFG, 2, max_len=16)
    tcache = TW.init_cache(CFG, 2, max_len=16)
    golden, jcache = JW.decode(jp["decoder"], JCFG, jnp.asarray(tokens),
                               cross=jcross, cache=jcache, pad_len=jpad)
    ours, tcache = TW.decode(tp["decoder"], CFG, torch.from_numpy(tokens),
                             cross=tcross, cache=tcache, pad_len=tpad)
    np.testing.assert_allclose(ours.numpy(), np.asarray(golden), atol=1e-4,
                               rtol=1e-4)
    rng = np.random.default_rng(9)
    for step in range(3):
        tok = rng.integers(0, 51865, size=(2, 1)).astype(np.int64)
        pos = tokens.shape[1] + step
        golden, jcache = JW.decode(jp["decoder"], JCFG, jnp.asarray(tok),
                                   cross=jcross, cache=jcache,
                                   pos_offset=pos, pad_len=jpad)
        ours, tcache = TW.decode(tp["decoder"], CFG, torch.from_numpy(tok),
                                 cross=tcross, cache=tcache, pos_offset=pos,
                                 pad_len=tpad)
        np.testing.assert_allclose(ours.numpy(), np.asarray(golden),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5, rtol=1e-5)


def test_bf16_fast_policy_runs_finite(setup):
    """bf16 weights with fast_bf16_attention and the fused encoder: encode,
    prefill and the merged-layout single-token step stay finite and close to
    the fp32 run."""
    jp, _, mel, tokens, _ = setup
    tp16 = torch_params(jp, torch.bfloat16)
    tp32 = torch_params(jp)
    cfg = CFG.replace(fast_bf16_attention=True, use_flash_encoder=True)
    enc16 = TW.encode(tp16["encoder"], cfg, torch.from_numpy(mel),
                      dtype=torch.bfloat16)
    enc32 = TW.encode(tp32["encoder"], CFG, torch.from_numpy(mel))
    assert enc16.dtype == torch.bfloat16
    assert torch.isfinite(enc16.float()).all()
    assert (enc16.float() - enc32).abs().max() < 0.25
    cross = TW.cross_kv(tp16["decoder"], cfg, enc16)
    cache = TW.init_cache(cfg, 2, dtype=torch.bfloat16, max_len=8)
    logits, cache = TW.decode(tp16["decoder"], cfg, torch.from_numpy(tokens),
                              cross=cross, cache=cache, dtype=torch.bfloat16)
    step, _ = TW.decode(tp16["decoder"], cfg, torch.from_numpy(tokens[:, :1]),
                        cross=cross, cache=cache, pos_offset=6,
                        dtype=torch.bfloat16)
    assert logits.dtype == step.dtype == torch.float32
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


def test_init_params_tree_matches_jax():
    jp = to_numpy_tree(j_init_params(JCFG, jax.random.PRNGKey(0)))
    tp = init_params(CFG, seed=0, device="cpu")
    jflat, tflat = tree_paths(jp), tree_paths(tp)
    assert sorted(jflat) == sorted(tflat)
    for path, leaf in jflat.items():
        assert tuple(tflat[path].shape) == leaf.shape, path
    np.testing.assert_array_equal(tp["encoder"]["pos_emb"].numpy(),
                                  jp["encoder"]["pos_emb"])
    std = float(tp["decoder"]["tok_emb"].std())
    assert 0.019 < std < 0.021
    np.testing.assert_array_equal(init_params(CFG, 0, "cpu")["decoder"]["tok_emb"],
                                  tp["decoder"]["tok_emb"])


def test_sinusoids_equal_jax():
    np.testing.assert_array_equal(sinusoidal_positions(1500, 1280),
                                  j_sinusoids(1500, 1280))


def test_load_params_matches_jax_leaf_for_leaf(tmp_path):
    from helpers import make_tiny_checkpoint
    ck = make_tiny_checkpoint(tmp_path / "tiny")
    jp, jcfg = j_load_params(ck)
    tp, tcfg = load_params(ck, device="cpu")
    assert tcfg == type(tcfg)(**{f: getattr(jcfg, f)
                                  for f in tcfg.__dataclass_fields__})
    np_tree_equal(tp, to_numpy_tree(jp))


def test_load_params_of_a_bf16_checkpoint_matches_jax(tmp_path):
    """A checkpoint stored in bf16 (as the smoke's teacher is): the port
    reads it in its stored dtype and casts on the device; loaded as fp32
    and as bf16 it equals JAX's loader leaf for leaf."""
    from helpers import make_tiny_checkpoint
    from distil_whisper_tpu_torch.models import save_pretrained
    tp, cfg = load_params(make_tiny_checkpoint(tmp_path / "tiny"),
                          device="cpu")
    ck = str(tmp_path / "bf16")
    save_pretrained(tp, cfg, ck, dtype=torch.bfloat16)
    jp, _ = j_load_params(ck)
    np_tree_equal(load_params(ck, device="cpu")[0], to_numpy_tree(jp))
    ours16 = load_params(ck, device="cpu", dtype=torch.bfloat16)[0]
    for p, x in tree_paths(ours16).items():
        assert x.dtype == torch.bfloat16, p
        np.testing.assert_array_equal(
            x.float().numpy(), np.asarray(tree_paths(to_numpy_tree(jp))[p],
                                          np.float32), p)


# ----------------------------------------------------------------------
# The training forward
# ----------------------------------------------------------------------


def test_forward_hidden_states_and_mask_match_jax(setup):
    """``forward`` with ``output_hidden_states`` and a padding
    ``decoder_attention_mask``: logits, encoder and decoder hidden states
    ([L+1, B, T, d]) equal JAX's at 5e-5; ``skip_logits`` gives the final
    hidden state."""
    jp, tp, mel, tokens, _ = setup
    mask = np.ones(tokens.shape, np.int32)
    mask[1, -2:] = 0
    j_logits, j_aux = JW.forward(jp, JCFG, jnp.asarray(mel),
                                 jnp.asarray(tokens),
                                 decoder_attention_mask=jnp.asarray(mask),
                                 output_hidden_states=True)
    t_logits, t_aux = TW.forward(tp, CFG, torch.from_numpy(mel),
                                 torch.from_numpy(tokens),
                                 decoder_attention_mask=torch.from_numpy(mask),
                                 output_hidden_states=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=5e-5, rtol=1e-4)
    for key in ("encoder_last_hidden_state", "encoder_hidden_states",
                "decoder_hidden_states"):
        assert t_aux[key].shape == j_aux[key].shape, key
        np.testing.assert_allclose(t_aux[key].numpy(), np.asarray(j_aux[key]),
                                   atol=5e-5, rtol=1e-4, err_msg=key)
    assert t_aux["decoder_hidden_states"].shape[0] == CFG.decoder_layers + 1
    j_y, _ = JW.decode(jp["decoder"], JCFG, jnp.asarray(tokens),
                       enc=j_aux["encoder_last_hidden_state"],
                       attention_mask=jnp.asarray(mask), skip_logits=True)
    t_y, _ = TW.decode(tp["decoder"], CFG, torch.from_numpy(tokens),
                       enc=t_aux["encoder_last_hidden_state"],
                       attention_mask=torch.from_numpy(mask), skip_logits=True)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), atol=5e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(t_y.numpy(),
                               t_aux["decoder_hidden_states"][-1].numpy(),
                               atol=0, rtol=0)


def test_freeze_and_positions_take_no_gradient(setup):
    """``freeze_encoder`` detaches the encoder's output, and the encoder's
    sinusoidal positions never take a gradient (JAX: stop_gradient)."""
    _, tp, mel, tokens, _ = setup
    enc = {k: v for k, v in tree_paths(tp["encoder"]).items()}
    for x in enc.values():
        x.requires_grad_(True)
    try:
        frozen, _ = TW.forward(tp, CFG, torch.from_numpy(mel[:1]),
                               torch.from_numpy(tokens[:1]),
                               freeze_encoder=True)
        assert not frozen.requires_grad
        logits, _ = TW.forward(tp, CFG, torch.from_numpy(mel[:1]),
                               torch.from_numpy(tokens[:1]))
        grads = dict(zip(enc, torch.autograd.grad(
            logits.sum(), list(enc.values()), allow_unused=True)))
        assert grads["pos_emb"] is None
        assert all(g is not None for p, g in grads.items() if p != "pos_emb")
    finally:
        for x in enc.values():
            x.requires_grad_(False)


def test_dropout_identity_and_keep_rate():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    assert TW.dropout(x, 0.0, gen) is x
    assert TW.dropout(x, 0.3, None) is x
    y = TW.dropout(x, 0.3, gen)
    kept = (y != 0).float().mean().item()
    # 200k Bernoulli(0.7) draws: the keep share has sd 1.0e-3; 7 sd bound
    assert abs(kept - 0.7) < 7e-3, kept
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)


def test_dropout_under_remat_draws_the_same_masks(setup):
    """Dropout at the config's rates from one generator seed: the forward
    is reproducible, differs from the dropout-free forward, and remat
    (per-layer recompute) gives the same loss and gradients, since each
    layer draws from a generator seeded from the caller's."""
    _, tp, mel, tokens, _ = setup
    cfg = CFG.replace(dropout=0.1, attention_dropout=0.1,
                      activation_dropout=0.1)
    dec = tree_paths(tp["decoder"])
    leaves = [x.clone().requires_grad_(True) for x in dec.values()]
    params = {"encoder": tp["encoder"],
              "decoder": unflatten_paths(dict(zip(dec, leaves)))}

    def run(remat, seed):
        gen = torch.Generator().manual_seed(seed)
        logits, _ = TW.forward(params, cfg, torch.from_numpy(mel[:1]),
                               torch.from_numpy(tokens[:1]), remat=remat,
                               freeze_encoder=True, generator=gen)
        loss = logits.square().mean()
        return loss.detach(), torch.autograd.grad(loss, leaves,
                                                  allow_unused=True)

    plain_logits, _ = TW.forward(params, cfg, torch.from_numpy(mel[:1]),
                                 torch.from_numpy(tokens[:1]))
    l0, g0 = run(False, 7)
    l1, g1 = run(True, 7)
    l2, _ = run(False, 7)
    l3, _ = run(False, 8)
    assert torch.equal(l0, l2) and not torch.equal(l0, l3)
    assert not torch.equal(l0, plain_logits.square().mean().detach())
    torch.testing.assert_close(l1, l0, atol=0, rtol=0)
    for a, b in zip(g0, g1):
        if a is None:
            assert b is None
        else:
            torch.testing.assert_close(b, a, atol=1e-7, rtol=1e-6)
