"""Port attention ops vs the JAX package (CPU, fp32).

The port's ``encoder_attention`` on a CPU tensor is the CUDA kernel's plain
version (online-softmax kernel, whole-row plain version: same function); it
is held against the JAX Pallas kernel in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import torch_params
from distil_whisper_tpu.config import PRESETS as JPRESETS
from distil_whisper_tpu.models import init_params as j_init_params
from distil_whisper_tpu.ops import attention as jattn
from distil_whisper_tpu.ops import encoder_attention as jenc
from distil_whisper_tpu_torch.models.params import layer_slice
from distil_whisper_tpu_torch.ops import attention as tattn
from distil_whisper_tpu_torch.ops import encoder_attention as tenc


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t_real", [256, 200])
def test_encoder_attention_matches_pallas_interpret(t_real):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, (2, 4, 256, 64)) for _ in range(3))
    golden = np.asarray(jenc.encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t_real, 128, "f32",
        True))
    ours = tenc.encoder_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), t_real).numpy()
    np.testing.assert_allclose(ours[:, :, :t_real], golden[:, :, :t_real],
                               atol=2e-5, rtol=1e-4)
    assert tenc.encoder_attention.launches == 0


def test_fused_self_attention_matches_pallas_interpret():
    cfg = JPRESETS["test-tiny"]
    jp = j_init_params(cfg, jax.random.PRNGKey(0))
    jlp = jax.tree.map(lambda x: x[0], jp["encoder"]["layers"])["self_attn"]
    tlp = layer_slice(torch_params(jp)["encoder"]["layers"], 0)["self_attn"]
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 256, 64))
    golden = np.asarray(jenc.fused_self_attention(
        jlp, jnp.asarray(x), 4, t_real=256, block_q=128, interpret=True))
    ours = tenc.fused_self_attention(tlp, torch.from_numpy(x), 4,
                                     t_real=256).numpy()
    np.testing.assert_allclose(ours, golden, atol=3e-5, rtol=1e-4)
    assert tenc.encoder_attention.launches == 0


def test_plain_version_casts_unnormalised_probs():
    """bf16 operands: the plain version rounds exp(s - m) to bf16 before p.v
    and divides by the fp32 sum afterwards (the TPU kernel's order)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, (1, 2, 64, 64))).bfloat16()
               for _ in range(3))
    out = tenc.encoder_attention_plain(q, k, v, 50)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * 64 ** -0.5
    s[..., 50:] = float("-inf")
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v.float())
           / p.sum(-1, keepdim=True)).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_tma_geometry_contiguous():
    x = torch.empty(2, 3, 50, 64, dtype=torch.bfloat16)
    dims, strides = tenc._tma_geometry(x)
    assert dims == (64, 50, 3, 2)
    assert strides == (128, 50 * 128, 3 * 50 * 128)


def test_tma_geometry_projection_view():
    """The main path hands the kernel [B, H, T, 64] views of [B, T, H*64]
    projections: T advances by a whole projection row."""
    y = torch.empty(2, 50, 20 * 64, dtype=torch.bfloat16)
    x = y.view(2, 50, 20, 64).transpose(1, 2)
    dims, strides = tenc._tma_geometry(x)
    assert dims == (64, 50, 20, 2)
    assert strides == (2560, 128, 50 * 2560)
    assert tenc._tma_geometry(torch.empty_like(x))[1] == strides


@pytest.mark.parametrize("layout", ["base", "t_stride", "d_stride"])
def test_tma_geometry_rejects_what_tma_cannot_take(layout):
    if layout == "base":          # base 2 bytes past a 16-byte boundary
        x = torch.empty(2 * 3 * 50 * 64 + 1, dtype=torch.bfloat16)[1:]
        x = x.view(2, 3, 50, 64)
    elif layout == "t_stride":    # rows 392 bytes apart
        buf = torch.empty(2 * 50 * 196, dtype=torch.bfloat16)
        x = buf.as_strided((2, 3, 50, 64), (50 * 196, 64, 196, 1))
    else:                         # D not contiguous
        x = torch.empty(2, 3, 64, 64, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="TMA"):
        tenc._tma_geometry(x)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_matches_jax(causal):
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, (2, 7, 4, 16)), _rand(rng, (2, 9, 4, 16)), \
        _rand(rng, (2, 9, 4, 16))
    mask = rng.random((2, 1, 7, 9)) > 0.3
    mask[..., 0] = True
    jm = None if causal else jnp.asarray(mask)
    tm = tattn.causal_mask(7, 9, 0) if causal else torch.from_numpy(mask)
    golden = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jm, causal=causal))
    ours = tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), tm).numpy()
    np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-5)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, (3, 64)), _rand(rng, (3, 20, 64)), \
        _rand(rng, (3, 20, 64))
    mask = np.arange(20)[None, :] <= np.array([[5], [12], [19]])
    golden = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4, jnp.asarray(mask)))
    ours = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 4,
                                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("offset", [0, 3])
def test_causal_mask_matches_jax(offset):
    golden = np.asarray(jattn.causal_mask(4, 10, offset))
    ours = tattn.causal_mask(4, 10, offset).numpy()
    np.testing.assert_array_equal(ours, golden)


@pytest.mark.parametrize("t_real", [256, 200])
def test_encoder_attention_backward_matches_jax_custom_vjp(t_real):
    """The kernel's backward (``encoder_attention_vjp``, the recompute
    through the plain version that the autograd.Function runs on the card)
    on CPU tensors against ``jax.vjp`` of JAX's custom_vjp (Pallas kernel
    forward in interpret mode, einsum recompute backward), ragged
    ``t_real`` included; and autograd through the CPU path, which is the
    plain version itself, gives the same gradients."""
    rng = np.random.default_rng(7)
    q, k, v, g = (_rand(rng, (2, 4, 256, 64)) for _ in range(4))
    _, vjp = jax.vjp(lambda q, k, v: jenc.encoder_attention(
        q, k, v, t_real, 128, "f32", True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    golden = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    ours = tenc.encoder_attention_vjp(tq, tk, tv, t_real, tg)
    for name, a, b in zip("qkv", ours, golden):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=1e-4,
                                   err_msg=name)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tenc.encoder_attention(*leaves, t_real)
    auto = torch.autograd.grad(out, leaves, tg)
    for name, a, b in zip("qkv", auto, ours):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    # keys past t_real take no gradient
    assert not ours[1][:, :, t_real:].any() and not ours[2][:, :, t_real:].any()
    assert tenc.encoder_attention.launches == 0


def test_encoder_attention_backward_projection_views():
    """q/k/v as the [B, H, T, D] views of [B, T, H*D] projections that
    ``fused_self_attention`` hands the kernel: the gradients flow back
    into the projections, equal to those of contiguous copies, and
    ``needs`` skips a gradient."""
    rng = np.random.default_rng(8)
    b, t, h, d = 2, 96, 3, 64
    proj = [torch.from_numpy(_rand(rng, (b, t, h * d))) for _ in range(3)]
    g = torch.from_numpy(_rand(rng, (b, h, t, d)))
    views = [x.view(b, t, h, d).transpose(1, 2) for x in proj]
    dq, dk, dv = tenc.encoder_attention_vjp(*views, 80, g)
    cq, ck, cv = tenc.encoder_attention_vjp(
        *[x.contiguous() for x in views], 80, g)
    for a, c in ((dq, cq), (dk, ck), (dv, cv)):
        assert a.shape == (b, h, t, d)
        torch.testing.assert_close(a, c, atol=0, rtol=0)
    skip = tenc.encoder_attention_vjp(*views, 80, g, needs=(True, False, True))
    assert skip[1] is None
    torch.testing.assert_close(skip[0], dq, atol=0, rtol=0)
