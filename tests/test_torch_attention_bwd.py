"""The encoder attention's backward: the plain version of the backward kernel
against JAX's gradient (CPU, fp32), the forward's base-2 log-sum-exp, and the
wrapper's checks.

The kernel (``csrc/encoder_attention_bwd.cu``) runs only on the card;
``chip_smoke.py`` holds it against :func:`encoder_attention_bwd_plain` there.
Here the plain version, fed by the plain forward's output and log-sum-exp,
is held against ``jax.vjp`` of JAX's ``encoder_attention`` (Pallas forward
in interpret mode, einsum recompute backward).
"""

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distil_whisper_tpu.ops import encoder_attention as jenc
from distil_whisper_tpu_torch.ops import _build
from distil_whisper_tpu_torch.ops import encoder_attention as tenc

ROOT = Path(__file__).resolve().parents[1]


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_grads(q, k, v, g, t_real):
    _, vjp = jax.vjp(lambda q, k, v: jenc.encoder_attention(
        q, k, v, t_real, 128, "f32", True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("layout", ["contiguous", "projection_views"])
@pytest.mark.parametrize("t_real", [256, 200])
def test_bwd_plain_matches_jax_vjp(t_real, layout):
    """(dq, dk, dv) of the plain backward, from the plain forward's output
    and lse, equal JAX's gradient in fp32; as [B, H, T, D] views of
    [B, T, H*D] projections (the layout ``fused_self_attention`` hands the
    kernels) as well."""
    rng = np.random.default_rng(11)
    b, h, t, d = 2, 4, 256, 64
    q, k, v, g = (_rand(rng, (b, h, t, d)) for _ in range(4))
    golden = _jax_grads(q, k, v, g, t_real)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    if layout == "projection_views":
        tq, tk, tv = (x.transpose(1, 2).contiguous().view(b, t, h * d)
                      .view(b, t, h, d).transpose(1, 2) for x in (tq, tk, tv))
        assert not tq.is_contiguous()
    out, lse = tenc.encoder_attention_plain(tq, tk, tv, t_real,
                                            return_lse=True)
    ours = tenc.encoder_attention_grad(tq, tk, tv, out, lse, tg, t_real)
    for name, a, ref in zip("qkv", ours, golden):
        assert a.shape == (b, h, t, d) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), ref, atol=2e-5, rtol=1e-4,
                                   err_msg=name)
    assert tenc.encoder_attention_grad.launches == 0


def test_plain_forward_lse_is_the_base2_logsumexp():
    """``return_lse`` leaves the output's bits alone, and the lse is the
    log-sum-exp of the scaled, masked scores in base 2 (bf16 operands,
    fp32 scores)."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(_rand(rng, (2, 4, 256, 64))).bfloat16()
               for _ in range(3))
    for t_real in (256, 200, 1):
        out = tenc.encoder_attention_plain(q, k, v, t_real)
        out2, lse = tenc.encoder_attention_plain(q, k, v, t_real,
                                                 return_lse=True)
        assert torch.equal(out, out2)
        assert lse.shape == (2, 4, 256) and lse.dtype == torch.float32
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / 8.0
        s[..., t_real:] = float("-inf")
        ref = torch.logsumexp(s, -1) / math.log(2)
        torch.testing.assert_close(lse.double(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_keys_take_exactly_zero_gradient(dtype):
    """Keys >= t_real receive exactly zero dK and dV, in fp32 and through
    the bf16 casts; the other keys do receive some."""
    rng = np.random.default_rng(13)
    q, k, v, g = (torch.from_numpy(_rand(rng, (2, 3, 160, 64))).to(dtype)
                  for _ in range(4))
    out, lse = tenc.encoder_attention_plain(q, k, v, 77, return_lse=True)
    dq, dk, dv = tenc.encoder_attention_grad(q, k, v, out, lse, g, 77)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert not dk[:, :, 77:].any() and not dv[:, :, 77:].any()
    assert dk[:, :, :77].any(-1).all() and dv[:, :, :77].any(-1).all()


def test_bwd_plain_equals_the_recompute_in_fp32():
    """In fp32 the plain backward (from lse and delta) and the recompute
    through the plain forward under autograd are the same gradient;
    ``needs`` drops the gradients that are not asked for."""
    rng = np.random.default_rng(14)
    q, k, v, g = (torch.from_numpy(_rand(rng, (1, 2, 96, 64)))
                  for _ in range(4))
    out, lse = tenc.encoder_attention_plain(q, k, v, 80, return_lse=True)
    ours = tenc.encoder_attention_grad(q, k, v, out, lse, g, 80)
    ref = tenc.encoder_attention_vjp(q, k, v, 80, g)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, atol=2e-6, rtol=1e-5)
    skip = tenc.encoder_attention_grad(q, k, v, out, lse, g, 80,
                                       needs=(False, True, False))
    assert skip[0] is None and skip[2] is None
    assert torch.equal(skip[1], ours[1])


def test_backward_source_is_built():
    assert "encoder_attention_bwd" in _build.SOURCES
    assert (_build.SRC_DIR / "encoder_attention_bwd.cu").is_file()


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["fp32", "head_dim", "t_real", "lse_shape",
                                  "lse_dtype", "shape", "grad_layout"])
def test_kernel_backward_refuses_what_it_cannot_take(case, monkeypatch):
    """The checks before any launch: bf16 only, head dim 64 only,
    1 <= t_real <= T, an fp32 [B, H, T] lse, operands of q's shape, and
    gradient buffers in the [B, T, H, 64] layout the kernel writes."""
    shape, t_real = (1, 2, 40, 64), 40
    x = {n: _bf16(*shape) for n in ("q", "k", "v", "out", "g")}
    lse = torch.zeros(1, 2, 40)
    if case == "fp32":
        x["g"] = x["g"].float()
    elif case == "head_dim":
        x = {n: _bf16(1, 2, 40, 32) for n in x}
    elif case == "t_real":
        t_real = 41
    elif case == "lse_shape":
        lse = torch.zeros(1, 2, 41)
    elif case == "lse_dtype":
        lse = lse.bfloat16()
    elif case == "grad_layout":
        monkeypatch.setattr(tenc, "_grad_buffers", lambda q, n: [
            torch.empty_like(q) for _ in range(n)])
    else:
        x["v"] = _bf16(1, 2, 41, 64)
    with pytest.raises(ValueError):
        tenc._launch_bwd(x["q"], x["k"], x["v"], x["out"], lse, x["g"],
                         t_real, (True, True, True))
    assert tenc.encoder_attention_grad.launches == 0


def test_grad_buffers_are_views_of_projection_rows():
    """The kernel writes dq/dk/dv into [B, H, T, 64] views of [B, T, H, 64]
    buffers, which TMA's geometry also takes; the three are consecutive
    slices of one allocation."""
    q = _bf16(2, 20, 50, 64)
    bufs = tenc._grad_buffers(q, 3)
    assert len(bufs) == 3
    for i, buf in enumerate(bufs):
        assert buf.shape == q.shape
        assert buf.transpose(1, 2).is_contiguous()
        assert tenc._tma_geometry(buf)[1] == (2560, 128, 50 * 2560)
        assert buf.data_ptr() == bufs[0].data_ptr() + i * q.numel() * 2
    assert bufs[0].untyped_storage().nbytes() == 3 * q.numel() * 2


def test_bwd_geometry():
    """The backward's persistent launches: (items, grid, rows) for T, B, H
    and the SM count, where an item is a 128-row tile of one (batch row,
    head), a grid min(SMs, items) blocks, and the (lse2, delta) scratch T
    rounded up to whole tiles."""
    for t, b, h, n_sm, want in (
            (1, 1, 1, 132, (1, 1, 128)),
            (64, 1, 1, 132, (1, 1, 128)),
            (65, 2, 20, 132, (40, 40, 128)),
            (200, 2, 20, 132, (80, 80, 256)),
            (1437, 2, 20, 132, (480, 132, 1536)),
            (1500, 2, 20, 132, (480, 132, 1536)),
            (1500, 4, 20, 132, (960, 132, 1536)),
            (1500, 4, 20, 7, (960, 7, 1536)),
            (1500, 1, 5, 114, (60, 60, 1536))):
        assert tenc.bwd_geometry(b, h, t, n_sm) == want, (t, b, h, n_sm)


def test_grad_on_an_unsupported_device_raises():
    q = torch.zeros(1, 1, 8, 64, device="meta")
    lse = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tenc.encoder_attention_grad(q, q, q, q, lse, q, 8)


def test_backward_launch_runs_under_its_tensors_device():
    """As every kernel wrapper: the one library call of the backward sits
    inside ``with torch.cuda.device(q.device)`` and passes that card's
    current stream."""
    source = ROOT / "distil_whisper_tpu_torch/ops/encoder_attention.py"
    tree = ast.parse(source.read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == "dw_encoder_attention_bwd"]
    assert len(calls) == 1
    guarded = [
        (ast.unparse(w.items[0].context_expr.args[0]),
         ast.unparse(c.args[-1]))
        for w in ast.walk(tree) if isinstance(w, ast.With)
        and isinstance(w.items[0].context_expr, ast.Call)
        and ast.unparse(w.items[0].context_expr.func) == "torch.cuda.device"
        for c in ast.walk(w) if c in calls]
    assert guarded == [("q.device",
                        "torch.cuda.current_stream(q.device).cuda_stream")]


def test_cotangent_layouts_tma_cannot_take_are_copied():
    """The cotangent of a sum is an expanded tensor (stride 0): TMA cannot
    load it, so the wrapper hands the kernel a contiguous copy; the
    [B, H, T, D] views of projection rows load as they are."""
    g = torch.ones((), dtype=torch.bfloat16).expand(2, 3, 40, 64)
    assert not tenc._tma_ok(g, tenc._byte_strides(g))
    c = g.contiguous()
    assert tenc._tma_ok(c, tenc._byte_strides(c))
    view = tenc._grad_buffers(_bf16(2, 3, 40, 64), 1)[0]
    assert tenc._tma_ok(view, tenc._byte_strides(view))
