"""Port int8 ops vs the JAX package (CPU): quantizers, the W8A8 product, the
tree transforms, and the plain versions of the two int8 kernels against the
Pallas kernels in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import np_tree_equal, to_numpy_tree, torch_params
from distil_whisper_tpu.models.whisper import attention_block as j_attention_block
from distil_whisper_tpu.ops import quant as JQ
from distil_whisper_tpu.ops.int8_decode_attention import (
    int8_decode_attention as j_int8_decode_attention)
from distil_whisper_tpu.ops.int8_mlp import fused_int8_mlp as j_fused_int8_mlp
from distil_whisper_tpu_torch.models import params_from_numpy
from distil_whisper_tpu_torch.ops import quant as TQ
from distil_whisper_tpu_torch.ops import int8_decode_attention as tda
from distil_whisper_tpu_torch.ops import int8_mlp as tmlp
from distil_whisper_tpu_torch.ops.encoder_attention import fused_self_attention


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("shape", [(96, 64), (3, 32, 16), (2, 48, 24)])
def test_quantize_weight_equals_jax(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                                   # a zero column: the floor
    jq, js = JQ.quantize_weight(jnp.asarray(w))
    tq, ts = TQ.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_acts_and_dense_int8_equal_jax(dtype):
    """int8 values and fp32 scales equal; the product is exact, so dense_int8
    agrees to fp32 rounding (1e-6) in fp32 and to one bf16 rounding in bf16."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x[0, 3] = 0.0                                      # an all-zero row
    p = {"kernel": rng.standard_normal((64, 40)).astype(np.float32),
         "bias": rng.standard_normal(40).astype(np.float32)}
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    jq, js = JQ.quantize_acts(jx)
    tq, ts = TQ.quantize_acts(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp = JQ.quantize_dense({k: jnp.asarray(v) for k, v in p.items()})
    tp = params_from_numpy(to_numpy_tree(jp))
    np_tree_equal(TQ.quantize_dense({k: torch.from_numpy(v) for k, v in p.items()}),
                  tp)
    jy = np.asarray(JQ.dense_int8(jp, jx).astype(jnp.float32))
    ty = TQ.dense_int8(tp, tx).float().numpy()
    if dtype is np.float32:
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(ty, jy, rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int_mm_pads_small_row_counts(rows):
    """Row counts at and below cuBLASLt's minimum of 17 are padded and give
    the exact integer product."""
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, 32), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (32, 24), dtype=np.int8))
    got = TQ.int_mm(a, TQ.output_major(b))
    assert got.shape == (rows, 24) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.numpy().astype(np.int64) @ b.numpy())
    with pytest.raises(ValueError, match="multiples of 8"):
        TQ.int_mm(a[:, :30], b[:30])


def _tiny_tree(seed=2):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.standard_normal((3, i, o)).astype(np.float32)
                * np.array([1.0, 10.0, 0.1], np.float32)[:, None, None],
                "bias": rng.standard_normal((3, o)).astype(np.float32)}

    attn = lambda: {n: dense(32, 32) for n in ("q", "k", "v", "out")}
    ln = {"scale": np.ones((3, 32), np.float32),
          "bias": np.zeros((3, 32), np.float32)}
    enc = {"layers": {"self_attn": attn(), "fc1": dense(32, 64),
                      "fc2": dense(64, 32), "final_ln": ln}}
    dec = {"layers": {"self_attn": attn(), "cross_attn": attn(),
                      "fc1": dense(32, 64), "fc2": dense(64, 32)},
           "tok_emb": rng.standard_normal((50, 32)).astype(np.float32)}
    return {"encoder": enc, "decoder": dec}


@pytest.mark.parametrize("flags", ["encoder", "decoder", "lm_head", "all"])
def test_tree_quantization_equals_jax_and_is_idempotent(flags):
    """Stacked [L, i, o] kernels quantize per (layer, output channel), as
    tests/test_quant.py holds the JAX side; the port's tree equals JAX's leaf
    for leaf and a second pass returns the same subtree."""
    from distil_whisper_tpu.config import WhisperConfig as JConfig
    from distil_whisper_tpu_torch.config import WhisperConfig
    names = ("encoder", "decoder", "lm_head") if flags == "all" else (flags,)
    kw = {f"quantize_{n}": True for n in names}
    tree = _tiny_tree()
    jt = JQ.maybe_quantize_encoder(jax_tree(tree), JConfig(**kw))
    tt = TQ.maybe_quantize_encoder(params_from_numpy(tree), WhisperConfig(**kw))
    np_tree_equal(tt, params_from_numpy(to_numpy_tree(jt)))
    again = TQ.maybe_quantize_encoder(tt, WhisperConfig(**kw))
    assert again["encoder"] is tt["encoder"] and again["decoder"] is tt["decoder"]
    if "encoder" in names:
        s = tt["encoder"]["layers"]["fc1"]["kernel_scale"]
        assert s.shape == (3, 1, 64) and s.dtype == torch.float32
        # output-major layout: each output channel's K is contiguous
        assert tt["encoder"]["layers"]["fc1"]["kernel_q"].stride()[-2] == 1


def jax_tree(node):
    return {k: (jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in node.items()}


def test_converter_keeps_scales_fp32():
    """A quantized JAX tree through params_from_numpy(dtype=bf16): float
    weights become bf16, the scales stay fp32 and equal, int8 stays int8."""
    tree = jax_tree(_tiny_tree(3))
    jt = JQ.maybe_quantize_encoder(
        tree, type("C", (), {"quantize_encoder": True, "quantize_decoder": True,
                             "quantize_lm_head": True})())
    np_jt = to_numpy_tree(jt)
    np_tree_equal(params_from_numpy(np_jt), np_jt)        # fp32: leaf for leaf
    tt = params_from_numpy(np_jt, dtype=torch.bfloat16)
    for path in ("encoder.layers.fc1", "decoder.layers.cross_attn.q"):
        node_t, node_j = tt, np_jt
        for k in path.split("."):
            node_t, node_j = node_t[k], node_j[k]
        assert node_t["kernel_scale"].dtype == torch.float32
        np.testing.assert_array_equal(node_t["kernel_scale"].numpy(),
                                      node_j["kernel_scale"])
        assert node_t["kernel_q"].dtype == torch.int8
        assert node_t["bias"].dtype == torch.bfloat16
    assert tt["decoder"]["tok_emb_scale"].dtype == torch.float32
    assert tt["decoder"]["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tt["decoder"]["tok_emb_scale"].numpy(),
                                  np_jt["decoder"]["tok_emb_scale"])


def _mlp_weights(d=256, f=1024, seed=8):
    rng = np.random.default_rng(seed)
    fc1 = JQ.quantize_dense({
        "kernel": jnp.asarray(rng.standard_normal((d, f)) * 0.05, jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(f) * 0.01, jnp.float32)})
    fc2 = JQ.quantize_dense({
        "kernel": jnp.asarray(rng.standard_normal((f, d)) * 0.05, jnp.float32),
        "bias": jnp.asarray(rng.standard_normal(d) * 0.01, jnp.float32)})
    return fc1, fc2, rng


@pytest.mark.parametrize("m", [40, 300])
def test_fused_mlp_plain_matches_pallas_interpret(m):
    """tests/test_quant.py's shapes (d 256, f 1024, chunk 512) at 40 and 300
    rows.  Integer products are exact; the A&S erf is the same formula on
    both sides, so only exp's last ulp (XLA vs PyTorch) can move a
    requantization quantum: relative L2 <= 1e-5."""
    fc1, fc2, rng = _mlp_weights()
    x = rng.standard_normal((2, m // 2, 256)).astype(np.float32)
    golden = np.asarray(j_fused_int8_mlp(fc1, fc2, jnp.asarray(x), chunk_f=512,
                                         interpret=True))
    tfc1, tfc2 = (params_from_numpy(to_numpy_tree(p)) for p in (fc1, fc2))
    ours = tmlp.fused_int8_mlp(tfc1, tfc2, torch.from_numpy(x))
    assert ours.shape == x.shape and ours.dtype == torch.float32
    assert _rel_l2(ours.numpy(), golden) <= 1e-5
    np.testing.assert_allclose(ours.numpy(), golden, atol=1e-4)
    assert tmlp.fused_int8_mlp.launches == 0      # CPU: the plain version


def test_fused_mlp_gate_matches_jax():
    from distil_whisper_tpu.ops.int8_mlp import mlp_supported as j_supported
    fc1, _, _ = _mlp_weights()
    tfc1 = params_from_numpy(to_numpy_tree(fc1))
    for shape in [(2, 20, 256), (2, 200, 256), (1, 255, 256), (256, 256)]:
        assert tmlp.mlp_supported(tfc1, torch.zeros(shape)) == \
            j_supported(fc1, jnp.zeros(shape))
    assert not tmlp.mlp_supported({"kernel": tfc1["kernel_q"]},
                                  torch.zeros(2, 200, 256))


B, T, H, HD = 2, 64, 4, 32


def _kv(rng, fmt, poison_from=None):
    x = (rng.standard_normal((B, T, H * HD)) * 0.7).astype(np.float32)
    if poison_from is not None:
        x[:, poison_from:] = 37.0
    if fmt == "per_head":
        amax = np.abs(x.reshape(B, T, H, HD)).max(axis=(1, 3))
        scale = np.maximum(amax, 1e-8) / 127.0
        sv = np.repeat(scale, HD, axis=-1)[:, None]
    else:
        scale = np.maximum(np.abs(x).max(axis=-1), 1e-8) / 127.0
        sv = scale[..., None]
    q = np.clip(np.round(x / sv), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


CASES = {"per_head": ("per_head", None), "per_token": ("per_token", None),
         "tail_mask": ("per_token", "tail"), "batch_mask": ("per_token", "batch"),
         "bf16_q": ("per_head", "bf16")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_decode_attention_plain_matches_pallas_interpret(case):
    """The cases of tests/test_int8_decode_attention.py.  The integer scores
    and p.V sums are exact; the fp32 softmax sums in another order, which can
    move one probability quantum: within 1e-5 of the output's scale (fp32 q),
    one bf16 rounding (bf16 q)."""
    fmt, extra = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = (rng.standard_normal((B, H * HD)) * 0.5).astype(np.float32)
    kq, ks = _kv(rng, fmt, 40 if extra == "tail" else None)
    vq, vs = _kv(rng, fmt, 40 if extra == "tail" else None)
    mask = None
    if extra == "tail":
        mask = np.zeros((1, T), np.bool_)
        mask[:, :40] = True
    elif extra == "batch":
        mask = np.zeros((B, T), np.bool_)
        mask[0, :24] = mask[1, :56] = True
    jq = jnp.asarray(q, jnp.bfloat16 if extra == "bf16" else jnp.float32)
    golden = np.asarray(j_int8_decode_attention(
        jq, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        H, mask=None if mask is None else jnp.asarray(mask),
        interpret=True).astype(jnp.float32))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32)))
    if extra == "bf16":
        tq = tq.to(torch.bfloat16)
    ours = tda.int8_decode_attention(
        tq, torch.from_numpy(kq), torch.from_numpy(ks), torch.from_numpy(vq),
        torch.from_numpy(vs), H, None if mask is None else torch.from_numpy(mask))
    assert ours.dtype == tq.dtype and ours.shape == (B, H * HD)
    scale = np.abs(golden).max()
    tol = 2 ** -8 * scale if extra == "bf16" else 1e-5 * scale
    np.testing.assert_allclose(ours.float().numpy(), golden, atol=tol, rtol=0)
    assert tda.int8_decode_attention.launches == 0


def test_int8_decode_attention_refuses_what_jax_refuses():
    z8 = torch.zeros((1, 48, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        tda.int8_decode_attention(torch.zeros(1, 8), z8, torch.ones(1, 2), z8,
                                  torch.ones(1, 2), 2)
    z8 = torch.zeros((1, 32, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="ambiguous"):
        tda.int8_decode_attention(torch.zeros(1, 64), z8, torch.ones(1, 32), z8,
                                  torch.ones(1, 32), 32)
    with pytest.raises(ValueError, match="matches neither"):
        tda.int8_decode_attention(torch.zeros(1, 64), z8, torch.ones(1, 3), z8,
                                  torch.ones(1, 3), 2)


def test_w8a8_fused_self_attention_matches_jax():
    """The port's W8A8 fused_self_attention (plain attention on the CPU)
    against JAX's attention_block on the same quantized tree (its CPU path):
    the same int8 products, fp32 attention in another formulation, so a
    requantization quantum of the out-projection input can move.  The JAX
    test holds its two paths at 0.02 relative; here relative L2 <= 1e-4."""
    n_heads, d, t, b = 4, 64, 128, 2
    rng = np.random.default_rng(6)
    mk = lambda s: jnp.asarray(rng.standard_normal(s) * 0.3, jnp.float32)
    p = {n: JQ.quantize_dense({"kernel": mk((d, d)), "bias": mk((d,))})
         for n in ("q", "k", "v", "out")}
    x = mk((b, t, d))
    golden = np.asarray(j_attention_block(p, x, x, n_heads))
    ours = fused_self_attention(torch_params(p), torch.from_numpy(np.array(x)),
                                n_heads, t)
    assert _rel_l2(ours.numpy(), golden) <= 1e-4
