"""The port's QAT (ops/qat.py) vs the JAX package's (CPU, fp32).

The same numpy inputs go through both packages.  Fake-quant values equal
JAX's bit for bit in fp32 and their gradients are the identity; the w8a8
fake-quant ``dense`` agrees with ``dense_int8`` at 2e-5 and the QAT decoder
logits with the int8 decoder's at 1e-3 (the int8 path's operands round
otherwise), as tests/test_qat.py holds JAX; the fused encoder self-attention
on a QAT tree agrees with JAX's (interpret mode) at 1e-5 and with the int8
fused path at 2e-3.  QAT train steps hold the port's one- and three-step
parameter deltas against JAX's at 1e-5 (the runners of
tests/test_torch_train_step.py): distillation with the shared frozen
encoder (w8a8; weights mode with the chunked loss; w8a8 with the int8
teacher) and fine-tuning with the unfrozen encoder.  The multi-device QAT
step of tests/test_qat.py waits for the multi-GPU slice.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import to_numpy_tree
from test_torch_train_step import (BASE_OPT, CFG, T, assert_same_run,
                                   j_tree_paths, make_batch,
                                   models,  # noqa: F401  (fixture)
                                   run_jax, run_port)
from distil_whisper_tpu.ops import qat as JQ
from distil_whisper_tpu.ops import quant as JQuant
from distil_whisper_tpu.models import whisper as JW
from distil_whisper_tpu.ops.encoder_attention import (
    fused_self_attention as j_fused)
from distil_whisper_tpu_torch.models import whisper as W
from distil_whisper_tpu_torch.ops import qat as Q
from distil_whisper_tpu_torch.ops.encoder_attention import fused_self_attention
from distil_whisper_tpu_torch.ops.quant import (dense_int8, quantize_decoder_params,
                                                quantize_dense,
                                                quantize_encoder_params,
                                                quantize_teacher_params)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_fake_quant_weight_value_and_gradient():
    """Forward value == JAX's fake-quant (bit for bit) == the dequantized
    int8 weight; the gradient is the identity.  Both the 2-D and the
    stacked [L, i, o] kernels, with a zero column (the scale floor)."""
    rng = np.random.default_rng(0)
    for shape in ((32, 16), (3, 32, 16)):
        w = rng.standard_normal(shape).astype(np.float32)
        w[..., 0] = 0.0
        want = np.asarray(JQ.fake_quant_weight(jnp.asarray(w)))
        x = _t(w).requires_grad_(True)
        got = Q.fake_quant_weight(x)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        q, s = JQuant.quantize_weight(jnp.asarray(w))
        np.testing.assert_array_equal(
            want, np.asarray(q.astype(jnp.float32) * s))
        (got * 3.0).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), 3.0)


def test_fake_quant_acts_value_and_gradient():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 16)) * [[1e-3], [1.0], [30.0], [0.0]]
         ).astype(np.float32)
    want = np.asarray(JQ.fake_quant_acts(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = Q.fake_quant_acts(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(want, x, atol=float(np.abs(x).max()) / 127.0)
    (got * 2.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), 2.0)


def test_fake_quant_acts_axes_matches_jax():
    """The non-last-axes fake-quant (JAX's flash out-projection scale):
    values bit for bit, identity gradient, in fp32 and bf16."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = JQ.fake_quant_acts_axes(jnp.asarray(x, jdt), (1, 3))
        xt = _t(x).to(tdt).requires_grad_(True)
        got = Q.fake_quant_acts_axes(xt, (1, 3))
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        got.float().sum().backward()
        np.testing.assert_array_equal(xt.grad.float().numpy(), 1.0)


def test_w8a8_fake_quant_dense_matches_int8_path():
    """dense(fake-quant tree) == dense_int8(quantized tree) to the rounding
    of the dequantized operands (2e-5), and == JAX's dense on its QAT tree."""
    rng = np.random.default_rng(2)
    p = {"kernel": rng.standard_normal((48, 24)).astype(np.float32),
         "bias": rng.standard_normal((24,)).astype(np.float32)}
    x = rng.standard_normal((6, 48)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    y_train = W.dense(Q.fake_quant_dense(tp, acts=True), _t(x))
    y_serve = dense_int8(quantize_dense(tp), _t(x))
    np.testing.assert_allclose(y_train.numpy(), y_serve.numpy(),
                               rtol=2e-5, atol=2e-5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y_jax = JW.dense(JQ.fake_quant_dense(jp, acts=True), jnp.asarray(x))
    np.testing.assert_allclose(y_train.numpy(), np.asarray(y_jax),
                               rtol=1e-6, atol=1e-6)


def test_fake_quant_tree_preserves_structure(models):
    """The QAT tree keeps {kernel, bias} names and shapes plus the act_fq
    marker ([L, 0] int8 over a stacked kernel), the tied embedding is the
    same tensor, and weights mode adds no marker."""
    student = models["t_student"]
    tree = Q.fake_quant_student_params(student, "w8a8")
    lyr = tree["decoder"]["layers"]
    for name in ("q", "k", "v", "out"):
        src = student["decoder"]["layers"]["self_attn"][name]
        want = {"kernel", "act_fq"} | ({"bias"} if "bias" in src else set())
        assert set(lyr["self_attn"][name]) == want
        assert lyr["self_attn"][name]["kernel"].shape == src["kernel"].shape
        marker = lyr["self_attn"][name]["act_fq"]
        assert marker.shape == (src["kernel"].shape[0], 0)
        assert marker.dtype == torch.int8
    assert tree["decoder"]["tok_emb"] is student["decoder"]["tok_emb"]
    assert tree["encoder"] is student["encoder"]
    assert "act_fq" not in Q.fake_quant_student_params(
        student, "weights")["decoder"]["layers"]["fc1"]
    with pytest.raises(ValueError, match="quantize_student mode"):
        Q.fake_quant_student_params(student, "int4")


def _qat_batch(seed=0):
    return make_batch(seed, bsz=2, seq=10)


def test_qat_forward_matches_int8_serving_forward(models):
    """Teacher-forced logits through the QAT (w8a8) decoder == through the
    real int8 decoder at 1e-3, and == JAX's QAT logits at 1e-5."""
    b = _qat_batch()
    cfg = models["t_scfg"]
    student = models["t_student"]
    enc = W.encode(student["encoder"], cfg, _t(b["input_features"]))
    tok = _t(b["decoder_input_ids"]).long()
    qat = Q.fake_quant_student_params(student, "w8a8")
    logits_qat, _ = W.decode(qat["decoder"], cfg, tok, enc=enc)
    logits_int8, _ = W.decode(quantize_decoder_params(student["decoder"]),
                              cfg, tok, enc=enc)
    np.testing.assert_allclose(logits_qat.numpy(), logits_int8.numpy(),
                               rtol=1e-3, atol=1e-3)
    jstudent = models["student"]
    jenc = JW.encode(jstudent["encoder"], models["scfg"],
                     jnp.asarray(b["input_features"]))
    jqat = JQ.fake_quant_student_params(jstudent, "w8a8")
    jlogits, _ = JW.decode(jqat["decoder"], models["scfg"],
                           jnp.asarray(b["decoder_input_ids"]), enc=jenc)
    np.testing.assert_allclose(logits_qat.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def one_thread():
    """torch on one CPU thread for the test.  At two, MKL may split a
    product otherwise from one call to the next (its dynamic threading):
    the last bit of one element moves, and a fake-quant carries that into
    a whole level (1/127 of its row's absmax), past 1e-5 of JAX's, in
    about one process in six."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flash_encoder_qat_matches_jax_and_int8_fused_path(one_thread):
    """fused_self_attention on a QAT (w8a8) tree: equal to JAX's (interpret
    mode) at 1e-5 in value and in the input gradient, and to the int8 fused
    path at 2e-3; gradients flow through the straight-through fake-quants."""
    rng = np.random.default_rng(3)
    dm, h, t, b = 64, 4, 128, 2

    def mk(bias=True):
        p = {"kernel": (rng.standard_normal((dm, dm)) * 0.1).astype(np.float32)}
        if bias:
            p["bias"] = (rng.standard_normal((dm,)) * 0.01).astype(np.float32)
        return p

    attn = {"q": mk(), "k": mk(bias=False), "v": mk(), "out": mk()}
    x = rng.standard_normal((b, t, dm)).astype(np.float32)
    g = rng.standard_normal((b, t, dm)).astype(np.float32)
    tattn = {n: {k: _t(v) for k, v in p.items()} for n, p in attn.items()}
    qat = {n: Q.fake_quant_dense(p, acts=True) for n, p in tattn.items()}
    int8 = {n: quantize_dense(p) for n, p in tattn.items()}
    xt = _t(x).requires_grad_(True)
    y = fused_self_attention(qat, xt, h, t)
    (y * _t(g)).sum().backward()
    y_int8 = fused_self_attention(int8, _t(x), h, t)
    np.testing.assert_allclose(y.detach().numpy(), y_int8.numpy(),
                               rtol=2e-3, atol=2e-3)

    jattn = {n: {k: jnp.asarray(v) for k, v in p.items()}
             for n, p in attn.items()}
    jqat = {n: JQ.fake_quant_dense(p, acts=True) for n, p in jattn.items()}

    def f(xx):
        return jnp.sum(j_fused(jqat, xx, h, t, interpret=True) * g)
    jy = j_fused(jqat, jnp.asarray(x), h, t, interpret=True)
    jg = jax.grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg),
                               rtol=1e-5, atol=1e-5)
    assert float(xt.grad.abs().max()) > 0


QAT_CASES = {
    "w8a8_shared_frozen_encoder": (dict(frozen_prefixes=("encoder",)),
                                   dict(quantize_student="w8a8")),
    "weights_chunked_loss": (dict(frozen_prefixes=("encoder",)),
                             dict(quantize_student="weights",
                                  loss_chunk_size=4)),
    "w8a8_unshared_unfrozen_encoder": (
        dict(warmup_steps=0),
        dict(quantize_student="w8a8", freeze_encoder=False,
             share_encoder=False)),
}


# run_distillation's default learning rate.  The fake-quant rounds each
# activation to one of 255 levels of its row's absmax, so the last-bit
# differences of two matmul orders move a rare element by a whole level;
# Adam's first steps, about lr * sign(g) an element, carry that into the
# deltas.  At lr 1e-3 three steps part from JAX's by up to 1.7e-5 on 6 of
# 4096 fc1 elements (the plain steps of test_torch_train_step.py stay inside
# 1e-5 there); at 1e-4 every case stays inside 1e-5.
QAT_LR = 1e-4


@pytest.mark.parametrize("name", list(QAT_CASES))
def test_qat_train_step_matches_jax(models, name):
    opt_kw, dcfg_kw = QAT_CASES[name]
    opt_kw = {**BASE_OPT, "learning_rate": QAT_LR, **opt_kw}
    batches = [make_batch(s) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["student"])).items()}
    j_run = run_jax(models, opt_kw, dcfg_kw, batches)
    t_run = run_port(models, opt_kw, dcfg_kw, batches)
    assert_same_run(j_run, t_run, init)
    # the steps train the decoder; a frozen encoder stays put
    moved = t_run[1][-1]["decoder.layers.fc1.kernel"] - init[
        "decoder.layers.fc1.kernel"]
    assert np.abs(moved).max() > 0
    if "frozen_prefixes" in opt_kw:
        np.testing.assert_array_equal(t_run[1][-1]["encoder.conv1.kernel"],
                                      init["encoder.conv1.kernel"])


def test_qat_train_step_with_int8_teacher_matches_jax(models):
    """--quantize_student w8a8 with --teacher_precision int8 in one step."""
    opt_kw = {**BASE_OPT, "learning_rate": QAT_LR,
              "frozen_prefixes": ("encoder",)}
    batches = [make_batch(s) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["student"])).items()}
    kw = dict(quantize_student="w8a8")
    j_run = run_jax(models, opt_kw, kw, batches,
                    teacher=JQuant.quantize_teacher_params(models["teacher"]))
    t_run = run_port(models, opt_kw, kw, batches,
                     teacher=quantize_teacher_params(models["t_teacher"]))
    # the int8 lane's tolerance for the step metrics (test_torch_train_policies)
    assert_same_run(j_run, t_run, init, rtol=1e-4, metric_atol=1e-5)


def test_qat_finetune_step_unfrozen_encoder_matches_jax(models):
    """Fine-tuning QAT (w8a8) trains the whole model through the encoder's
    fake-quant path too: deltas equal JAX's at 1e-5, and on the trained
    weights the QAT encoder agrees with the int8 encoder at 2e-3."""
    opt_kw = {**BASE_OPT, "warmup_steps": 0, "learning_rate": QAT_LR}
    batches = [make_batch(s) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["teacher"])).items()}
    kw = dict(quantize_student="w8a8")
    j_run = run_jax(models, opt_kw, kw, batches, finetune=True)
    t_run = run_port(models, opt_kw, kw, batches, finetune=True)
    assert_same_run(j_run, t_run, init)
    moved = t_run[1][-1]["encoder.layers.fc1.kernel"] - init[
        "encoder.layers.fc1.kernel"]
    assert np.abs(moved).max() > 0
    enc = t_run[0].params["encoder"]
    mel = torch.from_numpy(batches[0]["input_features"])
    with torch.no_grad():
        e_qat = W.encode(Q.fake_quant_encoder_params(enc), CFG, mel)
        e_int8 = W.encode(quantize_encoder_params(enc), CFG, mel)
    np.testing.assert_allclose(e_qat.numpy(), e_int8.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_qat_train_step_descends_and_serves(models):
    """Ten QAT (w8a8) steps reduce the loss; on the trained student the
    int8-serving CE equals the QAT CE at 1e-3."""
    from distil_whisper_tpu_torch.training.losses import cross_entropy
    opt = T.OptimizerConfig(learning_rate=3e-3, warmup_steps=1,
                            total_steps=20, precision="full",
                            frozen_prefixes=("encoder",))
    state = T.TrainState.create(models["t_student"], opt)
    step, _ = T.build_train_step(models["t_scfg"], CFG,
                                 T.DistillConfig(quantize_student="w8a8"), opt)
    b = {k: torch.from_numpy(v) for k, v in make_batch(0, bsz=4).items()}
    losses = []
    for _ in range(10):
        state, m = step(state, models["t_teacher"], b)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    cfg = models["t_scfg"]
    with torch.no_grad():
        enc = W.encode(state.params["encoder"], cfg, b["input_features"])
        tok = b["decoder_input_ids"].long()
        qat = Q.fake_quant_student_params(state.params, "w8a8")
        l_qat, _ = W.decode(qat["decoder"], cfg, tok, enc=enc)
        l_int8, _ = W.decode(quantize_decoder_params(state.params["decoder"]),
                             cfg, tok, enc=enc)
    ce_qat, n = cross_entropy(l_qat, b["labels"].long())
    ce_int8, _ = cross_entropy(l_int8, b["labels"].long())
    np.testing.assert_allclose(float(ce_qat) / float(n),
                               float(ce_int8) / float(n), rtol=1e-3)
