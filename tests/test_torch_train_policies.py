"""The port's precision policies, optimizer, int8 teacher and student init
vs the JAX package (CPU): the second half of tests/test_torch_train_step.py
(its models, batches and runners), a file of its own so that the two halves
run on two test workers.

bf16 compute is held by the step's losses at bf16 tolerance and by
``apply_gradients`` alone on the same gradients (fp32 masters at 1e-5, bf16
storage to one unit in the last place); fp32 by parameter deltas at 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import to_numpy_tree
from test_torch_train_step import (BASE_OPT, CFG, JCFG, J, T, assert_same_run,
                                   j_tree_paths, make_batch, models,  # noqa: F401
                                   run_jax, run_port, t_batch, tree_paths)
from distil_whisper_tpu.ops.quant import quantize_teacher_params as j_q8
from distil_whisper_tpu_torch.ops.quant import quantize_teacher_params


@pytest.mark.parametrize("precision", ["full", "half_mixed", "full_mixed"])
def test_precision_policies(models, precision):
    """A distillation step under each policy: stored dtypes as JAX stores
    them, fp32 moments for the trainable leaves only, and the step's
    losses within bf16 rounding of JAX's (exact in fp32).  Per-element
    deltas are held by test_optimizer_policies_match_jax: in bf16 compute
    the gradients of ill-conditioned leaves (cross-attention K) carry bf16
    noise, and Adam's first steps move each element by about lr * sign(g)."""
    opt_kw = {**BASE_OPT, "precision": precision, "warmup_steps": 0,
              "frozen_prefixes": ("encoder",)}
    batches = [make_batch(s) for s in range(2)]
    j_state, _, j_metrics = run_jax(models, opt_kw, {}, batches)
    t_state, _, t_metrics = run_port(models, opt_kw, {}, batches)
    j_dtypes = {p: np.asarray(x).dtype.name
                for p, x in j_tree_paths(to_numpy_tree(j_state.params)).items()}
    t_dtypes = {p: str(x.dtype).replace("torch.", "")
                for p, x in tree_paths(t_state.params).items()}
    assert t_dtypes == j_dtypes
    assert all(m.dtype == torch.float32 for m in t_state.mu.values())
    assert not any(p.startswith("encoder") for p in t_state.mu)
    tol = 1e-5 if precision == "full" else 2e-2
    for jm, tm in zip(j_metrics, t_metrics):
        for k in ("loss", "ce_loss", "kl_loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=tol, atol=1e-6)


@pytest.mark.parametrize("precision", ["full", "half_mixed", "full_mixed"])
def test_optimizer_policies_match_jax(models, precision):
    """``apply_gradients`` alone, three micro-steps of the same numpy
    gradients (in each leaf's stored dtype, as autograd gives them) with
    gradient accumulation 1 and 2, decay, clipping and a frozen decoder
    layer stack: the parameters equal JAX's at 1e-5 (fp32 masters), and
    to one bf16 unit in the last place (2^-7 relative) where they are
    stored in bf16: an fp32 update that lands next to a rounding boundary
    can round either way."""
    for accum in (1, 2):
        opt_kw = {**BASE_OPT, "precision": precision, "warmup_steps": 0,
                  "weight_decay": 0.1, "max_grad_norm": 0.5,
                  "gradient_accumulation_steps": accum,
                  "frozen_prefixes": ("encoder", "decoder.layers")}
        jopt, topt = J.OptimizerConfig(**opt_kw), T.OptimizerConfig(**opt_kw)
        tx = J.make_optimizer(jopt, models["student"])
        jstate, tx = J.TrainState.create(models["student"], jopt, tx)
        tstate = T.TrainState.create(models["t_student"], topt)
        rng = np.random.default_rng(accum)
        for _ in range(3):
            grads = {p: (0.01 * rng.standard_normal(x.shape)).astype(np.float32)
                     for p, x in j_tree_paths(to_numpy_tree(jstate.params)).items()}
            jg = {p: jnp.asarray(g).astype(j_tree_paths(jstate.params)[p].dtype)
                  for p, g in grads.items()}
            jstate = jstate.apply_gradients(
                J.state.unflatten_paths(jg), tx, jopt)
            tstate.apply_gradients(
                {p: torch.from_numpy(g).to(x.dtype)
                 for (p, g), x in zip(grads.items(), tstate.leaves().values())})
        j_final = j_tree_paths(to_numpy_tree(jstate.params))
        for p, x in tree_paths(tstate.params).items():
            want = np.asarray(j_final[p], np.float32)
            got = x.detach().float().numpy()
            if x.dtype == torch.bfloat16:
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=1e-6, err_msg=p)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                           err_msg=p)
        assert tstate.count == 3 // accum


def test_unfrozen_encoder_half_mixed_grads(models):
    """Gradients through the conv stem in bf16 compute (JAX's
    test_unfrozen_encoder_half_mixed_grads): finite, and the stem moves."""
    opt = T.OptimizerConfig(**{**BASE_OPT, "precision": "half_mixed",
                               "warmup_steps": 0})
    state = T.TrainState.create(models["t_teacher"], opt)
    before = state.params["encoder"]["conv1"]["kernel"].detach().clone()
    step, _ = T.build_finetune_step(CFG, opt)
    batch = t_batch(make_batch(0))
    grads = T.distill.gradients(_finetune_loss(state, batch, opt), state)
    assert grads["encoder.conv1.kernel"] is not None
    assert grads["encoder.conv1.kernel"].dtype == torch.float32
    assert torch.isfinite(grads["encoder.conv1.kernel"]).all()
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state.params["encoder"]["conv1"]["kernel"], before)


def _finetune_loss(state, batch, opt):
    from distil_whisper_tpu_torch.models import forward
    logits, _ = forward(state.params, CFG, batch["input_features"],
                        batch["decoder_input_ids"], dtype=opt.compute_dtype)
    ce, n = T.cross_entropy(logits, batch["labels"])
    return ce / n


def test_int8_teacher_matches_jax(models):
    """--teacher_precision int8 on the tiny teacher: the port's quantized
    teacher equals JAX's (eager: XLA may turn the jitted division by 127
    into a product), and the step's deltas equal JAX's at 1e-5, its
    metrics at 1e-4 relative and 1e-5 absolute (the teacher's per-row
    activation requantization can move an fp32 rounding by a quantum, the
    int8 lane's tolerance; the KL of two near-equal distributions is near
    0, so its error is absolute)."""
    from distil_whisper_tpu.ops.quant import (quantize_decoder_params,
                                              quantize_encoder_params)
    jt = models["teacher"]
    jq = {**jt, "encoder": quantize_encoder_params(jt["encoder"]),
          "decoder": quantize_decoder_params(jt["decoder"])}
    tq = quantize_teacher_params(models["t_teacher"])
    assert "kernel_q" in tq["encoder"]["layers"]["fc1"]
    assert "kernel_q" in tq["decoder"]["layers"]["self_attn"]["q"]
    assert "tok_emb_q" not in tq["decoder"]
    for p, x in tree_paths(tq).items():
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(j_tree_paths(jq)[p]), p)
    for p, x in j_tree_paths(j_q8(jt)).items():   # the jitted tree
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(j_tree_paths(jq)[p], np.float64),
                                   rtol=1e-6, atol=1, err_msg=p)
    opt_kw = {**BASE_OPT, "warmup_steps": 0, "frozen_prefixes": ("encoder",)}
    batches = [make_batch(s) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["student"])).items()}
    j_run = run_jax(models, opt_kw, {}, batches, teacher=jq)
    t_run = run_port(models, opt_kw, {}, batches, teacher=tq)
    assert_same_run(j_run, t_run, init, rtol=1e-4, metric_atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(decoder_layers=2),
    dict(decoder_layers=3, encoder_layers=1),
    dict(decoder_layers=2, decoder_layer_numbers=[1, 2]),
    dict(decoder_layers=1, max_source_positions=8)])
def test_student_init_matches_jax(models, kw):
    """``init_student_from_teacher``: the same layer picks (last layer
    pinned, or explicit), encoder shrink and position truncation as JAX's,
    and fresh tensors that alias nothing of the teacher."""
    jt = models["teacher"]
    js, jcfg = J.init_student_from_teacher(jt, JCFG, **kw)
    ts, tcfg = T.init_student_from_teacher(models["t_teacher"], CFG, **kw)
    assert tcfg == CFG.replace(**{f: getattr(jcfg, f) for f in (
        "encoder_layers", "decoder_layers", "max_source_positions")})
    jf, tf = j_tree_paths(to_numpy_tree(js)), tree_paths(ts)
    assert sorted(jf) == sorted(tf)
    teacher_ptrs = {x.data_ptr() for x in tree_paths(models["t_teacher"]).values()}
    for p, x in tf.items():
        np.testing.assert_array_equal(x.numpy(), jf[p], p)
        assert x.data_ptr() not in teacher_ptrs, p
    assert list(T.student_layer_map(32, 2)) == list(J.student_layer_map(32, 2))
