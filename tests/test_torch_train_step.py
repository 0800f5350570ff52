"""The port's train steps and optimizer vs the JAX package (CPU, fp32 unless
a case says otherwise).

Both packages start from one parameter tree (JAX init, the student cut from
it by JAX's ``init_student_from_teacher``, converted leaf for leaf) and take
the same numpy-seeded batches; each case runs three steps and holds the
port's parameter deltas after step 1 and step 3 (``params - init``) against
JAX's at 1e-5 absolute, and the step metrics at 1e-5 relative.  The optax
details sit in the cases: lr 0 on the first warmup step, clipping over
frozen gradients (``freeze_decoder``), decay on an unfrozen, gradient-free
``pos_emb``, ``MultiSteps`` averaging.  A tiny config (8 mel bins, 16
encoder positions) keeps the encoder cheap.  The precision policies, the
int8 teacher and student init are in tests/test_torch_train_policies.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import jax_init_params, to_numpy_tree, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu import training as J
from distil_whisper_tpu_torch import training as T
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.models.params import tree_paths

DIMS = dict(vocab_size=512, num_mel_bins=8, d_model=32, encoder_layers=2,
            decoder_layers=4, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_source_positions=16,
            max_target_positions=32)
JCFG = JConfig(**DIMS)
CFG = WhisperConfig(**DIMS)
ATOL = 1e-5


def make_batch(seed, bsz=2, seq=10, mask=False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 512, (bsz, seq))
    labels[:, :3] = -100
    labels[1, -2:] = -100
    out = {"input_features": rng.standard_normal((bsz, 8, 32)).astype(np.float32),
           "decoder_input_ids": rng.integers(0, 512, (bsz, seq)).astype(np.int32),
           "labels": labels.astype(np.int32)}
    if mask:
        m = np.ones((bsz, seq), np.int32)
        m[1, -2:] = 0
        out["decoder_attention_mask"] = m
    return out


@pytest.fixture(scope="module")
def models():
    teacher = jax_init_params(JCFG, 0)
    student, scfg = J.init_student_from_teacher(teacher, JCFG, decoder_layers=2)
    student = jax.tree.map(jnp.asarray, to_numpy_tree(student))
    return {"teacher": teacher, "student": student, "scfg": scfg,
            "t_teacher": torch_params(teacher), "t_student": torch_params(student),
            "t_scfg": CFG.replace(decoder_layers=2)}


def t_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def run_jax(m, opt_kw, dcfg_kw, batches, teacher=None, finetune=False):
    opt = J.OptimizerConfig(**opt_kw)
    params = m["teacher"] if finetune else m["student"]
    tx = J.make_optimizer(opt, params)
    state, tx = J.TrainState.create(params, opt, tx)
    if finetune:
        step, _ = J.build_finetune_step(JCFG, opt, tx, **dcfg_kw)
        step = jax.jit(step)
        call = lambda s, b: step(s, b)               # noqa: E731
    else:
        step, _ = J.build_train_step(m["scfg"], JCFG, J.DistillConfig(**dcfg_kw),
                                     opt, tx)
        step = jax.jit(step)
        tp = teacher if teacher is not None else m["teacher"]
        call = lambda s, b: step(s, tp, b)           # noqa: E731
    trees, metrics = [], []
    for b in batches:
        state, mt = call(state, jax.tree.map(jnp.asarray, b))
        trees.append(j_tree_paths(to_numpy_tree(state.params)))
        metrics.append({k: float(v) for k, v in mt.items()})
    return state, trees, metrics


def run_port(m, opt_kw, dcfg_kw, batches, teacher=None, finetune=False):
    opt = T.OptimizerConfig(**opt_kw)
    params = m["t_teacher"] if finetune else m["t_student"]
    state = T.TrainState.create(params, opt)
    if finetune:
        step, _ = T.build_finetune_step(CFG, opt, **dcfg_kw)
        call = lambda s, b: step(s, b)               # noqa: E731
    else:
        step, _ = T.build_train_step(m["t_scfg"], CFG, T.DistillConfig(**dcfg_kw),
                                     opt)
        tp = teacher if teacher is not None else m["t_teacher"]
        call = lambda s, b: step(s, tp, b)           # noqa: E731
    trees, metrics = [], []
    for b in batches:
        state, mt = call(state, t_batch(b))
        trees.append({p: x.detach().float().numpy().copy()
                      for p, x in tree_paths(state.params).items()})
        metrics.append({k: float(v) for k, v in mt.items()})
    return state, trees, metrics


def assert_same_run(j_run, t_run, init, atol=ATOL, rtol=1e-5,
                    metric_atol=1e-6):
    _, j_trees, j_metrics = j_run
    _, t_trees, t_metrics = t_run
    for step in (0, len(j_trees) - 1):
        jt, tt = j_trees[step], t_trees[step]
        assert sorted(jt) == sorted(tt)
        for path in jt:
            np.testing.assert_allclose(
                tt[path] - init[path], np.asarray(jt[path], np.float32)
                - init[path], atol=atol, rtol=0,
                err_msg=f"step {step + 1}: {path}")
    for jm, tm in zip(j_metrics, t_metrics):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol,
                                       atol=metric_atol, err_msg=k)


BASE_OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                precision="full")
FROZEN_DECODER = ("encoder", "decoder.pos_emb", "decoder.layers", "decoder.ln")

CASES = {
    "shared_frozen_encoder": (dict(frozen_prefixes=("encoder",)), {}, {}),
    "unshared_unfrozen_encoder_masked": (
        dict(warmup_steps=0), dict(freeze_encoder=False, share_encoder=False),
        dict(mask=True)),
    "hidden_state_mse": (dict(frozen_prefixes=("encoder",)),
                         dict(mse_weight=1.0), {}),
    "chunked_loss": (dict(frozen_prefixes=("encoder",)),
                     dict(loss_chunk_size=4), {}),
    "freeze_decoder_clips_frozen_grads": (
        dict(frozen_prefixes=FROZEN_DECODER, max_grad_norm=0.05,
             warmup_steps=0), {}, {}),
    "weight_decay_on_unfrozen_pos_emb": (
        dict(weight_decay=0.1, schedule="constant_with_warmup",
             warmup_steps=0),
        dict(freeze_encoder=False, share_encoder=False), {}),
    "gradient_accumulation_2": (
        dict(gradient_accumulation_steps=2, warmup_steps=0,
             frozen_prefixes=("encoder",)), {}, {}),
    "linear_warmup_first_update_lr_0": (
        dict(warmup_steps=2, frozen_prefixes=("encoder",)), {}, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_jax(models, name):
    opt_kw, dcfg_kw, batch_kw = CASES[name]
    opt_kw = {**BASE_OPT, **opt_kw}
    batches = [make_batch(s, **batch_kw) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["student"])).items()}
    j_run = run_jax(models, opt_kw, dcfg_kw, batches)
    t_run = run_port(models, opt_kw, dcfg_kw, batches)
    assert_same_run(j_run, t_run, init)
    state = t_run[0]
    assert state.step == 3
    if name == "linear_warmup_first_update_lr_0":
        assert all(np.array_equal(t_run[1][0][p], init[p]) for p in init)
    if name == "gradient_accumulation_2":
        assert state.count == 1 and state.mini_step == 1
        assert all(np.array_equal(t_run[1][0][p], init[p]) for p in init)
    if name == "weight_decay_on_unfrozen_pos_emb":
        # no gradient reaches the encoder positions; decay alone moves them
        moved = t_run[1][-1]["encoder.pos_emb"] - init["encoder.pos_emb"]
        assert np.abs(moved).max() > 0
    if name == "freeze_decoder_clips_frozen_grads":
        assert t_run[2][0]["grad_norm"] > 0.05     # clipping engaged
        for p in init:
            if not p.startswith("decoder.tok_emb"):
                np.testing.assert_array_equal(t_run[1][-1][p], init[p])


def test_finetune_step_matches_jax(models):
    """Fine-tuning trains the whole model; at run_finetuning's scale of
    learning rate (default 1e-5) the first Adam steps, which move each
    element by about lr * sign(g), stay inside 1e-5 where a gradient of
    the order of eps is rounded to the other sign."""
    opt_kw = {**BASE_OPT, "warmup_steps": 0, "learning_rate": 1e-4}
    batches = [make_batch(s) for s in range(3)]
    init = {p: np.asarray(x, np.float32)
            for p, x in j_tree_paths(to_numpy_tree(models["teacher"])).items()}
    kw = dict(label_smoothing=0.1)
    j_run = run_jax(models, opt_kw, kw, batches, finetune=True)
    t_run = run_port(models, opt_kw, kw, batches, finetune=True)
    assert_same_run(j_run, t_run, init)


def test_frozen_leaves_get_no_moments(models):
    opt = T.OptimizerConfig(**{**BASE_OPT, "precision": "half_mixed",
                               "frozen_prefixes": FROZEN_DECODER})
    state = T.TrainState.create(models["t_student"], opt)
    assert sorted(state.mu) == sorted(state.nu) == ["decoder.tok_emb"]
    # JAX's masked AdamW allocates moments for the same leaves only
    jopt = J.OptimizerConfig(**{**BASE_OPT, "frozen_prefixes": FROZEN_DECODER})
    tx = J.make_optimizer(jopt, models["student"])
    jstate, _ = J.TrainState.create(models["student"], jopt, tx)
    mu = jstate.opt_state[1].inner_state[0].mu
    j_leaves = [p for p, x in j_tree_paths(mu).items()
                if hasattr(x, "shape")]
    assert j_leaves == ["decoder.tok_emb"]
    # frozen leaves are stored in the compute dtype, trainable ones fp32
    for p, x in tree_paths(state.params).items():
        want = torch.float32 if p == "decoder.tok_emb" else torch.bfloat16
        if x.is_floating_point():
            assert x.dtype == want, p


@pytest.mark.parametrize("k", [0, 1, 2, 5, 9, 12])
def test_schedule_matches_optax(k):
    for schedule in ("linear", "constant_with_warmup"):
        for warmup in (0, 3):
            kw = dict(learning_rate=2e-3, warmup_steps=warmup, total_steps=10,
                      schedule=schedule)
            j = float(J.state.make_schedule(J.OptimizerConfig(**kw))(k))
            t = T.make_schedule(T.OptimizerConfig(**kw))(k)
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-12)
