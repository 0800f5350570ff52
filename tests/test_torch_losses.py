"""The port's distillation losses vs the JAX package (CPU, fp32).

The same numpy-seeded logits, hidden states and labels go through
``distil_whisper_tpu.training.losses`` and the port's copy: values and
gradients (w.r.t. the student side) at 1e-5; the chunked CE+KL equals the
unchunked pair at 1e-5, its gradients included, for a chunk that does and
one that does not divide S.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from distil_whisper_tpu.training import losses as JL
from distil_whisper_tpu_torch.training import losses as TL

B, S, V, D = 2, 10, 96, 16


def _data(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, (B, S))
    labels[0, :4] = -100
    labels[1, -3:] = -100
    return {"s": rng.standard_normal((B, S, V)).astype(np.float32),
            "t": rng.standard_normal((B, S, V)).astype(np.float32),
            "labels": labels.astype(np.int32),
            "sy": rng.standard_normal((B, S, D)).astype(np.float32),
            "ty": rng.standard_normal((B, S, D)).astype(np.float32),
            "se": (0.3 * rng.standard_normal((V, D))).astype(np.float32),
            "te": (0.3 * rng.standard_normal((V, D))).astype(np.float32)}


def _torch_grad(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts)
    return float(out.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    d = _data()
    lab = d["labels"]
    j_val, j_grad = jax.value_and_grad(
        lambda s: JL.cross_entropy(s, jnp.asarray(lab), smoothing)[0])(
        jnp.asarray(d["s"]))
    t_val, (t_grad,) = _torch_grad(
        lambda s: TL.cross_entropy(s, torch.from_numpy(lab), smoothing)[0],
        d["s"])
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_grad, np.asarray(j_grad), atol=1e-5)
    _, n = TL.cross_entropy(torch.from_numpy(d["s"]), torch.from_numpy(lab))
    assert float(n) == float(JL.cross_entropy(jnp.asarray(d["s"]),
                                              jnp.asarray(lab))[1])


def test_kl_matches_jax_and_stops_teacher_gradient():
    d = _data(1)
    lab = d["labels"]
    j_val, j_grad = jax.value_and_grad(
        lambda s, t: JL.kl_divergence(t, s, jnp.asarray(lab), 2.0)[0],
        argnums=(0, 1))(jnp.asarray(d["s"]), jnp.asarray(d["t"]))
    t_val, (gs, gt) = _torch_grad(
        lambda s, t: TL.kl_divergence(t, s, torch.from_numpy(lab), 2.0)[0]
        + 0.0 * t.sum(), d["s"], d["t"])
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-5)
    np.testing.assert_allclose(gs, np.asarray(j_grad[0]), atol=1e-5)
    assert not np.asarray(j_grad[1]).any() and not gt.any()


def test_hidden_state_mse_matches_jax():
    rng = np.random.default_rng(2)
    t_hs = rng.standard_normal((5, B, S, D)).astype(np.float32)
    s_hs = rng.standard_normal((3, B, S, D)).astype(np.float32)
    lab = _data()["labels"]
    layer_map = JL.get_layers_to_supervise(2, 4)
    assert TL.get_layers_to_supervise(2, 4) == layer_map == [2, 4]
    j_val, j_grad = jax.value_and_grad(
        lambda s: JL.hidden_state_mse(jnp.asarray(t_hs), s, layer_map,
                                      jnp.asarray(lab))[0])(jnp.asarray(s_hs))
    t_val, (t_grad,) = _torch_grad(
        lambda s: TL.hidden_state_mse(torch.from_numpy(t_hs), s, layer_map,
                                      torch.from_numpy(lab))[0], s_hs)
    np.testing.assert_allclose(t_val, float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_grad, np.asarray(j_grad), atol=1e-5)
    n = TL.hidden_state_mse(torch.from_numpy(t_hs), torch.from_numpy(s_hs),
                            layer_map, torch.from_numpy(lab))[1]
    assert float(n) == float((lab != -100).sum() * 2)


@pytest.mark.parametrize("student_l,teacher_l", [(2, 32), (4, 24), (3, 7),
                                                 (1, 4)])
def test_layers_to_supervise_matches_jax(student_l, teacher_l):
    assert (TL.get_layers_to_supervise(student_l, teacher_l)
            == JL.get_layers_to_supervise(student_l, teacher_l))


@pytest.mark.parametrize("chunk", [4, 5, 10])
def test_chunked_ce_kl_matches_jax_and_unchunked(chunk):
    d = _data(3)
    lab = d["labels"]

    def j_fn(sy, se):
        ce, kl, n = JL.chunked_ce_kl(sy, jnp.asarray(d["ty"]), se,
                                     jnp.asarray(d["te"]), jnp.asarray(lab),
                                     temperature=2.0, label_smoothing=0.1,
                                     chunk=chunk)
        return ce + kl, (ce, kl, n)

    (_, j_parts), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(d["sy"]), jnp.asarray(d["se"]))

    def t_parts(sy, se, chunked):
        lt = torch.from_numpy(lab)
        if chunked:
            return TL.chunked_ce_kl(sy, torch.from_numpy(d["ty"]), se,
                                    torch.from_numpy(d["te"]), lt,
                                    temperature=2.0, label_smoothing=0.1,
                                    chunk=chunk)
        sl = sy @ se.T
        tl = torch.from_numpy(d["ty"]) @ torch.from_numpy(d["te"]).T
        ce, n = TL.cross_entropy(sl, lt, 0.1)
        kl, _ = TL.kl_divergence(tl, sl, lt, 2.0)
        return ce, kl, n

    results = []
    for chunked in (True, False):
        sy = torch.from_numpy(d["sy"]).requires_grad_(True)
        se = torch.from_numpy(d["se"]).requires_grad_(True)
        ce, kl, n = t_parts(sy, se, chunked)
        grads = torch.autograd.grad(ce + kl, (sy, se))
        results.append(([float(ce.detach()), float(kl.detach()), float(n)],
                        [g.numpy() for g in grads]))
    (c_vals, c_grads), (u_vals, u_grads) = results
    np.testing.assert_allclose(c_vals, [float(x) for x in j_parts], rtol=1e-5)
    np.testing.assert_allclose(c_vals, u_vals, rtol=1e-5)
    for cg, ug, jg in zip(c_grads, u_grads, j_grads):
        np.testing.assert_allclose(cg, np.asarray(jg), atol=1e-5)
        np.testing.assert_allclose(cg, ug, atol=1e-5)


def test_token_mask_and_label_pad():
    lab = torch.tensor([[-100, 3, 4], [5, -100, -100]])
    assert TL.LABEL_PAD == JL.LABEL_PAD == -100
    np.testing.assert_array_equal(
        TL.token_mask(lab).numpy(),
        np.asarray(JL.token_mask(jnp.asarray(lab.numpy()))))
