"""Shared set-up for the PyTorch port's tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU: the same inputs, made
from a seed with numpy, and the same parameters, converted leaf for leaf
with ``params_from_numpy``, go through both.  Six xdist workers share the
machine's cores, so torch gets two threads; TF32 stays off.
"""

import jax
import numpy as np
import torch

from distil_whisper_tpu_torch.models import params_from_numpy

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(tree):
    """A JAX param tree as a nested dict of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def jax_init_params(cfg, seed: int):
    """The JAX package's random init under one ``jax.jit``: one compile in
    place of one per eager op (the test modules clear JAX's caches)."""
    from distil_whisper_tpu.models import init_params
    return jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))


def torch_params(jax_tree, dtype=torch.float32):
    """The port's CPU copy of a JAX param tree."""
    return params_from_numpy(to_numpy_tree(jax_tree), "cpu", dtype)


def np_tree_equal(a, b):
    """Leaf-for-leaf equality of two nested dicts (numpy or tensors)."""
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        for k in a:
            np_tree_equal(a[k], b[k])
        return
    an = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    bn = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert an.shape == bn.shape and an.dtype == bn.dtype, (an.shape, bn.shape)
    np.testing.assert_array_equal(an, bn)


def tone(seconds, freq, seed):
    """A tone under a little noise, fp32 at 16 kHz (the serving tests'
    synthetic clip, as tests/test_serving*.py make it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def serving_cases(n=8):
    """Mixed traffic: languages en/fr, segment timestamps on every third
    clip, budgets 10/7/5 (tests/test_serving_engine.py's staggered set)."""
    return [dict(wav=tone(1.0 + 0.3 * (i % 3), 200.0 + 35 * i, seed=i),
                 language=["en", "fr"][i % 2],
                 return_timestamps=(i % 3 == 0),
                 max_new_tokens=[10, 7, 5][i % 3]) for i in range(n)]


def submit_all(tr, cases, stagger=0.05, timeout=600):
    """Submit each case from its own thread, arrivals staggered by
    ``stagger * (i % 4)`` seconds; returns the results in order and
    raises the first error."""
    import threading
    import time
    results, errors = [None] * len(cases), []

    def post(i, c):
        kw = {k: v for k, v in c.items() if k != "wav"}
        try:
            results[i] = tr.submit(c["wav"], timeout=timeout, **kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, e))

    threads = []
    for i, c in enumerate(cases):
        th = threading.Thread(target=post, args=(i, c))
        th.start()
        threads.append(th)
        time.sleep(stagger * (i % 4))
    for th in threads:
        th.join(timeout=timeout)
        assert not th.is_alive(), "a request did not finish"
    if errors:
        raise errors[0][1]
    return results
