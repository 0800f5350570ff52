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
