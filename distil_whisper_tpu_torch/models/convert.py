"""JAX parameter tree (as numpy arrays) -> the port's tree, leaf for leaf.

Both packages use the same tree: stacked ``[L, ...]`` layer weights and
``kernel [in, out]`` linear weights, so conversion is a copy of every leaf
onto a device in a dtype.  Tests use it to feed both packages the same
numbers (``jax.tree.map(np.asarray, params)`` on the JAX side first).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .params import tree_paths, unflatten_paths


def params_from_numpy(tree: Any, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Any:
    """Copy a nested dict of numpy arrays to tensors on ``device``; floating
    leaves are cast to ``dtype``, integer leaves keep their type."""
    out = {}
    for path, leaf in tree_paths(tree).items():
        t = torch.from_numpy(np.array(leaf))       # a writable copy
        if t.is_floating_point():
            t = t.to(dtype)
        out[path] = t.to(device)
    return unflatten_paths(out)
