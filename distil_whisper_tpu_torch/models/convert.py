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

from ..ops.quant import output_major
from .params import tree_paths, unflatten_paths

# fp32 leaves of an int8 tree, kept fp32 whatever the working dtype (the
# scales are computed from the weights in fp32, ops/quant.py)
FP32_LEAVES = ("kernel_scale", "tok_emb_scale")


def params_from_numpy(tree: Any, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Any:
    """Copy a nested dict of numpy arrays to tensors on ``device``; floating
    leaves are cast to ``dtype`` except the quantization scales, which stay
    fp32; integer leaves keep their type, and int8 kernels (``kernel_q``)
    take the port's output-major layout."""
    out = {}
    for path, leaf in tree_paths(tree).items():
        name = path.rsplit(".", 1)[-1]
        t = torch.from_numpy(np.array(leaf))       # a writable copy
        if t.is_floating_point() and name not in FP32_LEAVES:
            t = t.to(dtype)
        if name == "kernel_q":
            t = output_major(t)
        out[path] = t.to(device)
    return unflatten_paths(out)
