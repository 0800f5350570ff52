"""Parameter-tree utilities.

Parameters live in nested dicts of tensors, per-layer weights **stacked along
a leading ``layers`` axis** and linear kernels stored ``[in, out]`` — the
layout of ``distil_whisper_tpu.models``, so a tree converted leaf for leaf
from the JAX package (``convert.params_from_numpy``) is a valid tree here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

PyTree = Any


def tree_paths(tree: PyTree, sep: str = ".") -> Dict[str, Any]:
    """Flatten a nested dict into ``{'a.b.c': leaf}``."""
    out = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}{sep}{k}" if prefix else k, v)
        else:
            out[prefix] = node

    rec("", tree)
    return out


def unflatten_paths(flat: Dict[str, Any], sep: str = ".") -> PyTree:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        keys = path.split(sep)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def layer_slice(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked ``[L, ...]`` subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def cast_floating(tree: PyTree, dtype) -> PyTree:
    """Cast floating leaves to ``dtype`` (integer leaves untouched)."""
    return map_with_path(
        lambda _, x: x.to(dtype) if x.is_floating_point() else x, tree)


def to_bf16(tree: PyTree) -> PyTree:
    return cast_floating(tree, torch.bfloat16)


def to_fp32(tree: PyTree) -> PyTree:
    return cast_floating(tree, torch.float32)


def param_count(tree: PyTree) -> int:
    return sum(x.numel() for x in tree_paths(tree).values())


def map_with_path(fn: Callable[[str, Any], Any], tree: PyTree) -> PyTree:
    """Map ``fn(path, leaf)`` over a nested-dict tree, preserving structure."""
    return unflatten_paths({p: fn(p, v) for p, v in tree_paths(tree).items()})
