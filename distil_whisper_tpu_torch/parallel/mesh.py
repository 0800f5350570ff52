"""Device mesh and logical-axis rules on ``torch.distributed``.

The port of ``distil_whisper_tpu.parallel.mesh``: one
``torch.distributed.device_mesh.DeviceMesh`` over ``('data', 'model')`` and
the JAX package's rule tables from logical parameter axes
(``models/init.py::param_axes``) to mesh axes.  This slice runs the data
axis only: every parameter is replicated, broadcast from the first rank of
the data axis so that all replicas start bit-identical, and each rank feeds
its own rows.  A ``'model'`` axis larger than 1 (tensor parallelism) and
``RULES_2D`` (parameters sharded over ``'data'`` too, FSDP-style) raise,
naming the ROADMAP.md item that brings them; the rule tables and
:func:`spec_for_axes` are already what they will read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .multihost import broadcast_, world_size

# Logical axis -> mesh axis (the JAX package's table): batch -> data; the
# fan-out axes -> model; everything else replicated.  Whisper's vocabulary
# sizes (51864/51865) divide by no practical model-parallel degree, so the
# embeddings stay replicated.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "data",
    "vocab": None,
    "mlp": "model",
    "heads": "model",
    "joined_kv": "model",
    "kv": None,
    "embed": None,
    "layers": None,
    "length": None,
    "stack": None,
    "unmodeled": None,
}

# 2-D variant: parameters sharded over both axes (FSDP-style)
RULES_2D: Dict[str, Optional[str]] = {
    **DEFAULT_RULES,
    "embed": "data",
}

NEXT_SLICE = ("comes with the multi-GPU tensor-parallel slice: ROADMAP.md "
              "queue 1, item 5")


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              device_type: Optional[str] = None):
    """A ``(data, model)`` DeviceMesh over the job's ranks, all on 'data'
    by default.  Needs the process group (``maybe_initialize_distributed``);
    ``device_type`` defaults to cuda under NCCL, else cpu (a gloo group,
    whose collectives also take CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if shape is None:
        shape = (n, 1)
    if shape[1] > 1:
        raise NotImplementedError(f"a 'model' axis of {shape[1]} {NEXT_SLICE}")
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} != {n} ranks")
    if device_type is None:
        device_type = ("cuda" if torch.distributed.get_backend() == "nccl"
                       else "cpu")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def data_group(mesh):
    """The process group of the 'data' axis, or None when there is no
    data parallelism to do (no mesh, or one rank on 'data')."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index("data")) == 1:
        return None
    return mesh.get_group("data")


def spec_for_axes(axes: Sequence[str],
                  rules: Dict[str, Optional[str]] = DEFAULT_RULES
                  ) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dimension (None = replicated), as JAX's
    ``PartitionSpec`` entries."""
    return tuple(rules.get(a) for a in axes)


def shardings_for_tree(axes_tree: Any, mesh=None,
                       rules: Dict[str, Optional[str]] = DEFAULT_RULES) -> Any:
    """Map a logical-axes tree to the tree of its specs (same structure)."""
    if isinstance(axes_tree, dict):
        return {k: shardings_for_tree(v, mesh, rules)
                for k, v in axes_tree.items()}
    return spec_for_axes(axes_tree, rules)


def shard_params(params: Any, mesh=None,
                 rules: Dict[str, Optional[str]] = DEFAULT_RULES) -> Any:
    """Place a param tree on the mesh: under data parallelism every leaf
    is replicated, overwritten in place with the values of the data axis's
    first rank.  No-op without data parallelism.  Rules that shard
    parameters over 'data' (``RULES_2D``) raise."""
    if any(v == "data" for k, v in rules.items() if k != "batch"):
        raise NotImplementedError(
            f"parameters sharded over 'data' (RULES_2D, --param_sharding "
            f"2d) {NEXT_SLICE}")
    group = data_group(mesh)
    if group is not None:
        from ..models.params import tree_paths
        leaves = [x for x in tree_paths(params).values()
                  if isinstance(x, torch.Tensor)]
        broadcast_(leaves, src=torch.distributed.get_global_rank(group, 0),
                   group=group)
    return params


def data_sharding(mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """Batch-leading arrays: dim 0 over 'data', the rest replicated."""
    return ("data",) + (None,) * (ndim - 1)


def shard_batch(batch: Any, mesh=None) -> Any:
    """A rank's batch is its own rows: nothing to move."""
    return batch


def replicated(mesh=None) -> Tuple[()]:
    """The spec of a replicated array: no dimension on a mesh axis."""
    return ()
