"""Device mesh and logical-axis rules on ``torch.distributed``.

The port of ``distil_whisper_tpu.parallel.mesh``: one
``torch.distributed.device_mesh.DeviceMesh`` over ``('data', 'model')``
(the model axis inner, so a model group is consecutive ranks) and the JAX
package's rule tables from logical parameter axes
(``models/init.py::param_axes``) to mesh axes.

Each rank feeds the rows of its data coordinate.  :func:`shard_params`
slices every leaf whose logical axes map to ``'model'`` (the heads of q/k/v
and out, the ffn columns of fc1/fc2; ``parallel/tensor_parallel.py`` runs
the products on them) and broadcasts the result from the first rank of the
data axis, so that all replicas start bit-identical; :func:`gather_params`
is its inverse (checkpoints and exports are topology-free).  ``RULES_2D``
(parameters sharded over ``'data'`` too, FSDP-style) raises, naming the
ROADMAP.md item that brings it.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from . import tensor_parallel
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

NEXT_SLICE = ("comes with the 2-D sharding and serving-under-a-mesh slice: "
              "ROADMAP.md queue 1, item 2")


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              device_type: Optional[str] = None):
    """A ``(data, model)`` DeviceMesh over the job's ranks, all on 'data'
    by default.  Needs the process group (``maybe_initialize_distributed``);
    ``device_type`` defaults to cuda under NCCL, else cpu (a gloo group,
    whose collectives also take CUDA tensors).  A model axis larger than 1
    registers this rank's model group for its degree
    (``tensor_parallel.group_for``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {tuple(shape)} != {n} ranks: the model axis "
                         f"must divide the world size")
    if device_type is None:
        device_type = ("cuda" if torch.distributed.get_backend() == "nccl"
                       else "cpu")
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))
    if shape[1] > 1:
        tensor_parallel.register(shape[1], mesh.get_group("model"))
    return mesh


def _axis_size(mesh, name: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(name))


def data_group(mesh):
    """The process group of the 'data' axis, or None when there is no
    data parallelism to do (no mesh, or one rank on 'data')."""
    if _axis_size(mesh, "data") == 1:
        return None
    return mesh.get_group("data")


def model_group(mesh):
    """The process group of the 'model' axis (this rank's model group), or
    None without tensor parallelism (no mesh, or one rank on 'model')."""
    if _axis_size(mesh, "model") == 1:
        return None
    return mesh.get_group("model")


def coordinates(mesh) -> Tuple[int, int, int, int]:
    """``(data index, data size, model index, model size)`` of this rank:
    which rows it feeds, among how many data ranks, and which shard it
    holds.  ``(0, 1, 0, 1)`` without a mesh."""
    if mesh is None:
        return 0, 1, 0, 1
    d, m = (int(c) for c in mesh.get_coordinate())
    return d, _axis_size(mesh, "data"), m, _axis_size(mesh, "model")


def check_degree(cfg, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` divides the heads and ffn widths
    of ``cfg`` (a WhisperConfig)."""
    for name in ("encoder_attention_heads", "decoder_attention_heads",
                 "encoder_ffn_dim", "decoder_ffn_dim"):
        n = getattr(cfg, name)
        if n % tp:
            raise ValueError(f"a model axis of {tp} does not divide "
                             f"{name} = {n}")


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


@functools.lru_cache(maxsize=1)
def _axes_table() -> Dict[str, Tuple[str, ...]]:
    from ..models.init import param_axes
    from ..models.params import tree_paths
    return tree_paths(param_axes(None))


def leaf_axes(path: str) -> Optional[Tuple[Optional[str], ...]]:
    """The logical axes of the leaf at ``path`` (a param path, possibly
    under a prefix such as ``params.`` or ``mu.``), None for a leaf the
    table does not name (int8 lm head, QAT markers: replicated).  The int8
    leaves take their kernel's axes; ``kernel_scale`` keeps its contraction
    axis whole (it has size 1)."""
    parts = path.split(".")
    roots = [i for i, p in enumerate(parts) if p in ("encoder", "decoder")]
    if not roots:
        return None
    parts = parts[roots[0]:]
    leaf = parts[-1]
    if leaf in ("kernel_q", "kernel_scale"):
        parts[-1] = "kernel"
    axes = _axes_table().get(".".join(parts))
    if axes is not None and leaf == "kernel_scale":
        axes = axes[:-2] + (None,) + axes[-1:]
    return axes


def model_dim(path: str, rules: Dict[str, Optional[str]] = DEFAULT_RULES
              ) -> Optional[int]:
    """The dimension of the leaf at ``path`` that is sharded over
    'model', or None for a replicated leaf."""
    axes = leaf_axes(path)
    if axes is None:
        return None
    dims = [i for i, m in enumerate(spec_for_axes(axes, rules))
            if m == "model"]
    return dims[0] if dims else None


def shard_leaf(path: str, x: torch.Tensor, mesh=None,
               rules: Dict[str, Optional[str]] = DEFAULT_RULES
               ) -> torch.Tensor:
    """This rank's shard of the unsharded leaf ``x`` at ``path`` (``x``
    itself when the leaf is replicated or there is no model axis)."""
    _, _, i, tp = coordinates(mesh)
    dim = model_dim(path, rules)
    if tp == 1 or dim is None:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"{path}: dimension {dim} of shape {tuple(x.shape)} "
                         f"does not divide by a model axis of {tp}")
    if path.endswith("fc1.kernel_q"):
        from ..ops.int8_mlp import check_whole_chunks
        check_whole_chunks(n, tp)
    part = x.detach().narrow(dim, i * (n // tp), n // tp)
    if path.endswith("kernel_q"):
        # each shard output-major again (ops/quant.py::output_major)
        from ..ops.quant import output_major
        out = output_major(part)
    else:
        out = part.clone(memory_format=torch.contiguous_format)
    return out.requires_grad_(x.requires_grad)


def replicate_over_data(tree: Any, mesh=None) -> Any:
    """Overwrite every tensor leaf of ``tree`` in place with the values of
    the first rank of this rank's data group (no-op without data
    parallelism)."""
    group = data_group(mesh)
    if group is not None:
        from ..models.params import tree_paths
        leaves = [x for x in tree_paths(tree).values()
                  if isinstance(x, torch.Tensor)]
        with torch.no_grad():
            broadcast_(leaves,
                       src=torch.distributed.get_global_rank(group, 0),
                       group=group)
    return tree


def shard_params(params: Any, mesh=None,
                 rules: Dict[str, Optional[str]] = DEFAULT_RULES,
                 cfg=None) -> Any:
    """Place an unsharded param tree on the mesh: each leaf whose logical
    axes map to 'model' sliced to this rank's shard (a new tree), then
    every leaf broadcast over the data axis.  Float and int8 trees alike
    (quantize the unsharded tree, then shard: a row-parallel shard keeps
    its whole ``kernel_scale``).  ``cfg`` adds the check that the degree
    divides the heads.  Raises ``ValueError`` on a degree that divides no
    shard evenly or splits an int8 MLP chunk.  Returns ``params`` itself
    without a mesh; rules that shard parameters over 'data'
    (``RULES_2D``) raise."""
    if any(v == "data" for k, v in rules.items() if k != "batch"):
        raise NotImplementedError(
            f"parameters sharded over 'data' (RULES_2D, --param_sharding "
            f"2d) {NEXT_SLICE}")
    if model_group(mesh) is not None:
        if cfg is not None:
            check_degree(cfg, coordinates(mesh)[3])
        from ..models.params import map_with_path
        params = map_with_path(
            lambda path, x: shard_leaf(path, x, mesh, rules), params)
    return replicate_over_data(params, mesh)


def gather_params(params: Any, mesh=None,
                  rules: Dict[str, Optional[str]] = DEFAULT_RULES) -> Any:
    """The unsharded tree of a sharded one (every rank of a model group
    must call it): each sharded leaf gathered over the model group, int8
    kernels output-major again.  Returns ``params`` itself without tensor
    parallelism."""
    if model_group(mesh) is None:
        return params
    from ..models.params import map_with_path
    return map_with_path(
        lambda path, x: gather_leaf(path, x, mesh, rules), params)


def gather_leaf(path: str, x: torch.Tensor, mesh=None,
                rules: Dict[str, Optional[str]] = DEFAULT_RULES
                ) -> torch.Tensor:
    """The unsharded leaf of this rank's shard ``x`` at ``path``: gathered
    over the model group (a collective), int8 kernels output-major."""
    group = model_group(mesh)
    dim = model_dim(path, rules)
    if group is None or dim is None:
        return x
    full = tensor_parallel.all_gather(x.detach(), dim, group)
    if path.endswith("kernel_q"):
        from ..ops.quant import output_major
        full = output_major(full)
    return full


def data_sharding(mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """Batch-leading arrays: dim 0 over 'data', the rest replicated."""
    return ("data",) + (None,) * (ndim - 1)


def shard_batch(batch: Any, mesh=None) -> Any:
    """A rank's batch is its own rows: nothing to move."""
    return batch


def replicated(mesh=None) -> Tuple[()]:
    """The spec of a replicated array: no dimension on a mesh axis."""
    return ()
