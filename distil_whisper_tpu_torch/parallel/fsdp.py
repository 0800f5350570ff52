"""Parameters sharded over the mesh's 'data' axis (``RULES_2D``,
FSDP-style): the all-gathers that JAX's GSPMD inserts where a 2-D-sharded
leaf is used.

A tree placed by ``parallel.mesh.shard_params(..., RULES_2D)`` holds, on
each rank, ``1 / dp`` of the 'embed' dimension of almost every leaf (on
top of the model group's slicing).  The model takes a layer's leaves
through :func:`gather_tree` where it takes the layer, and the other leaves
(convs, positions, embeddings, final LayerNorms) where it reads them: the
sliced leaves of one call are all-gathered over the data group in one
collective a dtype.  Backward, their gradients are reduce-scattered back
to the shards in one collective, summed in fp32 as
``training.distill.DataParallel`` sums the replicated leaves' gradients:
a data-sharded leaf's gradient is already the data group's sum.

Whether a leaf is sharded, and over how many data ranks, is read from its
'embed' dimension against ``d_model`` (the caller's config); the group is
the one ``make_mesh`` registered for that degree (``parallel.groups``).
A tree that is not sliced over 'data' passes through untouched, with no
collective.  Under
``remat`` the recompute gathers again; a frozen teacher runs under
``no_grad`` and keeps no gathered copy past its layer.

Outside autograd (a decode, a frozen teacher) the all-gathers go through
``device_comm``: the group's comm on the card for CUDA tensors, which a
CUDA graph captures, its plain version on the CPU.

``parallel.groups.timed`` counts and times the all-gathers and
reduce-scatters.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from . import device_comm
from .groups import group_for, recorded


def degree(w: torch.Tensor, d_model: int, dim: int = -2) -> int:
    """How many data ranks share the 'embed' dimension ``dim`` of ``w``
    (a q/k/v kernel's contraction by default): 1 for a leaf that is not
    sliced over 'data'."""
    n = w.shape[dim]
    if d_model % n:
        raise ValueError(f"an 'embed' dimension of {n} does not divide "
                         f"d_model = {d_model}")
    return d_model // n


def is_sharded(p: Dict[str, Any], d_model: int) -> bool:
    """True when the projection ``p`` ({kernel | kernel_q, ...}) is sliced
    over 'data': the model then gathers its trees at use."""
    w = p["kernel"] if "kernel" in p else p["kernel_q"]
    return degree(w, d_model) > 1


@functools.lru_cache(maxsize=None)
def _data_dim(path: str, sliced: bool) -> Optional[int]:
    from .mesh import RULES_2D, data_dim
    dim = data_dim(path, RULES_2D)
    if dim is None or not sliced:
        return dim
    return dim - 1      # the layer slice dropped the leading 'layers' axis


def _gather_flat(xs: List[torch.Tensor], dims: List[int], group,
                 training: bool = False) -> List[torch.Tensor]:
    """The data group's shards of each of ``xs`` (one dtype) concatenated
    along its ``dims`` entry, in rank order: one all-gather for all,
    through ``device_comm`` (the card's comm for CUDA tensors, capturable;
    its plain version on the CPU), or ``torch.distributed``'s when
    ``training`` (the forward of :class:`_GatherFromData`)."""
    n = dist.get_world_size(group)
    flat = torch.cat([x.detach().reshape(-1) for x in xs])
    with recorded(flat, "all_gather", flat.numel() * flat.element_size()
                  * (n - 1)):
        if training:
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=group)
        else:
            parts = list(device_comm.all_gather(flat, group).unbind(0))
    out, o = [], 0
    for x, dim in zip(xs, dims):
        k = x.numel()
        out.append(torch.cat([p[o:o + k].view(x.shape) for p in parts],
                             dim=dim))
        o += k
    return out


def _scatter_flat(gs: List[torch.Tensor], dims: List[int],
                  group) -> List[torch.Tensor]:
    """This rank's part along its ``dims`` entry of the fp32 sum over the
    group of each of ``gs``: one reduce-scatter for all.  NCCL
    reduce-scatters; gloo (whose reduce-scatter not every PyTorch release
    has) all-reduces and keeps the rank's part, the same sum."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    pieces = [[c.reshape(-1) for c in g.float().chunk(n, dim)]
              for g, dim in zip(gs, dims)]
    send = [torch.cat([p[r] for p in pieces]) for r in range(n)]
    with recorded(send[0], "reduce_scatter", send[0].numel() * 4 * (n - 1)):
        if dist.get_backend(group) == "nccl":
            out = torch.empty_like(send[0])
            dist.reduce_scatter(out, send, group=group)
        else:
            full = torch.stack(send)
            dist.all_reduce(full, group=group)
            out = full[i]
    res, o = [], 0
    for g, dim in zip(gs, dims):
        shape = list(g.shape)
        shape[dim] //= n
        k = math.prod(shape)
        res.append(out[o:o + k].view(shape))
        o += k
    return res


class _GatherFromData(torch.autograd.Function):
    """All-gather of several shards over the data group forward; their
    gradients reduce-scattered to the shards backward (fp32 sums, then
    each shard's dtype)."""

    @staticmethod
    def forward(ctx, dims, group, *xs):
        ctx.dims, ctx.group = dims, group
        ctx.dtypes = [x.dtype for x in xs]
        return tuple(_gather_flat(list(xs), dims, group, training=True))

    @staticmethod
    def backward(ctx, *gs):
        # an output the loss does not reach comes as zeros (autograd
        # materializes them), so every rank scatters the same buffer
        grads = _scatter_flat(list(gs), ctx.dims, ctx.group)
        return (None, None, *[
            g.to(dtype) if need else None for g, dtype, need in zip(
                grads, ctx.dtypes, ctx.needs_input_grad[2:])])


def _gather_leaves(items) -> List[torch.Tensor]:
    """``items``: (leaf, its 'embed' dimension, its path, d_model).  Each
    leaf whole, int8 kernels output-major; leaves sliced alike and of one
    dtype travel in one collective; differentiable."""
    out: List[Any] = [None] * len(items)
    batches: Dict[Any, List[int]] = {}
    for j, (x, dim, path, d_model) in enumerate(items):
        dp = degree(x, d_model, dim)
        if dp == 1:
            out[j] = x
        else:
            batches.setdefault((dp, x.dtype), []).append(j)
    for (dp, _), js in batches.items():
        group = group_for("data", dp)
        xs = [items[j][0] for j in js]
        dims = [items[j][1] for j in js]
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            full = _GatherFromData.apply(dims, group, *xs)
        else:
            full = _gather_flat(xs, dims, group)
        for j, y in zip(js, full):
            if items[j][2].endswith("kernel_q"):
                from ..ops.quant import output_major
                y = output_major(y)
            out[j] = y
    return out


def largest_gather(tree: Dict[str, Any]) -> int:
    """The bytes a rank sends in the largest all-gather outside autograd
    of ``tree`` (a whole param tree, sliced over 'data'): one layer of a
    stack or one top-level module (``models/whisper.py``'s ``_layer`` and
    ``_leaf``), its sliced leaves of one dtype travelling together."""
    from ..models.params import tree_paths
    sizes: Dict[Any, int] = {}
    for path, x in tree_paths(tree).items():
        if not torch.is_tensor(x) or _data_dim(path, False) is None:
            continue
        parts = path.split(".")
        nbytes = x.numel() * x.element_size()
        if len(parts) > 2 and parts[1] == "layers":
            nbytes //= x.shape[0]      # one layer of the stack
        site = (".".join(parts[:2]), x.dtype)
        sizes[site] = sizes.get(site, 0) + nbytes
    return max(sizes.values(), default=0)


def gather_tree(tree: Dict[str, Any], root: str, d_model: int,
                sliced: bool = False) -> Dict[str, Any]:
    """``tree`` (the subtree at param path ``root``, e.g.
    ``"decoder.layers"``; ``sliced``: one layer's views of a stacked
    subtree) with every leaf that is sliced over 'data' gathered, one
    collective a dtype.  Leaves without an 'embed' dimension (q/k/v
    biases, QAT markers, the int8 lm head) pass through."""
    from ..models.params import tree_paths, unflatten_paths
    flat = tree_paths(tree)
    todo = [(p, _data_dim(f"{root}.{p}", sliced)) for p in flat]
    todo = [(p, dim) for p, dim in todo if dim is not None]
    full = _gather_leaves([(flat[p], dim, p, d_model) for p, dim in todo])
    flat.update(zip((p for p, _ in todo), full))
    return unflatten_paths(flat)


def gather_leaf(x: torch.Tensor, path: str, d_model: int) -> torch.Tensor:
    """The whole leaf at param path ``path`` (differentiable)."""
    dim = _data_dim(path, False)
    return x if dim is None else _gather_leaves([(x, dim, path, d_model)])[0]
