"""Tensor parallelism over the mesh's 'model' axis: the collectives that
JAX's GSPMD inserts around the sharded products.

A tree sharded by ``parallel.mesh.shard_params`` holds, on each rank of a
model group, ``heads / tp`` heads of every attention (q/k/v kernels and
biases sliced along their output, the out-projection along its input) and
``ffn / tp`` columns of every MLP (fc1 along its output, fc2 along its
input); everything else is replicated.  The column-parallel products need
no communication forward; a row-parallel product gives each rank a partial
sum, which :func:`reduce_sum` adds up over the group in fp32 before the one
cast and the bias (the closest match to one unsharded product, on gloo and
NCCL alike).  Backward, :func:`copy_to` sums the gradient of a replicated
input over the group (Megatron's f and g).

The model finds the degree from a q kernel's output width against the
config's ``d_model`` (``[.., d_model, d_model / tp]``, :func:`group_of`;
the output is the dimension that 'data' never splits, so a 2-D-sharded
``[.., d_model / dp, d_model / tp]`` kernel reads the same degree) and
the group from the mesh that ``make_mesh`` registered for that degree:
the world size fixes the data axis, so a job has at most one mesh a
degree.  With no mesh, or at
tp 1, every function here is the identity and issues no collective.

Without a gradient (inference, a frozen teacher) the collectives go
through ``device_comm``: on a CUDA tensor the group's comm on the card
(capturable, combined in rank order: every rank gets the same bits), on a
CPU tensor its plain version.  The autograd functions of training
(:class:`_CopyToModel`, :class:`_ReduceFromModel`) keep
``torch.distributed``'s all-reduce.

``parallel.groups.timed`` counts the model group's all-reduces and, on
the card, times them with CUDA events.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from . import device_comm
from .groups import group_for, recorded

def degree(p: Dict[str, Any], d_model: int) -> int:
    """The model-axis size a q (or k/v) projection ``{kernel | kernel_q}
    [.., d_model (/ dp), d_model / tp]`` of a ``d_model``-wide model was
    sharded over."""
    w = p["kernel"] if "kernel" in p else p["kernel_q"]
    if d_model % w.shape[-1]:
        raise ValueError(f"a q/k/v projection {w.shape[-1]} wide does not "
                         f"divide d_model = {d_model}")
    return d_model // w.shape[-1]


def group_of(p: Dict[str, Any], d_model: int):
    """The model group of a column-parallel projection (None: unsharded)."""
    return group_for("model", degree(p, d_model))


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's place in its model group: which shard it holds."""
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` by ``torch.distributed`` (the
    autograd functions of training), recorded."""
    n = dist.get_world_size(group)
    with recorded(t, "all_reduce",
                  2 * (n - 1) * t.numel() * t.element_size() // n):
        dist.all_reduce(t, group=group)
    return t


def _reduce(t: torch.Tensor, group, mode: str) -> torch.Tensor:
    """A new tensor: ``t`` combined over ``group`` by the device comm
    (CUDA) or its plain version (CPU), in rank order, recorded."""
    n = dist.get_world_size(group)
    with recorded(t, "all_reduce",
                  2 * (n - 1) * t.numel() * t.element_size() // n):
        return device_comm.all_reduce(t, mode, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.float().contiguous(), ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """fp32 sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.to(torch.float32, copy=True).contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input of column-parallel products: the same tensor,
    whose gradient is summed over the group."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of row-parallel partials ``x``, in fp32."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    return _reduce(x.detach().to(torch.float32), group, "sum")


def reduce_int(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over the group of int32 partial products."""
    if group is None:
        return x
    return _reduce(x.detach().to(torch.int32), group, "sum_int")


@torch.no_grad()
def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (no gradient): the absmax of an int8
    scale whose reduction axis is sharded."""
    if group is None:
        return x
    return _reduce(x.detach().to(torch.float32), group, "max")


@torch.no_grad()
def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in order."""
    if group is None:
        return x
    parts = device_comm.all_gather(x.detach(), group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def rand_shard(shape, dim: int, group, generator: torch.Generator,
               device) -> torch.Tensor:
    """Uniforms of the rank's slice along ``dim`` of an unsharded draw of
    ``shape`` with ``dim`` ``size(group)`` times wider: dropout under tensor
    parallelism draws the masks of one rank (ranks of a model group share
    the generator's seed)."""
    n = size(group)
    if n == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = list(shape)
    full[dim] *= n
    u = torch.rand(full, generator=generator, device=device)
    return u.narrow(dim, index(group) * shape[dim], shape[dim])


def matmul(x: torch.Tensor, kernel: torch.Tensor, group) -> torch.Tensor:
    """``x @ kernel`` in x.dtype (fp32 accumulation, one cast).  With a
    ``group``, a row-parallel product: ``x`` holds this rank's slice of
    the contraction, and the fp32 partials are summed over the group
    before the cast."""
    w = kernel.to(x.dtype)
    if group is None:
        return torch.matmul(x, w)
    return reduce_sum(_Fp32Product.apply(x, w), group).to(x.dtype)


class _Fp32Product(torch.autograd.Function):
    """``x @ w`` for operands of one dtype, accumulated and written in fp32:
    the partial before the one rounding of the unsharded product.  Forward
    on the card, cuBLAS writes the fp32 output of a bf16 product; the CPU
    has no such call, so it multiplies the operands in fp32 (exact: a bf16
    value is an fp32 value).  Backward, the gradients in the operands'
    dtype, as ``torch.matmul``'s: a bf16 step keeps bf16 products and saves
    no fp32 copies."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = torch.mm(x2.float(), w.float())
        return y.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.t() if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw
