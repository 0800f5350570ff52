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

The model finds the degree from a layer's shapes (a q kernel is ``[..,
d_model, d_model / tp]``, :func:`group_of`) and the group from the mesh
that ``make_mesh`` registered for that degree: the world size fixes the
data axis, so a job has at most one mesh a degree.  With no mesh, or at
tp 1, every function here is the identity and issues no collective.

:func:`timed` counts the all-reduces of the model group and, on the card,
times them with CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist

# model-axis size -> this rank's model group, one per mesh made
_GROUPS: Dict[int, Any] = {}
# the open timed() record, if any
_RECORD: List["Record"] = []


def register(tp: int, group) -> None:
    """Make ``group`` the model group of degree ``tp`` (``make_mesh``)."""
    _GROUPS[tp] = group


def group_for(tp: int):
    """This rank's model group of degree ``tp`` (None at tp 1)."""
    if tp == 1:
        return None
    if tp not in _GROUPS:
        raise ValueError(f"parameters sharded {tp} ways, but no mesh with a "
                         f"'model' axis of {tp} was made in this process "
                         "(parallel.make_mesh)")
    return _GROUPS[tp]


def degree(p: Dict[str, Any]) -> int:
    """The model-axis size a q (or k/v) projection ``{kernel | kernel_q}
    [.., d_model, d_model / tp]`` was sharded over."""
    w = p["kernel"] if "kernel" in p else p["kernel_q"]
    return w.shape[-2] // w.shape[-1]


def group_of(p: Dict[str, Any]):
    """The model group of a column-parallel projection (None: unsharded)."""
    return group_for(degree(p))


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    """This rank's place in its model group: which shard it holds."""
    return 0 if group is None else dist.get_rank(group)


class Record:
    """All-reduces of the model group while a :func:`timed` block is open:
    their count, the host's time inside the calls (all of a gloo
    all-reduce, which returns when it is done; an NCCL call only enqueues)
    and, on the card, their device time between CUDA events."""

    def __init__(self):
        self.count = 0
        self.host_ms = 0.0
        self.events: List[Any] = []

    def ms(self) -> float:
        if not self.events:
            return 0.0
        self.events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


@contextlib.contextmanager
def timed():
    """``with timed() as rec:`` counts (and on the card times) the model
    group's all-reduces of the block: ``rec.count``, ``rec.ms()``."""
    rec = Record()
    _RECORD.append(rec)
    try:
        yield rec
    finally:
        _RECORD.remove(rec)


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``, recorded."""
    rec = _RECORD[-1] if _RECORD else None
    if rec is not None and t.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    if rec is not None:
        rec.host_ms += (time.perf_counter() - t0) * 1e3
        rec.count += 1
        if t.is_cuda:
            end.record()
            rec.events.append((start, end))
    return t


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
    return _all_reduce(x.to(torch.float32, copy=True).contiguous(), group)


def reduce_int(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over the group of int32 partial products."""
    if group is None:
        return x
    return _all_reduce(x.contiguous().clone(), group)


@torch.no_grad()
def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (no gradient): the absmax of an int8
    scale whose reduction axis is sharded."""
    if group is None:
        return x
    return _all_reduce(x.detach().to(torch.float32, copy=True).contiguous(),
                       group, dist.ReduceOp.MAX)


@torch.no_grad()
def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, in order."""
    if group is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


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
