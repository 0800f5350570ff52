"""Process groups and host-side collectives for data-parallel runs.

The port of ``distil_whisper_tpu.parallel.multihost`` on
``torch.distributed``: one process ("rank") per GPU, started by ``torchrun``
(or anything that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``).  Every driver can run so, each rank
feeding its own rows.

Two groups: the default group carries the device tensors (gradients,
parameter broadcasts, token counts): NCCL when every rank on a host has a
card of its own, gloo otherwise (CPU runs, or two ranks sharing one card,
which NCCL refuses).  Host arrays (error counts, row gathers, flags,
barriers) go over a gloo group made beside it, so they work under NCCL
too.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("distil_whisper_tpu_torch")

# what the collectives of a bucket hold at most, in bytes
BUCKET_BYTES = 256 << 20

# the gloo group of the host-side collectives (the default group when it is
# gloo already); set once per process by maybe_initialize_distributed
_HOST_GROUP: Dict[str, Any] = {}

CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def world_size() -> int:
    """Ranks in the job: 1 unless a process group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank: 0 unless a process group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_distributed() -> bool:
    return world_size() > 1


def default_backend(local_world: int, device: str = "cuda") -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise
    (CPU runs, or more ranks than cards on the host)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(force: bool = False,
                                 device: str = "cuda",
                                 timeout: Optional[float] = None) -> bool:
    """Join the ``torch.distributed`` job described by the environment
    (idempotent); True when this process runs as one of several ranks.

    Without a cluster environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them) or with a
    world size of 1 it returns False, unless ``force`` is set (the CLIs'
    ``--distributed``): then it RAISES, so a misconfigured launch fails
    fast instead of silently training on one GPU.  On a CUDA run each rank
    makes ``cuda:LOCAL_RANK`` its current device (modulo the host's cards,
    so that ranks may share one card over gloo).  ``timeout`` (seconds):
    how long a collective waits for the other ranks before it raises
    (PyTorch's default otherwise)."""
    if dist.is_initialized():
        return is_distributed()
    missing = [k for k in CLUSTER_ENV if not os.environ.get(k)]
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if missing or world <= 1:
        if force:
            raise RuntimeError(
                "--distributed was set but no multi-GPU job is visible: "
                + (f"{', '.join(missing)} not set" if missing
                   else "the job has world size 1")
                + "; launch one process per GPU with torchrun "
                "(--nproc_per_node N), which sets the environment")
        return False
    rank_ = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = default_backend(local_world, device)
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kw = ({} if timeout is None
          else {"timeout": datetime.timedelta(seconds=timeout)})
    dist.init_process_group(backend, init_method="env://", rank=rank_,
                            world_size=world, **kw)
    _HOST_GROUP["group"] = (None if backend == "gloo"
                            else dist.new_group(backend="gloo", **kw))
    log.info("torch.distributed initialised: rank %d/%d (local %d), "
             "backend %s", rank_, world, local_rank, backend)
    return True


def host_group():
    """The gloo group of the host-side collectives (None: the default)."""
    return _HOST_GROUP.get("group")


def barrier() -> None:
    """Wait for every rank (no-op in a single process)."""
    if is_distributed():
        dist.barrier(group=host_group())


def process_local_slice(n_items: int, index: int = None,
                        count: int = None) -> slice:
    """Which slice of a globally ordered dataset this rank feeds: equal
    slices of ``n_items // world`` rows, the tail dropped.  ``index`` and
    ``count``: the rank's data coordinate and the data axis's size, in
    place of the rank and the world (tensor parallelism)."""
    count = world_size() if count is None else count
    i = rank() if index is None else index
    per = n_items // max(count, 1)
    return slice(i * per, (i + 1) * per)


def host_local_batch_to_global(batch: Any, mesh=None) -> Any:
    """The global batch of this rank's rows: the batch itself.

    In JAX, GSPMD places each host's rows wherever that host's devices sit
    along the mesh's 'data' axis, so a host batch has to be assembled into
    a global array.  Under data parallelism each rank owns its rows and
    runs its own replica on them, so there is nothing to assemble."""
    return batch


def global_row_positions(mesh, local_rows: int) -> np.ndarray:
    """Global-row index of each of this rank's rows in a
    :func:`gather_rows` result: the rank's contiguous block, since
    ``gather_rows`` concatenates in rank order (the JAX package measures
    the placement because a TPU mesh may reorder devices)."""
    return np.arange(local_rows) + rank() * local_rows


def gather_rows(x: Any) -> np.ndarray:
    """Every rank's rows of a host array (the same shape on every rank),
    concatenated in rank order, on every rank.  A single process gets its
    own array back."""
    x = np.ascontiguousarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if not is_distributed():
        return x
    mine = torch.from_numpy(x)
    parts = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(parts, mine, group=host_group())
    return np.concatenate([p.numpy() for p in parts])


def sum_over_ranks(x: Any) -> np.ndarray:
    """Elementwise sum of a host array over the ranks (error counts: what
    the JAX package does with ``process_allgather(...).sum()``)."""
    x = np.asarray(x)
    if not is_distributed():
        return x
    wide = np.int64 if np.issubdtype(x.dtype, np.integer) else np.float64
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=wide))
    dist.all_reduce(t, group=host_group())
    return t.numpy()


def any_over_ranks(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any."""
    return bool(sum_over_ranks(np.asarray([int(bool(flag))]))[0])


# -- device-tensor collectives over the default group, in buckets ---------

def _buckets(tensors: List[torch.Tensor], same_dtype: bool):
    """Consecutive runs of ``tensors`` of at most BUCKET_BYTES (one tensor
    alone may exceed it), split where the dtype changes when
    ``same_dtype``."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * (4 if not same_dtype else t.element_size())
        if bucket and (size + nbytes > BUCKET_BYTES or (
                same_dtype and t.dtype != bucket[0].dtype)):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_sum(tensors: List[torch.Tensor], group=None
                   ) -> List[torch.Tensor]:
    """Sums of ``tensors`` over the ranks of ``group``, in fp32: each
    bucket is flattened into one fp32 vector and all-reduced at once.
    Returns new tensors, in order."""
    out: List[torch.Tensor] = []
    for bucket in _buckets(tensors, same_dtype=False):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        dist.all_reduce(flat, group=group)
        out += [f.view(t.shape) for f, t in
                zip(flat.split([t.numel() for t in bucket]), bucket)]
    return out


@torch.no_grad()
def broadcast_(tensors: List[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values (global
    rank), a bucket of one dtype at a time, bit for bit."""
    order = sorted(range(len(tensors)), key=lambda i: str(tensors[i].dtype))
    for bucket in _buckets([tensors[i] for i in order], same_dtype=True):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src=src, group=group)
        for f, t in zip(flat.split([t.numel() for t in bucket]), bucket):
            t.copy_(f.view(t.shape))


def rank_generator(seed: int, device="cpu", mesh=None) -> torch.Generator:
    """A generator seeded with (seed, this rank's data coordinate on
    ``mesh``; its rank without one): each data rank's own dropout draws
    (data ranks drawing the same masks would train correlated replicas),
    and one draw for the ranks of a model group, whose replicated
    activations must agree and whose sliced masks must add up to the
    unsharded mask (``tensor_parallel.rand_shard``)."""
    from .mesh import coordinates
    index = rank() if mesh is None else coordinates(mesh)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + index)
    return gen

