"""Collectives on the card that a CUDA graph can hold: one
:class:`DeviceComm` for the ranks of a mesh group.

gloo's collectives run on the host and cannot be captured, and NCCL needs
a card per rank; the decode loops replay as CUDA graphs with their
collectives inside (JAX compiles XLA's into its meshed program).  A comm
owns a workspace on this rank's card (``csrc/mesh_collective.cu``: two
slots, counting semaphores, a device epoch), whose CUDA IPC handle every
rank of the group opens, the handles exchanged over the group itself.  A
call copies this rank's tensor into its slot, signals the peers, waits
for theirs and combines the group's slots in rank order, so every rank
gets the same bits.  A call larger than a slot runs as several, a slot
each.

A comm is made at the first collective of CUDA tensors over its ranks
(or the first program key of a tree sharded over them), which every rank
of the group reaches at the same point, and then kept for the process's
life, one for each set of ranks, whatever mesh the group came from: a
mesh whose groups issue no collective on the card (data parallel
training) makes none.  Its slot is the largest of what the sharded trees
reserved for the group (:func:`reserve`, from ``mesh.shard_params`` and
``WhisperPipeline``: the largest flat gather of a 2-D tree, the encoder's
row-parallel partial at the batch) and the first call, agreed over the
group.  The workspace keeps its address, which a captured program holds;
it lives outside PyTorch's allocator (``cudaMalloc``), so
``torch.cuda.empty_cache()`` never frees it.

A call waits for its peers on the stream (``cuStreamWaitValue32``): a
time-sliced card switches to the other ranks' contexts at once, as long
as no other stream of the rank has work queued behind the waiting one
(then it switches at the end of the slice: a caller replays a graph of
collectives on its own stream, or reads its result before it queues
more).  The wait is bounded on the host: the decode loops read the device
through :func:`host_read`, which waits for the stream at most
:data:`TIMEOUT_S` and raises :class:`CommError` with the group past it.

The plain version (:func:`all_reduce_plain`, :func:`all_gather_plain`) is
``torch.distributed``'s all_gather over the group followed by the same
rank-ordered combine; it runs for CPU tensors only.  A CUDA tensor goes
through the group's comm.

Calls of one comm must be ordered on the device as they are on the host:
the callers issue them on one stream at a time, and
``generation/graphs.py``'s side streams wait for the caller's stream
before a replay and make it wait after (the engine replays its blocks on
the caller's stream itself).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

#: seconds a rank waits for the card's work (a peer's signal) at a host
#: read before the collective fails
TIMEOUT_S = 300.0

#: the least slot a comm is made with (a group no tree reserved for)
MIN_SLOT = 1 << 20

MODES = {"sum": 0, "sum_int": 1, "max": 2, "gather": 3}

# the ranks of a group -> their comm, and the slot bytes reserved for them
_COMMS: Dict[Tuple[int, ...], "DeviceComm"] = {}
_RESERVED: Dict[Tuple[int, ...], int] = {}


class CommError(RuntimeError):
    """A collective on the card timed out waiting for a peer."""


def _lib():
    from ..ops import _build      # lazily: importing parallel loads no ops
    lib = _build.load("mesh_collective")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.dw_mc_alloc.argtypes = [ll, pp]
    lib.dw_mc_ipc_handle_bytes.argtypes = []
    lib.dw_mc_ipc_handle.argtypes = [p, p]
    lib.dw_mc_ipc_open.argtypes = [p, pp]
    lib.dw_mc_collective.argtypes = [
        ctypes.POINTER(ll), i, i, ll, i, p, p, ll, ll, p]
    for name in ("dw_mc_alloc", "dw_mc_ipc_handle_bytes", "dw_mc_ipc_handle",
                 "dw_mc_ipc_open", "dw_mc_collective", "dw_mc_max_ranks"):
        getattr(lib, name).restype = i
    return lib


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: error {err}")


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def combine_plain(parts: List[torch.Tensor], mode: str) -> torch.Tensor:
    """The group's tensors combined in rank order: fp32 or int32 sums
    added one after another from rank 0, the max with NaN kept (as
    ``torch.maximum``), or stacked (``gather``)."""
    if mode == "gather":
        return torch.stack(parts)
    acc = parts[0].clone()
    for v in parts[1:]:
        if mode == "max":
            acc = torch.where((v > acc) | v.isnan(), v, acc)
        else:
            acc += v
    return acc


def _gather_parts(x: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def all_reduce_plain(x: torch.Tensor, mode: str, group) -> torch.Tensor:
    """:func:`all_reduce`'s plain version: the group's tensors gathered by
    ``torch.distributed``, then combined in rank order."""
    return combine_plain(_gather_parts(x.contiguous(), group), mode)


def all_gather_plain(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather`'s plain version: the group's tensors [n, ...],
    gathered as raw bytes (gloo takes no int16 or bfloat16)."""
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    parts = torch.stack(_gather_parts(raw, group))
    return parts.view(x.dtype).reshape(len(parts), *x.shape)


def _check_dtype(x: torch.Tensor, mode: str) -> None:
    want = torch.int32 if mode == "sum_int" else torch.float32
    if mode != "gather" and x.dtype != want:
        raise ValueError(f"a {mode} collective takes {want}, not {x.dtype}")


def all_reduce(x: torch.Tensor, mode: str, group) -> torch.Tensor:
    """A new tensor: ``x`` of every rank of ``group`` summed (``"sum"``,
    fp32; ``"sum_int"``, int32, exact) or its elementwise max (``"max"``,
    fp32), in rank order, the same bits on every rank.  CUDA tensors go
    through the group's :class:`DeviceComm`, CPU tensors through the
    plain version."""
    _check_dtype(x, mode)
    if x.is_cuda:
        return comm_of(group, x.numel() * 4).all_reduce(x, mode)
    return all_reduce_plain(x, mode, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, stacked in rank order: [n, ...]."""
    if x.is_cuda:
        return comm_of(group, x.numel() * x.element_size()).all_gather(x)
    return all_gather_plain(x, group)


def _ranks(group) -> Tuple[int, ...]:
    return tuple(dist.get_process_group_ranks(group))


def reserve(group, nbytes: int) -> None:
    """Size the comm of ``group``'s ranks, when it is made, for calls of
    ``nbytes`` (a rank's part): its slot is the largest reservation and
    the first call.  A comm already made keeps its slot (a larger call
    runs as several).  Outside a job nothing is reserved: no comm is
    made there."""
    if not dist.is_initialized():
        return
    key = _ranks(group)
    _RESERVED[key] = max(reserved(key), int(nbytes))


def reserved(ranks: Tuple[int, ...]) -> int:
    """The largest reservation for a group of ``ranks``."""
    return _RESERVED.get(tuple(ranks), 0)


def comm_of(group, nbytes: int = 0) -> "DeviceComm":
    """The comm of ``group``'s ranks, made at this call if there is none
    (every rank of the group calls alike) with a slot of the reservation,
    ``nbytes`` and :data:`MIN_SLOT`, whichever is largest.  A capture
    makes none: its warm-up ran the collectives before it."""
    key = _ranks(group)
    comm = _COMMS.get(key)
    if comm is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"a collective over the ranks {list(key)} captured before "
                "its device comm was made: run the program once before "
                "capturing it")
        comm = _COMMS[key] = DeviceComm(group, max(
            reserved(key), nbytes, MIN_SLOT))
    return comm


def comms() -> List["DeviceComm"]:
    return list(_COMMS.values())


def wait_device(device) -> None:
    """Wait for the work queued so far on ``device``'s current stream, at
    most :data:`TIMEOUT_S`: past it a collective waits for a peer that
    does not come, and :class:`CommError` is raised (no comm: no bound,
    and nothing waits on a peer)."""
    live = comms()
    if not live:
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    deadline = time.monotonic() + TIMEOUT_S
    polls = 0
    while not ev.query():
        polls += 1
        if polls > 1000:        # past the first ~ms, leave the GIL between
            time.sleep(5e-5)    # polls to the serving threads
        if time.monotonic() > deadline:
            raise CommError(
                f"the card's work did not end within {TIMEOUT_S:g} s: a "
                f"collective over the ranks "
                f"{' or '.join(str(c.ranks) for c in live)} waits for a peer "
                "that does not come")


def host_read(t: torch.Tensor):
    """``t.tolist()``, the decode loops' read of the device: for a CUDA
    tensor, once the stream's work ended within the bound
    (:func:`wait_device`)."""
    if t.is_cuda:
        wait_device(t.device)
    return t.tolist()


def key_of(groups, cuda: bool) -> tuple:
    """The identity of the comms of ``groups`` (None entries skipped), for
    a captured program's key: their ranks and, for a program on the card,
    their workspaces (the comms made here if need be: every rank of a
    group keys its program at the same point)."""
    return tuple(comm_of(g).key if cuda else (_ranks(g),)
                 for g in groups if g is not None)


def pieces(nbytes: int, slot: int) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of the calls a collective of ``nbytes`` (a
    rank's part) takes through slots of ``slot`` bytes (a multiple of
    16): all but the last a whole slot."""
    return [(o, min(slot, nbytes - o)) for o in range(0, nbytes, slot)]


def _counter(mode: str):
    def launches():
        """The collective kernel's launches in one mode (a count a mode,
        as every kernel wrapper of the port keeps one)."""
    launches.__name__ = f"mesh_{mode}"
    launches.launches = 0
    return launches


#: the kernel's launches, by mode (``ops/_build.py::count_launch``)
COUNTERS = {mode: _counter(mode) for mode in MODES}


def _exchange(group, data: torch.Tensor) -> List[torch.Tensor]:
    """``data`` (a small CPU tensor) of every rank of ``group``, in rank
    order, over the group itself (on the card for NCCL)."""
    if dist.get_backend(group) == "nccl":
        data = data.cuda()
    return [t.cpu() for t in _gather_parts(data, group)]


class DeviceComm:
    """A group's workspace on this rank's card and the peers' mapped by
    IPC, with a slot of the largest ``slot`` any rank asks for."""

    def __init__(self, group, slot: int):
        lib = _lib()
        self.ranks = list(_ranks(group))
        self.n, self.me = len(self.ranks), dist.get_rank(group)
        if self.n > lib.dw_mc_max_ranks():
            raise ValueError(f"a device comm of {self.n} ranks: at most "
                             f"{lib.dw_mc_max_ranks()}")
        want = _exchange(group, torch.tensor([_round16(slot)]))
        self.slot = int(max(int(w) for w in want))
        self.device = torch.device("cuda", torch.cuda.current_device())
        base = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _ok(lib.dw_mc_alloc(self.slot, ctypes.byref(base)),
                "the comm's workspace")
        self.base = base.value
        hb = lib.dw_mc_ipc_handle_bytes()
        handle = (ctypes.c_uint8 * hb)()
        _ok(lib.dw_mc_ipc_handle(self.base, ctypes.addressof(handle)),
            "cudaIpcGetMemHandle")
        parts = _exchange(group, torch.tensor(list(bytes(handle)),
                                              dtype=torch.uint8))
        self.peers: List[int] = []
        for j, r in enumerate(self.ranks):
            if j == self.me:
                self.peers.append(self.base)
                continue
            h = (ctypes.c_uint8 * hb)(*parts[j].tolist())
            ptr = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                _ok(lib.dw_mc_ipc_open(ctypes.addressof(h),
                                       ctypes.byref(ptr)),
                    f"cudaIpcOpenMemHandle of rank {r}'s workspace")
            self.peers.append(ptr.value)
        self.bases = (ctypes.c_longlong * self.n)(*self.peers)
        # what a captured program's key holds of the comm
        self.key = (tuple(self.ranks), self.base)

    def _launch(self, mode: str, x: torch.Tensor, out: torch.Tensor,
                nbytes: int, stride: int) -> None:
        """One collective of ``nbytes`` (a rank's part) from ``x`` into
        ``out``, a call a slot (:func:`pieces`)."""
        if x.device != self.device:
            raise ValueError(f"the comm lives on {self.device}, the tensor "
                             f"on {x.device}")
        from ..ops import _build
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            for off, size in pieces(nbytes, self.slot):
                err = lib.dw_mc_collective(
                    self.bases, self.n, self.me, self.slot, MODES[mode],
                    x.data_ptr() + off, out.data_ptr() + off,
                    size if mode == "gather" else size // 4, stride, stream)
                _ok(err, f"the mesh collective ({mode})")
                _build.count_launch(COUNTERS[mode])

    @staticmethod
    def _aligned(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x if x.data_ptr() % 16 == 0 else x.clone()

    def all_reduce(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        _check_dtype(x, mode)
        x = self._aligned(x)
        out = torch.empty_like(x)
        if x.numel():
            self._launch(mode, x, out, x.numel() * 4, 0)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = self._aligned(x)
        nbytes = x.numel() * x.element_size()
        stride = _round16(nbytes)
        out = torch.empty((self.n, stride), dtype=torch.uint8,
                          device=x.device)
        if nbytes:
            self._launch("gather", x, out, nbytes, stride)
        return (out[:, :nbytes].view(x.dtype)
                .reshape(self.n, *x.shape))
