"""Serving under a mesh: the leader's command stream and the followers'
loop.

A meshed pipeline is SPMD (every rank calls it alike), but requests reach
one HTTP server.  So a scheduler over a mesh runs as a leader and
followers: global rank 0 holds the front end, the queues and the host
logic, and every device call that issues a collective (an admission, a
step block, a fallback pipeline call, ...) goes through :meth:`Lockstep.call`,
which publishes it as a small command (its name, its arguments, the
shapes and dtypes of its tensors and arrays) and then runs it; the
tensors and arrays themselves (mel rows, audio) follow as broadcasts from
the leader over the job's default group (NCCL on the cards), bit for
bit.  The other ranks replay the commands in the
same order in :meth:`Lockstep.follow` on handlers of the same names.  One
lock orders the leader's calls, so that two of its threads (a scheduler's
step loop and its fallback thread) never issue collectives in an order
the followers do not see.

Commands travel through a key-value store that the leader hosts
(``torch.distributed.TCPStore``, whose values stay well under its 8 MiB
limit), not through a collective: the leader never waits for a follower
to be ready, and an idle follower waits with no collective timeout
running.

An error that a request's own arguments cause (:data:`REQUEST_ERRORS`:
an unknown language, an option out of range) is raised by every rank at
the same point of the same command, since every rank runs it on the same
inputs; each rank records it and carries on, and the leader's caller sees
it as one process's would.  Any other failure ends the stream:

* a follower whose handler raises writes the error to the store and ends
  its loop, raising; the leader's collective of that call then fails (the
  peer is gone) or times out (the process group's timeout), and the
  leader's next call sees the follower's error;
* a leader call that raises closes the stream: every later call raises
  the first error, so a scheduler's worker ends and refuses later
  submissions instead of carrying on with a missing rank.

In a single process ``call`` just runs the handler: no store, no lock.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import pickle
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import host_group, rank, world_size

logger = logging.getLogger(__name__)

# errors that a command's arguments cause alike on every rank: recorded,
# and the stream goes on (a communication failure is a RuntimeError)
REQUEST_ERRORS = (ValueError,)

# how long a follower waits on the store before it waits again (an idle
# server; each wait that times out logs a line of c10d's); a command ends
# the wait at once, and so does a lost leader
_POLL = datetime.timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class _Ref:
    """Where a packed command had an array: its shape and dtype, and
    whether it was a host numpy array (audio) or a tensor."""
    shape: Tuple[int, ...]
    dtype: str
    numpy: bool


def _pack(obj: Any, arrays: List[torch.Tensor]) -> Any:
    """``obj`` (picklable) with each tensor and numpy array replaced by a
    :class:`_Ref` and appended to ``arrays`` as a tensor, in order."""
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(obj))
        arrays.append(t)
        return _Ref(tuple(t.shape), str(t.dtype).split(".")[-1], True)
    if isinstance(obj, torch.Tensor):
        arrays.append(obj)
        return _Ref(tuple(obj.shape), str(obj.dtype).split(".")[-1], False)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(x, arrays) for x in obj)
    if isinstance(obj, dict):
        return {k: _pack(v, arrays) for k, v in obj.items()}
    return obj


def _unpack(obj: Any, arrays: Iterator[torch.Tensor]) -> Any:
    """The inverse of :func:`_pack`, the arrays taken from ``arrays``
    (numpy ones brought back to the host)."""
    if isinstance(obj, _Ref):
        t = next(arrays)
        return t.cpu().numpy() if obj.numpy else t
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(x, arrays) for x in obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, arrays) for k, v in obj.items()}
    return obj


def _refs(obj: Any) -> List[_Ref]:
    """The :class:`_Ref` of a packed ``obj``, in order."""
    if isinstance(obj, _Ref):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [s for x in obj for s in _refs(x)]
    if isinstance(obj, dict):
        return [s for v in obj.values() for s in _refs(v)]
    return []


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view (what a
    broadcast carries: every dtype, bit for bit, on gloo and NCCL)."""
    return t.view(-1).view(torch.uint8)


class Lockstep:
    """One command stream over the job's ranks.

    ``handlers`` maps a command's name to the function that runs it, the
    same on every rank; ``device`` is where a follower puts the tensors of
    a command; ``mesh`` None (or one rank) makes every call local.  Every
    rank constructs it at the same point: the leader's store address
    reaches the followers over the host group."""

    def __init__(self, handlers: Dict[str, Callable], device="cpu",
                 mesh=None):
        self.handlers = dict(handlers)
        self.device = device
        self.distributed = mesh is not None and world_size() > 1
        self.leader = rank() == 0
        self._lock = threading.Lock()
        self._n = 0
        self._closed: Optional[str] = None
        self._store = None
        if not self.distributed:
            return
        host = os.environ.get("MASTER_ADDR", "127.0.0.1")
        timeout = datetime.timedelta(seconds=300)
        addr = [None]
        if self.leader:
            self._store = dist.TCPStore(host, 0, world_size(), is_master=True,
                                        wait_for_workers=False,
                                        timeout=timeout)
            addr = [self._store.port]
        dist.broadcast_object_list(addr, src=0, group=host_group())
        if not self.leader:
            self._store = dist.TCPStore(host, addr[0], world_size(),
                                        is_master=False, timeout=timeout)

    @property
    def closed(self) -> Optional[str]:
        """The error that closed the stream, or None."""
        return self._closed

    # -- the leader -------------------------------------------------------
    def _publish(self, name: str, args, kwargs) -> None:
        failed = self._store.check(["failed"]) and \
            self._store.get("failed").decode()
        if failed:
            raise RuntimeError(f"a follower failed: {failed}")
        tensors: List[torch.Tensor] = []
        cmd = (name, _pack(args, tensors), _pack(kwargs, tensors))
        self._store.set(f"cmd{self._n}", pickle.dumps(
            cmd, protocol=pickle.HIGHEST_PROTOCOL))
        self._n += 1
        for t in tensors:
            if t.numel():
                dist.broadcast(as_bytes(t.detach().to(self.device)
                                        .contiguous()), src=0)

    def call(self, name: str, *args, run: Optional[Callable] = None,
             **kwargs) -> Any:
        """Run command ``name`` on every rank: published, then run here
        (``run()`` in place of the handler, when the leader's own call
        differs from the followers' replay, e.g. it fills the requests'
        results).  Raises a request's error (the stream goes on) or the
        error that closed the stream."""
        fn = run or (lambda: self.handlers[name](*args, **kwargs))
        if not self.distributed:
            return fn()
        with self._lock:
            if self._closed is not None:
                raise RuntimeError(f"the mesh's command stream is closed: "
                                   f"{self._closed}")
            try:
                self._publish(name, args, kwargs)
                return fn()
            except REQUEST_ERRORS:
                raise
            except BaseException as e:
                self._closed = f"{type(e).__name__}: {e}"
                self._release()
                raise

    def _release(self) -> None:
        """Tell the followers to stop after a failed call (best effort: a
        follower stuck in that call's collective ends at the process
        group's timeout instead)."""
        try:
            self._store.set(f"cmd{self._n}", pickle.dumps(("stop", (), {})))
        except Exception:   # noqa: BLE001 — the store may be gone too
            pass

    def stop(self) -> None:
        """End the followers' loops (the leader; idempotent)."""
        if self.distributed and self.leader:
            with self._lock:
                if self._closed is None:
                    self._publish("stop", (), {})
                    self._closed = "stopped"

    # -- the followers ----------------------------------------------------
    def _next(self):
        key = f"cmd{self._n}"
        while True:
            try:
                self._store.wait([key], _POLL)
                break
            except dist.DistStoreError:
                continue            # idle: no command yet
        name, args, kwargs = pickle.loads(self._store.get(key))
        if self._store.add(f"ack{self._n}", 1) == world_size() - 1:
            self._store.delete_key(key)
            self._store.delete_key(f"ack{self._n}")
        self._n += 1
        tensors = [torch.empty(ref.shape, dtype=getattr(torch, ref.dtype),
                               device=self.device)
                   for ref in _refs((args, kwargs))]
        for t in tensors:
            if t.numel():
                dist.broadcast(as_bytes(t), src=0)
        it = iter(tensors)
        return name, _unpack(args, it), _unpack(kwargs, it)

    def follow(self) -> None:
        """Replay the leader's commands until it stops (a follower).  A
        handler that raises a request's error goes on to the next command,
        as the leader does; any other error is written to the store and
        ends the loop, raising."""
        while True:
            name, args, kwargs = self._next()
            if name == "stop":
                return
            try:
                self.handlers[name](*args, **kwargs)
            except REQUEST_ERRORS as e:
                logger.warning("command %s failed alike on every rank: %s: "
                               "%s", name, type(e).__name__, e)
            except BaseException as e:
                self._store.set("failed", f"rank {rank()}: "
                                f"{type(e).__name__}: {e}")
                raise
