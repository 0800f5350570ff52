"""The mesh's process groups, by axis and degree, and one recorder of the
collectives that the sharded model issues over them.

``make_mesh`` registers this rank's group of each axis larger than 1
under ``(axis, size)``; the model finds a tree's degree on an axis from
its shapes (``tensor_parallel.degree``, ``fsdp.degree``) and takes the
group with :func:`group_for`.  The world size fixes the other axis, so a
job has at most one mesh a degree.

:func:`timed` opens a :class:`Record` of the block's collectives: the
model group's all-reduces (``tensor_parallel``) and the data group's
all-gathers and reduce-scatters (``fsdp``), counted by kind, with the
bytes a rank receives, the host's time inside the calls (all of a gloo
collective, which returns when it is done; an NCCL call only enqueues)
and, on the card, their device time between CUDA events.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, List, Tuple

import torch

# (axis, size) -> this rank's group on that axis, one per mesh made
_GROUPS: Dict[Tuple[str, int], Any] = {}
# the open timed() records, innermost last
_RECORD: List["Record"] = []


def register(axis: str, n: int, group) -> None:
    """Make ``group`` this rank's ``axis`` group of ``n`` ranks."""
    _GROUPS[(axis, n)] = group


def group_for(axis: str, n: int):
    """This rank's ``axis`` group of ``n`` ranks (None at 1)."""
    if n == 1:
        return None
    if (axis, n) not in _GROUPS:
        raise ValueError(f"parameters sharded {n} ways over {axis!r}, but no "
                         f"mesh with a {axis!r} axis of {n} was made in this "
                         "process (parallel.make_mesh)")
    return _GROUPS[(axis, n)]


class Record:
    """The collectives issued while a :func:`timed` block is open:
    ``counts[kind]``, ``bytes[kind]`` (what a rank receives: ``(n - 1)``
    shards for a gather or a scatter; ``2 (n - 1) / n`` of the tensor for
    an all-reduce, as a ring moves it), ``host_ms`` and :meth:`ms`."""

    def __init__(self):
        self.counts: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self.host_ms = 0.0
        self.events: List[Any] = []

    def ms(self) -> float:
        """Device time of the recorded collectives (0 off the card)."""
        if not self.events:
            return 0.0
        self.events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


@contextlib.contextmanager
def timed():
    """``with timed() as rec:`` records the block's collectives."""
    rec = Record()
    _RECORD.append(rec)
    try:
        yield rec
    finally:
        _RECORD.remove(rec)


@contextlib.contextmanager
def recorded(t: torch.Tensor, kind: str, nbytes: int):
    """Around one collective of ``kind`` on ``t`` (the innermost open
    record counts it)."""
    rec = _RECORD[-1] if _RECORD else None
    if rec is not None and t.is_cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    yield
    if rec is not None:
        rec.host_ms += (time.perf_counter() - t0) * 1e3
        rec.counts[kind] += 1
        rec.bytes[kind] += int(nbytes)
        if t.is_cuda:
            end.record()
            rec.events.append((start, end))
