"""CUDA graphs of the decode loops: the port's counterpart of JAX's jit
cache.

The JAX package compiles each decode loop into one device program
(``build_generate`` and its ``lax.while_loop``, the serving engine's jitted
step blocks).  The port captures the same loops as CUDA graphs over the
static shapes they already have.  A :class:`GraphOwner` holds what one user
of graphs needs:

* a private memory pool, shared by the owner's graphs, so that a graph's
  temporaries are its own and two owners replaying at once on two threads
  never share memory;
* a side stream, on which the owner warms up, captures and replays (the
  caller's stream waits for it after a replay, and it waits for the
  caller's stream before one);
* a lock: an owner's programs share memory, so one call at a time replays;
* a cache of captured programs keyed like JAX's jit cache (the callers'
  keys hold batch, prompt length, budget, the frozen options, dtype,
  device, the int8 flags and greedy or sampling), least recently used
  entries dropped past :data:`MAX_PROGRAMS`.

Each program holds its weights, its static inputs and its state alive, so
an owner lives exactly as long as what it decodes for: a pipeline, a
transcriber, an engine, a ``build_generate`` callable, or one ``generate``
call that was given no owner.  There is no process-wide cache.

A capture records with ``capture_error_mode="thread_local"``: the serving
threads go on launching while one of them captures.  A sharded tree's
collectives are captured too: they run on the groups' device comms
(``parallel/device_comm.py``), whose workspaces keep their addresses, so
every rank of a group warms up, captures and replays the same programs in
the same order, as it calls the decode.  The caller warms the
body up first on :meth:`GraphOwner.side` (lazily built host tables, library
handles and workspaces then exist before the capture).  Nothing here runs
for CPU tensors: there the callers run the same body eagerly, and that is
the plain version.

A kernel wrapper captured into a graph launches at every replay, not at
the capture: the capturing thread's launches are recorded
(``ops/_build.recording_launches``) and each :meth:`Graph.replay` adds
them to the wrappers' counts, so the counts stay launches (other threads
count their own as usual).

:data:`STATS` counts captures, replays, capture seconds and the host syncs
of the blocked decode loops (their one read of the device a block);
:func:`pool_bytes` reads the bytes of an owner's pool.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from ..ops import _build

_stats_lock = threading.Lock()
STATS: Dict[str, float] = {"captures": 0, "replays": 0, "capture_s": 0.0,
                           "host_syncs": 0}


# Programs an owner keeps.  Counted on an H100 by
# scripts/torch_graph_cache_traffic.py: the micro-batch scheduler's mixed
# traffic (greedy, sampled, segment and word timestamps at 1-16 rows) made 5
# programs, 1.09 GB of pool between them; the same traffic speculating with
# large-v3 and its distil draft made 5 (2 speculative), 9.16 GB;
# pseudo-labelling, whose short batches are padded to the full one, makes 1.
MAX_PROGRAMS = 8


def bump(name: str, n: float = 1) -> None:
    with _stats_lock:
        STATS[name] += n


def read_stats() -> Dict[str, float]:
    with _stats_lock:
        return dict(STATS)


class Graph:
    """One captured CUDA graph and the kernel launches its capture
    recorded."""

    def __init__(self, graph: "torch.cuda.CUDAGraph",
                 launches: Dict[int, int]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        if self.launches:
            _build.add_launches(self.launches)
        bump("replays")


class GraphOwner:
    """A private pool, a side stream, a lock and a cache of captured
    programs (see the module's docstring).  Cheap to build on the CPU: the
    pool and the stream are made at the first capture."""

    def __init__(self, name: str):
        self.name = name
        self.built = 0          # programs captured, evicted ones included
        self.evicted = 0        # programs dropped past MAX_PROGRAMS
        self.lock = threading.RLock()
        self.entries: "OrderedDict[Any, Any]" = OrderedDict()
        self.pool: Optional[Tuple[int, int]] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.device: Optional[torch.device] = None

    def _bind(self, device: torch.device) -> None:
        if self.device is None:
            self.device = device
            with torch.cuda.device(device):
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(device)
        elif device != self.device:
            raise ValueError(f"graph owner {self.name!r} lives on "
                             f"{self.device}, not on {device}")

    def entry(self, key, build: Callable[[], Any]) -> Any:
        """The program cached under ``key``, captured by ``build()`` on a
        miss.  The caller holds :attr:`lock` while it uses the program."""
        with self.lock:
            hit = self.entries.pop(key, None)
            if hit is None:
                hit = build()
                self.built += 1
            self.entries[key] = hit
            while len(self.entries) > MAX_PROGRAMS:
                self.entries.popitem(last=False)
                self.evicted += 1
            return hit

    def report(self) -> Dict[str, Any]:
        """Programs kept, built and evicted, and the pool's bytes."""
        with self.lock:
            return {"programs": len(self.entries), "built": self.built,
                    "evicted": self.evicted, "pool_bytes": pool_bytes(self)}

    @contextlib.contextmanager
    def side(self, device: torch.device):
        """Run on the owner's stream, ordered after the caller's work so
        far; the caller's stream waits for it afterwards."""
        self._bind(device)
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.device(device), torch.cuda.stream(self.stream):
                yield self.stream
        finally:
            caller.wait_stream(self.stream)

    def capture(self, fn: Callable[[], Any], device: torch.device,
                generators: Iterable[torch.Generator] = ()
                ) -> Tuple[Graph, Any]:
        """Capture ``fn()`` (warmed up by the caller) into a graph on the
        owner's pool; returns the graph and ``fn``'s result, whose tensors
        the graph rewrites at each replay.  ``generators`` (CUDA generators
        ``fn`` draws from) are registered with the graph, so that each
        replay draws further along their streams.  A failed capture
        raises."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # a capture allocates from the owner's pool alone, and while one is
        # under way the allocator hands no cached block back to the device:
        # free the cache first, or the pool cannot grow where the cache
        # holds the memory (a device comm's workspace is no block of the
        # allocator's: it keeps its address)
        torch.cuda.empty_cache()
        with self.side(device), _build.recording_launches() as launches:
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        bump("captures")
        bump("capture_s", time.perf_counter() - t0)
        return Graph(graph, launches), out


def static_like(values: Dict[str, Any]) -> Dict[str, Any]:
    """A program's static inputs: buffers shaped like one call's inputs
    (each a tensor, a dict of tensors or None), which every call copies
    its own into (:func:`load`): a graph reads its inputs where they were
    at capture."""
    def like(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: torch.empty_like(v) for k, v in x.items()}
        return torch.empty_like(x)
    return {k: like(v) for k, v in values.items()}


def load(inputs: Dict[str, Any], values: Dict[str, Any]) -> None:
    """Copy one call's inputs into a program's static inputs."""
    for k, v in values.items():
        if isinstance(v, dict):
            for n, t in v.items():
                inputs[k][n].copy_(t)
        elif v is not None:
            inputs[k].copy_(v)


def pool_bytes(owner: GraphOwner) -> Optional[int]:
    """Bytes of the segments of ``owner``'s private pool (None before its
    first capture, or where the allocator's snapshot names no pools)."""
    if owner.pool is None:
        return None
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments
               if tuple(s["segment_pool_id"]) == tuple(owner.pool))


def params_key(tree) -> Tuple[int, ...]:
    """The addresses of a parameter tree's tensors: a graph reads its
    weights where they were at capture, so another tree is another
    program."""
    if isinstance(tree, dict):
        return tuple(p for k in sorted(tree) for p in params_key(tree[k]))
    if isinstance(tree, torch.Tensor):
        return (tree.data_ptr(),)
    return ()
