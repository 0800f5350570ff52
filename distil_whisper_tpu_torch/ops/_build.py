"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library with a plain C interface, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``_build/`` beside the
package (git-ignored), named by the hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and an
unchanged one is reused.  A library is written
to a temporary name and renamed into place, so concurrent processes never load
a half-written file.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds one source if needed and returns its library.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("mel", "encoder_attention", "encoder_attention_bwd", "int8_mlp",
           "int8_decode_attention", "mesh_collective")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the kernel wrappers whose launches are counted (count_launch), by id
_counted: Dict[int, object] = {}
# a thread capturing a CUDA graph records its launches here
_local = threading.local()
# ptxas resource report (registers, shared memory, spills) of each build
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """``nvcc`` from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    candidates = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in candidates:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "distil_whisper_tpu_torch need the CUDA toolkit "
                           "(set CUDA_HOME)")
    return found


def _lib_path(name: str, src_dir: Path = SRC_DIR) -> Path:
    """The library of ``<src_dir>/<name>.cu``, named by the hash of the
    source, every header beside it (``*.cuh``) and the flags."""
    digest = hashlib.sha256()
    for path in [src_dir / f"{name}.cu", *sorted(src_dir.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple:
    """Start nvcc for one source, or return None when it is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every kernel source that is not built yet, all in parallel."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:   # finish the others before raising
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            _finish(name, _start(name))
            lib = _libs.get(name) or ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` count.  The serving
    threads launch kernels concurrently, and ``+=`` on an attribute is not
    atomic.  While this thread captures a CUDA graph
    (:func:`recording_launches`) the launch is recorded for the graph's
    replays instead: a capture launches nothing."""
    with _count_lock:
        _counted[id(wrapper)] = wrapper
        rec = getattr(_local, "recording", None)
        if rec is None:
            wrapper.launches += 1
        else:
            rec[id(wrapper)] = rec.get(id(wrapper), 0) + 1


@contextlib.contextmanager
def recording_launches():
    """Within it, this thread's kernel launches are recorded in the
    yielded dict (wrapper id -> launches), not counted: what a CUDA graph
    captured here launches at each replay (``generation/graphs.py``).
    Other threads count as usual."""
    rec: Dict[int, int] = {}
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = None


def add_launches(delta: Dict[int, int]) -> None:
    """Add ``delta`` (wrapper id -> launches) to the wrappers' counts."""
    with _count_lock:
        for i, n in delta.items():
            _counted[i].launches += n
