"""Shared set-up for the PyTorch port's tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU: the same inputs, made
from a seed with numpy, and the same parameters, converted leaf for leaf
with ``params_from_numpy``, go through both.  Six xdist workers share the
machine's cores, so torch gets two threads; TF32 stays off.  No test
uses TensorFlow, so ``transformers`` (imported by the tiny-checkpoint
helper) is told not to import it, which saves about 8 s of its import.
"""

import json
import os

os.environ.setdefault("USE_TF", "0")

import jax
import numpy as np
import torch

from distil_whisper_tpu_torch.models import params_from_numpy

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def to_numpy_tree(tree):
    """A JAX param tree as a nested dict of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def jax_init_params(cfg, seed: int):
    """The JAX package's random init under one ``jax.jit``: one compile in
    place of one per eager op (the test modules clear JAX's caches)."""
    from distil_whisper_tpu.models import init_params
    return jax.jit(init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed))


def torch_params(jax_tree, dtype=torch.float32):
    """The port's CPU copy of a JAX param tree."""
    return params_from_numpy(to_numpy_tree(jax_tree), "cpu", dtype)


def np_tree_equal(a, b):
    """Leaf-for-leaf equality of two nested dicts (numpy or tensors)."""
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        for k in a:
            np_tree_equal(a[k], b[k])
        return
    an = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    bn = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert an.shape == bn.shape and an.dtype == bn.dtype, (an.shape, bn.shape)
    np.testing.assert_array_equal(an, bn)


def tone(seconds, freq, seed):
    """A tone under a little noise, fp32 at 16 kHz (the serving tests'
    synthetic clip, as tests/test_serving*.py make it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def serving_cases(n=8):
    """Mixed traffic: languages en/fr, segment timestamps on every third
    clip, budgets 10/7/5 (tests/test_serving_engine.py's staggered set)."""
    return [dict(wav=tone(1.0 + 0.3 * (i % 3), 200.0 + 35 * i, seed=i),
                 language=["en", "fr"][i % 2],
                 return_timestamps=(i % 3 == 0),
                 max_new_tokens=[10, 7, 5][i % 3]) for i in range(n)]


def computed_once(tmp_path_factory, key: bytes, compute):
    """``compute()`` once for the whole pytest run, over every xdist
    worker: the first caller computes it under a file lock and pickles it
    into the run's shared temporary directory, named by the hash of
    ``key`` (the bytes of every input the result depends on); later
    callers, in any module or worker, load it.  For JAX references that
    several modules compute on the same inputs."""
    import fcntl
    import hashlib
    import os
    import pickle
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent            # the run's, shared by its workers
    path = base / f"shared-{hashlib.sha256(key).hexdigest()[:32]}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        value = compute()
        path.write_bytes(pickle.dumps(value))
    return value


def serving_goldens(tmp_path_factory, ck, cases, jpipe):
    """The JAX pipeline ``jpipe`` (the tiny checkpoint ``ck``, float32,
    batch 2, budget 10) on the serving cases: the goldens that the
    schedulers are held against in tests/test_torch_serving.py,
    tests/test_torch_serving_engine.py and tests/test_torch_mesh_serving.py,
    computed once per pytest run (:func:`computed_once`), keyed by the
    checkpoint's bytes and the cases."""
    from pathlib import Path
    parts = [b"serving-goldens float32 batch 2 budget 10"]
    for f in sorted(Path(ck).iterdir()):
        parts += [f.name.encode(), f.read_bytes()]
    for c in cases:
        parts += [c["wav"].tobytes(), repr((c["language"],
                  c["return_timestamps"], c["max_new_tokens"])).encode()]
    return computed_once(tmp_path_factory, b"\0".join(parts), lambda: [
        jpipe(c["wav"], language=c["language"],
              return_timestamps=c["return_timestamps"],
              max_new_tokens=c["max_new_tokens"]) for c in cases])


class ChildCall:
    """``<module>.<function>(*args)`` in a child Python process, started
    at once; :meth:`result` waits for it and returns its value.  Arguments
    and value travel as JSON (a ``Path`` in the value comes back as a
    string).  The child imports ``conftest`` first, so JAX sees the tests'
    eight virtual CPU devices there too.  For the port's side of a fixture
    that runs both packages on the same inputs: it runs while the JAX side
    runs here."""

    _CODE = ("import importlib, json, sys\n"
             "import conftest  # noqa: F401\n"
             "fn = getattr(importlib.import_module(sys.argv[1]), sys.argv[2])\n"
             "value = fn(*json.loads(sys.argv[3]))\n"
             "open(sys.argv[4], 'w').write(json.dumps(value, default=str))\n")

    def __init__(self, module: str, function: str, *args):
        import subprocess
        import sys
        import tempfile
        from pathlib import Path
        here = Path(__file__).resolve().parent
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(here.parent), str(here), os.environ.get("PYTHONPATH", "")])}
        fd, self._out = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self._log = tempfile.TemporaryFile("w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", self._CODE, module, function,
             json.dumps(args, default=str), self._out],
            env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def result(self, timeout: float = 900):
        try:
            self._proc.wait(timeout=timeout)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
        with self._log:
            self._log.seek(0)
            log = self._log.read()
        try:
            assert self._proc.returncode == 0, log[-4000:]
            with open(self._out) as f:
                return json.load(f)
        finally:
            os.unlink(self._out)


def submit_all(tr, cases, stagger=0.05, timeout=600):
    """Submit each case from its own thread, arrivals staggered by
    ``stagger * (i % 4)`` seconds; returns the results in order and
    raises the first error."""
    import threading
    import time
    results, errors = [None] * len(cases), []

    def post(i, c):
        kw = {k: v for k, v in c.items() if k != "wav"}
        try:
            results[i] = tr.submit(c["wav"], timeout=timeout, **kw)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, e))

    threads = []
    for i, c in enumerate(cases):
        th = threading.Thread(target=post, args=(i, c))
        th.start()
        threads.append(th)
        time.sleep(stagger * (i % 4))
    for th in threads:
        th.join(timeout=timeout)
        assert not th.is_alive(), "a request did not finish"
    if errors:
        raise errors[0][1]
    return results
