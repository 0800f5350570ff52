"""Step timing and metrics logging.

The port of ``distil_whisper_tpu.utils.profiling``'s ``StepTimer`` and
metrics sinks.  ``StepTimer`` times on the card with CUDA events recorded
on the current stream (device time between the two events, read when the
end event has completed) and on the CPU with the host clock.  The JAX
package's ``trace`` and ``block`` are TPU tools and have no counterpart
here; a device trace comes from ``torch.profiler`` (the training CLIs'
``--profile_steps``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


class StepTimer:
    """Times steps: ``with timer: step()``, then ``times``.

    On the card each step is a pair of CUDA events and leaving the block
    does not wait: ``times`` reads them (waiting for the last event).  On
    the CPU the host clock around the step."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._pending: List[Any] = []
        self._times: List[float] = []
        self._t0: Any = None

    def __enter__(self) -> "StepTimer":
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._t0, end))
        else:
            self._times.append(time.perf_counter() - self._t0)
        return False

    @property
    def times(self) -> List[float]:
        """Seconds of every finished step, in order."""
        for start, end in self._pending:
            end.synchronize()
            self._times.append(start.elapsed_time(end) / 1e3)
        self._pending = []
        return list(self._times)


def device_time_ms(prof) -> float:
    """Summed self device time (ms) of the CUDA events of a finished
    ``torch.profiler.profile``: the device's busy time in its window when
    one stream does the work.  ``record_function`` ranges are left out:
    on the device timeline they span the kernels they hold, which are
    counted already."""
    total = 0.0
    for e in prof.key_averages():
        if (e.device_type.name == "CUDA"
                and not getattr(e, "is_user_annotation", False)):
            total += float(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0)))
    return total / 1e3


class JsonlSink:
    """Append-only JSONL scalar sink, the default that needs no network."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": step, "time": time.time()}
        row.update(metrics)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutSink:
    """One line of the metrics a step, through the package's logger."""

    def __init__(self):
        self._log = logging.getLogger("distil_whisper_tpu_torch")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        self._log.info("step %d: %s", step, json.dumps(metrics))

    def close(self) -> None:
        pass


class TensorBoardSink:
    """TensorBoard event files via torch.utils.tensorboard; raises
    ImportError when tensorboard is not installed."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(log_dir=log_dir)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._w.add_scalar(k, v, step)

    def close(self) -> None:
        self._w.close()


class WandbSink:
    """W&B scalars; needs the wandb package and WANDB_PROJECT, else
    ImportError."""

    def __init__(self, run_name: Optional[str] = None):
        import wandb
        project = os.environ.get("WANDB_PROJECT")
        if not project:
            raise ImportError("WANDB_PROJECT not set")
        self._run = wandb.init(project=project, name=run_name, reinit=True)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        self._run.log(dict(metrics), step=step)

    def close(self) -> None:
        self._run.finish()


class MetricsLogger:
    """Writes each metrics row to every sink of ``report_to``: ``jsonl``
    (the file ``path``), ``stdout``, ``tensorboard`` and ``wandb`` where
    they can be imported (an unavailable sink is skipped with a warning,
    never an error).  Values are converted to floats where they can be
    (a 0-dim tensor waits for the device here).  Data parallel: only rank
    0 writes; every rank logs the same global values, and appends from
    several processes to one file would interleave."""

    def __init__(self, path: str, report_to: tuple = ("jsonl",),
                 tensorboard_dir: Optional[str] = None,
                 run_name: Optional[str] = None):
        from ..parallel.multihost import rank
        self.sinks: List[Any] = []
        if rank() != 0:
            return
        for kind in report_to:
            try:
                if kind == "jsonl":
                    self.sinks.append(JsonlSink(path))
                elif kind == "stdout":
                    self.sinks.append(StdoutSink())
                elif kind == "tensorboard":
                    self.sinks.append(TensorBoardSink(
                        tensorboard_dir or str(Path(path).parent / "tb")))
                elif kind == "wandb":
                    self.sinks.append(WandbSink(run_name))
                elif kind in ("none", ""):
                    pass
                else:
                    raise ValueError(f"unknown metrics sink '{kind}'")
            except ImportError as e:
                logging.getLogger("distil_whisper_tpu_torch").warning(
                    "metrics sink '%s' unavailable (%s): skipping", kind, e)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if not self.sinks:
            return
        row: Dict[str, Any] = {}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        for s in self.sinks:
            s.log(step, row)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
