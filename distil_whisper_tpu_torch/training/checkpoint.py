"""Checkpoint save / rotate / resume and best-by-WER tracking, without
Orbax.

The port of ``distil_whisper_tpu.training.checkpoint`` with the same
directory names (``checkpoint-{step}``, and ``checkpoint-{step}-val-wer-
{wer:.3f}`` for the best checkpoints), the same rotation
(``save_total_limit`` newest step checkpoints, ``best_total_limit`` lowest-
WER ones) and the same ``meta.json``.  A checkpoint holds ``state.pt``: the
train state's tensors (params, AdamW moments, the accumulated gradient) and
counters, written with ``torch.save``.  ``restore`` copies them into a
template state of the same layout, dtype for dtype, so a resumed run
continues bit for bit.

Data parallel: the replicas are bit-identical, so rank 0 alone writes,
clears and rotates, and every rank waits at a barrier until the checkpoint
is complete (a shared filesystem sees one writer); every rank restores the
same file.  Tensor parallel: every rank gathers the state's shards first
(a collective), so the file holds the unsharded state, as an Orbax
checkpoint is topology-free; ``restore`` slices it onto whatever mesh the
template state was placed on (a run saved at tp 2 resumes at tp 1 or at
dp 2).
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from ..parallel.multihost import barrier, rank
from .state import TrainState

CKPT_PATTERN = re.compile(r"^checkpoint-(\d+)$")
BEST_PATTERN = re.compile(r"^checkpoint-(\d+)-val-wer-([\d.]+)$")
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, output_dir: str, save_total_limit: Optional[int] = None,
                 best_total_limit: int = 1):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_total_limit = save_total_limit
        self.best_total_limit = best_total_limit

    @staticmethod
    def _write(path: Path, sd: dict) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(sd, tmp)
        tmp.rename(path / STATE_FILE)

    def save(self, step: int, state: TrainState,
             metadata: Optional[dict] = None) -> str:
        path = self.dir / f"checkpoint-{step}"
        sd = state.state_dict()           # every rank: gathers the shards
        if rank() == 0:
            self._write(path, sd)
            if metadata is not None:
                with open(path / "meta.json", "w") as f:
                    json.dump({"step": step, **metadata}, f)
            self._rotate()
        barrier()
        return str(path)

    def save_best(self, step: int, state: TrainState, val_wer: float) -> str:
        path = self.dir / f"checkpoint-{step}-val-wer-{val_wer:.3f}"
        sd = state.state_dict()
        if rank() == 0:
            self._write(path, sd)
            self._rotate_best()
        barrier()
        return str(path)

    # ------------------------------------------------------------------
    def all_checkpoints(self) -> List[Tuple[int, Path]]:
        out = []
        for p in self.dir.iterdir():
            m = CKPT_PATTERN.match(p.name)
            if m and p.is_dir():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def best_checkpoints(self) -> List[Tuple[float, int, Path]]:
        out = []
        for p in self.dir.iterdir():
            m = BEST_PATTERN.match(p.name)
            if m and p.is_dir():
                out.append((float(m.group(2)), int(m.group(1)), p))
        return sorted(out)  # ascending WER: best first

    def latest(self) -> Optional[Tuple[int, str]]:
        ckpts = self.all_checkpoints()
        if not ckpts:
            return None
        step, path = ckpts[-1]
        return step, str(path)

    # ------------------------------------------------------------------
    def restore(self, path: str, template_state: TrainState) -> TrainState:
        """Load a checkpoint into ``template_state`` (in place)."""
        sd = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                        weights_only=True)
        return template_state.load_state_dict(sd)

    def resume_latest(self, template_state: TrainState
                      ) -> Optional[Tuple[int, TrainState]]:
        latest = self.latest()
        if latest is None:
            return None
        step, path = latest
        return step, self.restore(path, template_state)

    # ------------------------------------------------------------------
    def _rotate(self):
        if self.save_total_limit is None:
            return
        ckpts = self.all_checkpoints()
        for _, path in ckpts[:max(0, len(ckpts) - self.save_total_limit)]:
            shutil.rmtree(path, ignore_errors=True)

    def _rotate_best(self):
        best = self.best_checkpoints()
        for _, _, path in best[self.best_total_limit:]:
            shutil.rmtree(path, ignore_errors=True)
