"""Convert a training checkpoint of the port to an HF-format model directory.

The port of ``distil_whisper_tpu.cli.convert_checkpoint_to_hf``.  The
port's checkpoints are the ``torch.save`` files of
``training/checkpoint.py`` (``checkpoint-{step}/state.pt``), not Orbax
states: this reads the parameters of one checkpoint dir, or of the newest
one under a run's output dir, checks them against the architecture of
``--base_checkpoint`` (the student init), and writes ``config.json``, an
fp32 ``model.safetensors`` and the tokenizer files.  Runs on the GPU unless
``--device cpu``.  ``--distributed`` (under ``torchrun``, after a data-
parallel run): every rank restores the checkpoint, rank 0 writes the
export while the others wait at a barrier (JAX lets every host write the
same files).

    python -m distil_whisper_tpu_torch.cli.convert_checkpoint_to_hf \\
        --checkpoint_dir ./run/checkpoint-80000 \\
        --base_checkpoint ./distil-init --save_dir ./distil-final
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..device import resolve_device
from ..models import load_params, save_pretrained
from ..models.params import to_fp32, tree_paths, unflatten_paths
from ..training.checkpoint import STATE_FILE, CheckpointManager
from ..parallel.multihost import barrier, rank
from .common import (copy_tokenizer_files, logger, setup_data_parallel,
                     setup_logging)


def checkpoint_params(path: Path, template, device):
    """``(step name, param tree)`` of the checkpoint at ``path`` (a
    ``checkpoint-{step}`` dir, or an output dir: its newest one), on
    ``device``, checked leaf for leaf against ``template``'s paths and
    shapes."""
    if not (path / STATE_FILE).exists():
        latest = CheckpointManager(str(path)).latest()
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = Path(latest[1])
    sd = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
    want = {p: tuple(x.shape) for p, x in tree_paths(template).items()}
    got = {p: tuple(x.shape) for p, x in sd["params"].items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"checkpoint {path} does not fit the base "
                         f"checkpoint's architecture: {diff[:8]}")
    return path.name, unflatten_paths(sd["params"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True,
                   help="a checkpoint-{step} dir or its parent output dir")
    p.add_argument("--base_checkpoint", required=True,
                   help="HF dir defining the architecture (student init)")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--distributed", action="store_true",
                   help="join the torchrun job first (each rank restores, "
                        "rank 0 writes); fails fast unless the job has "
                        "several ranks")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)
    setup_logging()
    setup_data_parallel(args.distributed, args.device)
    device = resolve_device(args.device)
    base, cfg = load_params(args.base_checkpoint, device=device)
    step, params = checkpoint_params(Path(args.checkpoint_dir), base, device)
    if rank() == 0:
        save_pretrained(to_fp32(params), cfg, args.save_dir)
        copy_tokenizer_files(args.base_checkpoint, args.save_dir)
        logger.info("checkpoint %s exported to %s", step, args.save_dir)
    barrier()
    return args.save_dir


if __name__ == "__main__":
    main()
