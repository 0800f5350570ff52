"""Shared CLI helpers of the port's eval drivers: dataset loading, logging,
batching, noise mixing, JSON-file arguments.

The port's own copy of what ``distil_whisper_tpu.cli.common`` gives
``run_eval``.  A JSONL manifest is read with the standard library, so an
eval needs no ``datasets`` package; ``datasets`` is imported only for a
``save_to_disk`` directory or an ``.arrow`` file.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

logger = logging.getLogger("distil_whisper_tpu_torch")


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        stream=sys.stdout,
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")


def load_dataset_any(path: str, split: Optional[str] = None):
    """Rows of a dataset on local disk, each a dict with ``audio`` (a WAV
    path, or ``{"array": ..., "sampling_rate": ...}``) and ``text``.

    Accepts a JSONL manifest (one JSON object a line; read with the standard
    library), or a ``datasets`` save_to_disk directory (Dataset or
    DatasetDict, ``split`` picks one) or ``.arrow`` file.
    """
    p = Path(path)
    if p.suffix in (".jsonl", ".json") and p.is_file():
        with open(p) as f:
            return [json.loads(line) for line in f if line.strip()]
    if p.is_dir():
        import datasets
        ds = datasets.load_from_disk(str(p))
        if split is not None and hasattr(ds, "keys") and split in ds:
            ds = ds[split]
        return ds
    if p.suffix == ".arrow":
        import datasets
        return datasets.Dataset.from_file(str(p))  # memory-mapped
    raise FileNotFoundError(f"cannot interpret dataset path {path}")


def batched(iterable: Iterable, n: int) -> Iterable[List]:
    buf: List[Any] = []
    for x in iterable:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def parse_args_with_json(parser, argv=None):
    """HfArgumentParser-style single-JSON-file parsing: when the only
    argument is a ``.json`` path, read the flag dict from it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            cfg: Dict[str, Any] = json.load(f)
        flat = []
        for k, v in cfg.items():
            if isinstance(v, bool):
                if v:
                    flat.append(f"--{k}")
            else:
                flat.extend([f"--{k}", str(v)])
        return parser.parse_args(flat)
    return parser.parse_args(argv)


def add_noise_at_snr(audio: np.ndarray, snr_db: float,
                     rng=None) -> np.ndarray:
    """Mix white noise at the given SNR (the noise-evaluation setting)."""
    rng = rng or np.random.default_rng(0)
    power = float(np.mean(audio ** 2)) + 1e-12
    noise_power = power / (10.0 ** (snr_db / 10.0))
    noise = rng.standard_normal(audio.shape).astype(np.float32)
    noise *= np.sqrt(noise_power / (np.mean(noise ** 2) + 1e-12))
    return (audio + noise).astype(np.float32)
