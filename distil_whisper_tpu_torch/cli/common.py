"""Shared helpers of the port's CLIs: dataset loading and
interleaving, logging, batching, noise mixing, JSON-file arguments,
tokenizer-artifact copying, JSONL writing.

The port's own copy of ``distil_whisper_tpu.cli.common``.  A JSONL manifest
is read with the standard library, so neither an eval nor a training run
needs the ``datasets`` package; ``datasets`` is imported only for a
``save_to_disk`` directory or an ``.arrow`` file (and to interleave such
datasets).
"""

from __future__ import annotations

import json
import logging
import shutil
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

logger = logging.getLogger("distil_whisper_tpu_torch")


def setup_data_parallel(distributed: bool, device: str = "cuda",
                        model_parallel: int = 1, param_sharding: str = "1d"):
    """Join the job's process group (``--distributed`` forces it and raises
    without one; a ``torchrun`` environment joins it anyway) and return the
    ``(world / model_parallel, model_parallel)`` device mesh, or None in a
    single process.  A ``model_parallel`` > 1 raises ``ValueError`` unless
    it divides the world size of a multi-process job; so does
    ``param_sharding`` "2d" (parameters sliced over the data axis) without
    one.  Imported lazily: featurizer workers import this module."""
    from ..parallel import make_mesh, maybe_initialize_distributed
    from ..parallel.multihost import world_size
    alone = ("needs a multi-process job (--distributed under torchrun); "
             "this process runs alone, at world size 1")
    if model_parallel > 1 and not distributed:
        raise ValueError(f"--model_parallel {model_parallel} {alone}")
    if param_sharding == "2d" and not distributed:
        raise ValueError(f"--param_sharding 2d {alone}")
    if not maybe_initialize_distributed(force=distributed, device=device):
        return None
    n = world_size()
    if n % model_parallel:
        raise ValueError(f"--model_parallel {model_parallel} does not divide "
                         f"the world size {n}")
    return make_mesh((n // model_parallel, model_parallel))


def summed_word_errors(stats, *extra: int, mesh=None):
    """``stats`` (a ``WordErrors``) with its counts summed over the ranks,
    and each of ``extra`` summed alike: ``(stats, *extra)``.  Every rank
    must call it, one whose rows have no reference words too.  On a
    ``mesh`` with a model axis each data rank's counts are taken once
    (the model ranks of a data group hold the same rows)."""
    from ..parallel.mesh import coordinates
    from ..parallel.multihost import sum_over_ranks
    once = coordinates(mesh)[2] == 0
    counts = sum_over_ranks(once * np.asarray(
        [stats.hits, stats.substitutions, stats.insertions, stats.deletions,
         stats.num_ref_words, *extra], np.int64)).tolist()
    summed = type(stats)(hits=counts[0], substitutions=counts[1],
                         insertions=counts[2], deletions=counts[3],
                         num_ref_words=counts[4])
    return (summed, *counts[5:]) if extra else summed


def rank_suffix() -> str:
    """``-{rank}`` for the per-rank output files of a multi-process run,
    else empty."""
    from ..parallel.multihost import is_distributed, rank
    return f"-{rank()}" if is_distributed() else ""


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        stream=sys.stdout,
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")


TOKENIZER_FILES = ("vocab.json", "merges.txt", "tokenizer.json",
                   "added_tokens.json", "special_tokens_map.json",
                   "tokenizer_config.json", "normalizer.json",
                   "preprocessor_config.json", "generation_config.json")


def copy_tokenizer_files(src: str, dst: str) -> None:
    """Carry tokenizer/processor artifacts alongside exported weights."""
    dst_p = Path(dst)
    dst_p.mkdir(parents=True, exist_ok=True)
    for name in TOKENIZER_FILES:
        s = Path(src) / name
        if s.exists():
            shutil.copy(s, dst_p / name)


def load_dataset_any(path: str, split: Optional[str] = None):
    """Rows of a dataset on local disk, each a dict with ``audio`` (a WAV
    path, or ``{"array": ..., "sampling_rate": ...}``) and ``text``.

    Accepts a JSONL manifest (one JSON object a line; read with the standard
    library), a pseudo-labelling output directory (its ``dataset.jsonl``,
    or the per-rank ``dataset-{rank}.jsonl`` of a multi-GPU run,
    concatenated in rank order), or a ``datasets`` save_to_disk directory
    (Dataset or DatasetDict, ``split`` picks one) or ``.arrow`` file.
    """
    p = Path(path)
    if p.suffix in (".jsonl", ".json") and p.is_file():
        with open(p) as f:
            return [json.loads(line) for line in f if line.strip()]
    manifests = pl_manifests(p) if p.is_dir() else []
    if manifests:
        return [row for m in manifests for row in load_dataset_any(str(m))]
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


def pl_manifests(out_dir: Path) -> List[Path]:
    """The manifests of a pseudo-labelling output directory, in rank
    order: ``dataset.jsonl``, or ``dataset-0.jsonl``, ``dataset-1.jsonl``,
    ... of a multi-GPU run."""
    single = out_dir / "dataset.jsonl"
    if single.is_file():
        return [single]
    ranks = {}
    for m in out_dir.glob("dataset-*.jsonl"):
        tail = m.stem[len("dataset-"):]
        if tail.isdigit():
            ranks[int(tail)] = m
    return [ranks[r] for r in sorted(ranks)]


def sort_rows(ds, column: str):
    """``ds`` sorted by ``column``, as ``datasets.Dataset.sort`` sorts: a
    stable sort (equal values keep their order) with the rows whose value is
    None (or missing) last, Arrow's ``null_placement="at_end"``.  A
    ``datasets.Dataset`` is sorted by its own method, a row list here."""
    if not isinstance(ds, list):
        return ds.sort(column)
    present = [r for r in ds if r.get(column) is not None]
    return (sorted(present, key=lambda r: r[column])
            + [r for r in ds if r.get(column) is None])


def shard_rows(ds, num_shards: int, index: int):
    """The ``index``-th of ``num_shards`` contiguous shards of ``ds``, by the
    rule of ``datasets.Dataset.shard(contiguous=True)``: shards of
    ``len // num_shards`` rows, the first ``len % num_shards`` of them one
    row longer."""
    if not isinstance(ds, list):
        return ds.shard(num_shards=num_shards, index=index, contiguous=True)
    div, mod = divmod(len(ds), num_shards)
    start = div * index + min(index, mod)
    return ds[start:start + div + (1 if index < mod else 0)]


def parse_dataset_spec(dataset_str: str, splits: Optional[str] = None,
                       probabilities: Optional[str] = None
                       ) -> List[Dict[str, Any]]:
    """Parse the ``+``-delimited multi-dataset mini-language: ``"a+b"``
    with optional ``"train+train"`` splits and ``"0.7+0.3"`` sampling
    probabilities (normalised; uniform when absent)."""
    names = dataset_str.split("+")
    split_list = splits.split("+") if splits else [None] * len(names)
    if probabilities:
        probs = [float(p) for p in probabilities.split("+")]
    else:
        probs = [1.0 / len(names)] * len(names)
    if not (len(names) == len(split_list) == len(probs)):
        raise ValueError("dataset/split/probability lists must align: "
                         f"{len(names)} vs {len(split_list)} vs {len(probs)}")
    total = sum(probs)
    return [{"path": n, "split": s, "probability": p / total}
            for n, s, p in zip(names, split_list, probs)]


def interleave_rows(datasets: List[List[Dict[str, Any]]],
                    probabilities: List[float], seed: int = 0,
                    stopping_strategy: str = "all_exhausted"
                    ) -> List[Dict[str, Any]]:
    """Interleave row lists by sampling probability, the order of
    ``datasets.interleave_datasets``: sources drawn 1000 at a time by
    ``np.random.default_rng(seed).choice``, each source read in order and
    restarted when exhausted, until every source (``all_exhausted``) or
    any source (``first_exhausted``) has been read through."""
    if stopping_strategy not in ("all_exhausted", "first_exhausted"):
        raise ValueError(f"unknown stopping strategy {stopping_strategy}")
    stop = all if stopping_strategy == "all_exhausted" else any
    lengths = [len(d) for d in datasets]
    exhausted = [False] * len(datasets)
    cursor = [0] * len(datasets)
    rng = np.random.default_rng(seed)
    out: List[Dict[str, Any]] = []
    while True:
        for src in rng.choice(len(datasets), size=1000, p=probabilities):
            if stop(exhausted):
                return out
            src = int(src)
            out.append(datasets[src][cursor[src]])
            cursor[src] += 1
            if cursor[src] >= lengths[src]:
                exhausted[src] = True
                cursor[src] = 0


def load_multiple_datasets(dataset_str: str, splits: Optional[str] = None,
                           probabilities: Optional[str] = None,
                           seed: int = 0,
                           stopping_strategy: str = "all_exhausted"):
    """Load and interleave ``+``-delimited datasets by sampling
    probability.  JSONL manifests interleave as row lists
    (:func:`interleave_rows`); ``datasets`` directories through
    ``datasets.interleave_datasets`` (the same order)."""
    specs = parse_dataset_spec(dataset_str, splits, probabilities)
    loaded = [load_dataset_any(s["path"], s["split"]) for s in specs]
    if len(loaded) == 1:
        return loaded[0]
    probs = [s["probability"] for s in specs]
    if all(isinstance(d, list) for d in loaded):
        return interleave_rows(loaded, probs, seed, stopping_strategy)
    import datasets
    return datasets.interleave_datasets(
        [d if not isinstance(d, list) else datasets.Dataset.from_list(d)
         for d in loaded],
        probabilities=probs, seed=seed, stopping_strategy=stopping_strategy)


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


def write_jsonl(path: str, rows: Iterable[Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
