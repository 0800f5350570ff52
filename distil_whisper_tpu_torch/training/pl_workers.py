"""Featurizer subprocess workers for pseudo-labelling.

The port of ``distil_whisper_tpu.training.pl_workers``.  Pseudo-labelling
is host-bound once generation is fast: audio load, 30 s packing and the
int16 conversion compete with the consume side (detokenise, CSV and
manifest writes) for one interpreter lock.  This module moves the produce
side into N ``multiprocessing`` workers (spawn context), the role of the
reference dataloader's ``num_workers`` (run_pseudo_labelling.py:751-790):

* each worker re-opens the dataset by path, sorts it by speaker when it
  packs, and takes a contiguous 1/N shard (:func:`..cli.common.sort_rows`,
  :func:`..cli.common.shard_rows`, which give ``datasets``' order for a row
  list too), so same-speaker runs and ``condition_on_prev`` chains break
  only at shard boundaries;
* workers ship zero-padded int16 PCM batches (16-bit source audio round-
  trips bit-exactly and the queue carries half the bytes); the main process
  keeps everything that touches the device (upload, log-mel, generate);
* per-worker FIFO order is kept by ``mp.Queue``, so the consumer keys its
  condition-on-prev state by worker id.

Workers never touch the GPU: they import the audio reader, the CLI helpers
and ``training.data`` (whose package loads lazily), never the model, the
kernels or ``torch.cuda``, and they die with the parent (daemon).
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Dict, Iterator


def _worker(q, wid: int, n_workers: int, spec: Dict[str, Any]) -> None:
    """Subprocess body: load -> sort -> shard -> pack -> int16 batches onto
    ``q``.  Must stay import-light (spawn re-imports fresh)."""
    import numpy as np

    from ..audio.io import load_audio
    from ..cli.common import load_dataset_any, shard_rows, sort_rows
    from .data import pack_samples_iter

    try:
        ds = load_dataset_any(spec["dataset_path"], spec["split"])
        if not isinstance(ds, list):
            ds = ds.with_format("numpy", columns=[spec["audio_col"]],
                                output_all_columns=True)
        if spec["concatenate"] and spec["speaker_col"]:
            ds = sort_rows(ds, spec["speaker_col"])
        host_idx, host_n = spec["host_shard"]
        if host_n > 1:
            ds = shard_rows(ds, host_n, host_idx)
        if n_workers > 1:
            ds = shard_rows(ds, n_workers, wid)

        def rows():
            for row in ds:
                yield {
                    "audio": load_audio(row[spec["audio_col"]],
                                        spec["sampling_rate"]),
                    "text": row.get(spec["text_col"], ""),
                    "speaker_id": (row.get(spec["speaker_col"])
                                   if spec["speaker_col"] else None),
                }

        if spec["concatenate"]:
            samples = pack_samples_iter(rows(),
                                        max_input_samples=spec["n_samples"])
        else:
            def _plain():
                for s in rows():
                    s["condition_on_prev"] = 0
                    yield s
            samples = _plain()

        bsz, n_samp = spec["local_bsz"], spec["n_samples"]
        group: list = []

        def flush():
            wav16 = np.zeros((bsz, n_samp), np.int16)
            lens = []
            for j, g in enumerate(group):
                w = g["audio"][:n_samp]
                lens.append(len(w))
                wav16[j, :len(w)] = np.clip(np.round(w * 32768.0),
                                            -32768, 32767).astype(np.int16)
            q.put({"worker": wid, "n": len(group), "lens": lens,
                   "texts": [g["text"] for g in group],
                   "cond": [int(g.get("condition_on_prev") or 0)
                            for g in group],
                   "wav16": wav16})

        for s in samples:
            group.append(s)
            if len(group) == bsz:
                flush()
                group = []
        if group:
            flush()
        q.put({"worker": wid, "end": True})
    except BaseException as e:  # noqa: BLE001 - raised in the parent
        q.put({"worker": wid, "error": f"{type(e).__name__}: {e}"})


def worker_feature_batches(spec: Dict[str, Any], n_workers: int,
                           queue_depth: int = 2) -> Iterator[Dict[str, Any]]:
    """Run N featurizer subprocesses; yield their int16 batches as they
    arrive (each worker's order kept).  Raises if a worker fails."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=max(n_workers * queue_depth, 2))
    procs = [ctx.Process(target=_worker, args=(q, wid, n_workers, spec),
                         daemon=True)
             for wid in range(n_workers)]
    for p in procs:
        p.start()
    done = 0
    try:
        while done < n_workers:
            item = q.get()
            if "error" in item:
                raise RuntimeError(
                    f"featurizer worker {item['worker']} failed: "
                    f"{item['error']}")
            if item.get("end"):
                done += 1
                continue
            yield item
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
