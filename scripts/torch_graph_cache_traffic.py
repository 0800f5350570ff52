#!/usr/bin/env python3
"""How many decode programs real traffic makes, and what they cost.

    python3 scripts/torch_graph_cache_traffic.py --root DIR --work DIR
                                                 [--out FILE] [--label NAME]
                                                 [--paths P[,P...]]
                                                 [--num_beams K]

Runs the PyTorch port found in ``--root`` (a checkout; the repository
itself when left out) on one GPU, through four of its users' paths
(``--paths``, all by default):

micro-batch  distil-large-v3 at full width, random bf16 weights (seed 0),
             ``BatchingTranscriber`` with 16 rows and a 50 ms window at a
             96-token budget, fed the serving cell's traffic of
             ``chip_smoke.py`` (32 single windows with budgets 24-96, the
             last 8 sampled; 2 files of 70 s with segment timestamps; 4
             word-timestamp requests) all at once: a cold pass (the
             captures happen on the requests' path), then two warm passes.
             Each pass reports audio s/s and the p50 and p95 latency.
spec_microbatch
             the same scheduler and traffic speculating: large-v3 at full
             width (seed 0) as the teacher, distil-large-v3's decoder
             (seed 1) as its draft, ``synthetic_acceptance`` 0.8, gamma 5
             with the adaptive controller walking {2, 5, 10}; its passes
             also report the speculative batches, drafted and accepted
             tokens and the controller's moves.
beam_microbatch
             distil-large-v3 as in micro-batch, sent beam groups: for 2 and
             5 beams, groups of 1, 4 and 16 single 30 s windows (and of 8
             at 5 beams) at a 96-token budget, each group submitted at once
             and waited for; a cold pass, then two warm passes.
pseudo-label large-v3 at full width, random bf16 weights (seed 0), saved
             once under ``--work``, labelling ``chip_smoke.py``'s recipe
             manifest (32 clips of 5-30 s, two speakers, concatenated) with
             ``run_pseudo_labelling`` at batch 16 and 64 new tokens, two
             featurizer workers (``--num_beams`` beams, greedy by default):
             its steady and wall audio s/s.

Where the port captures its decode loops as CUDA graphs it also reports,
for each path, the programs its graph owners keep, built and evicted, the
distinct keys (rows, prompt length, budget, sampling, timestamps), the
captures and their seconds, and the bytes of each owner's pool.  Run it on
two checkouts in one call to compare them (parent, change, change, parent).
Prints one JSON object a line, with the card's name and power limit; the
last line holds everything.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_smoke():
    """``chip_smoke.py`` of this checkout, for its synthetic data helpers
    (it imports the port only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Owners:
    """Every graph owner built while it is installed (none where the port
    has no graphs), kept alive to be read after the run."""

    def __init__(self):
        self.owners = []
        try:
            from distil_whisper_tpu_torch.generation import graphs
        except ImportError:
            self.graphs = None
            return
        self.graphs = graphs
        init = graphs.GraphOwner.__init__
        owners = self.owners

        def recording(owner, *a, **k):
            init(owner, *a, **k)
            owners.append(owner)
        graphs.GraphOwner.__init__ = recording

    def stats(self):
        return None if self.graphs is None else self.graphs.read_stats()

    def report(self, since):
        if self.graphs is None:
            return {"graphs": False}
        now = self.graphs.read_stats()
        out = {"graphs": True,
               "captures": now["captures"] - since["captures"],
               "capture_s": now["capture_s"] - since["capture_s"],
               "replays": now["replays"] - since["replays"],
               "host_syncs": now["host_syncs"] - since["host_syncs"],
               "owners": []}
        for o in self.owners:
            rep = o.report() if hasattr(o, "report") else {
                "programs": len(o.entries),
                "pool_bytes": self.graphs.pool_bytes(o)}
            if not rep.get("built", rep["programs"]):
                continue
            rep["name"] = o.name
            rep["keys"] = sorted({describe(k) for k in o.entries},
                                 key=str)
            out["owners"].append(rep)
        self.owners.clear()
        return out


def describe(key):
    """(rows, prompt length, budget, sampling, top_k, timestamps) of a
    ``generate`` program's key, led by ("speculative", gamma, draft or
    n-gram) for a speculative loop's and by ("beam", beams, length
    penalty) for a beam search's; the engine's keys as they are."""
    if isinstance(key, tuple) and key and key[0] == "beam":
        return key[:3] + describe(key[3:])
    if isinstance(key, tuple) and key and hasattr(key[0], "gamma"):
        method = "draft" if key[0].draft_cfg is not None else "ngram"
        return ("speculative", key[0].gamma, method) + describe(key[3:])
    if (isinstance(key, tuple) and len(key) > 2
            and hasattr(key[1], "max_new_tokens")):
        shape, opts = key[0], key[1]
        return (shape[0], shape[1], opts.max_new_tokens, opts.do_sample,
                opts.top_k, opts.return_timestamps)
    return str(key)


def microbatch(smoke, owners, tok, speculative=False):
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber

    cfg = PRESETS["large-v3" if speculative else "distil-large-v3"]
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    pipe = WhisperPipeline(None, dtype=torch.bfloat16, batch_size=16,
                           max_new_tokens=96, params=params, cfg=cfg,
                           tokenizer=tok, device="cuda")
    spec = {}
    if speculative:
        dcfg = PRESETS["distil-large-v3"]
        spec = dict(assistant=(init_params(dcfg, seed=1, device="cuda",
                                           dtype=torch.bfloat16), dcfg),
                    gamma=5, synthetic_acceptance=0.8, adaptive_gamma=True)
    clips = (smoke.synthetic_audio(16, 30.0, seed=1)
             + smoke.synthetic_audio(16, 30.0, seed=4))
    reqs, audio_s = smoke.serving_traffic(
        clips, smoke.synthetic_audio(2, 70.0, seed=5))
    since = owners.stats()
    torch.cuda.reset_peak_memory_stats()
    tr = BatchingTranscriber(pipe, batch_size=16, max_wait_ms=50.0,
                             max_new_tokens=96, **spec).start()
    passes = []
    try:
        for name in ("cold", "warm1", "warm2"):
            torch.cuda.synchronize()
            results, lat, wall = smoke.serve_all(tr, reqs)
            passes.append({"pass": name, "wall_s": wall,
                           "audio_s_per_s": audio_s / wall,
                           "latency_p50_s": float(np.percentile(lat, 50)),
                           "latency_p95_s": float(np.percentile(lat, 95)),
                           "latency_max_s": max(lat)})
            if speculative:
                passes[-1].update({k: tr.stats.get(k) for k in (
                    "speculative_batches", "drafted", "accepted",
                    "gamma_current", "gamma_raises", "gamma_drops")})
        stats = dict(tr.stats)
    finally:
        tr.stop()
    out = {"path": "spec_microbatch" if speculative else "microbatch",
           "audio_s": audio_s, "requests": len(reqs),
           "passes": passes, "batches": stats["batches"],
           "max_batch": stats["max_batch"],
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           **owners.report(since)}
    del tr, pipe, params
    torch.cuda.empty_cache()
    return out


BEAM_GROUPS = ((2, 1), (2, 4), (2, 16), (5, 1), (5, 4), (5, 8), (5, 16))


def beam_microbatch(smoke, owners, tok):
    """The micro-batch scheduler fed beam groups (``BEAM_GROUPS``: beams,
    rows), one group at a time; a cold pass and two warm passes."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving import BatchingTranscriber

    cfg = PRESETS["distil-large-v3"]
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    pipe = WhisperPipeline(None, dtype=torch.bfloat16, batch_size=16,
                           max_new_tokens=96, params=params, cfg=cfg,
                           tokenizer=tok, device="cuda")
    clips = smoke.synthetic_audio(16, 30.0, seed=1)
    since = owners.stats()
    torch.cuda.reset_peak_memory_stats()
    tr = BatchingTranscriber(pipe, batch_size=16, max_wait_ms=50.0,
                             max_new_tokens=96).start()
    passes = []
    try:
        for name in ("cold", "warm1", "warm2"):
            lat, wall, audio_s = [], 0.0, 0.0
            for beams, rows in BEAM_GROUPS:
                reqs = [(c, dict(language="en", num_beams=beams))
                        for c in clips[:rows]]
                torch.cuda.synchronize()
                _, group_lat, group_wall = smoke.serve_all(tr, reqs)
                lat += group_lat
                wall += group_wall
                audio_s += rows * 30.0
            passes.append({"pass": name, "wall_s": wall,
                           "audio_s_per_s": audio_s / wall,
                           "latency_p50_s": float(np.percentile(lat, 50)),
                           "latency_p95_s": float(np.percentile(lat, 95))})
        stats = dict(tr.stats)
    finally:
        tr.stop()
    out = {"path": "beam_microbatch", "groups": BEAM_GROUPS,
           "audio_s": audio_s, "passes": passes, "batches": stats["batches"],
           "max_batch": stats["max_batch"],
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           **owners.report(since)}
    del tr, pipe, params
    torch.cuda.empty_cache()
    return out


def pseudo_label(smoke, owners, work: Path, num_beams: int = 1):
    import torch
    from distil_whisper_tpu_torch.cli import run_pseudo_labelling
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.models import init_params, save_pretrained

    teacher = work / "teacher"
    if not (teacher / "config.json").exists():
        cfg = PRESETS["large-v3"]
        save_pretrained(init_params(cfg, seed=0, device="cuda",
                                    dtype=torch.bfloat16), cfg, str(teacher),
                        dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        smoke.synthetic_tokenizer(teacher)
    root = Path(tempfile.mkdtemp(prefix="pl_", dir=work))
    smoke.recipe_manifests(root)
    since = owners.stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_pseudo_labelling.main([
        "--model_checkpoint", str(teacher),
        "--dataset_path", str(root / "pl.jsonl"),
        "--output_dir", str(root / "out"), "--language", "en",
        "--per_device_batch_size", "16", "--max_new_tokens", "64",
        "--logging_steps", "1", "--speaker_id_column_name", "speaker_id",
        "--featurizer_workers", "2", "--num_beams", str(num_beams)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = json.loads((root / "out" / "pl_stats.json").read_text())
    out = {"path": "pseudo_label", "num_beams": num_beams,
           "rows": stats["rows"],
           "batches": stats["batches"], "audio_s": stats["audio_s"],
           "audio_s_per_s_steady": stats["rtfx_steady_state"],
           "audio_s_per_s_wall": stats["audio_s"] / wall, "wall_s": wall,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           **owners.report(since)}
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose distil_whisper_tpu_torch runs")
    ap.add_argument("--work", required=True,
                    help="directory for the teacher checkpoint and data")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None, help="append the result here")
    ap.add_argument("--paths", default="microbatch,spec_microbatch,"
                    "beam_microbatch,pseudo_label",
                    help="the paths to run, in order")
    ap.add_argument("--num_beams", type=int, default=1,
                    help="beams of the pseudo-label path")
    args = ap.parse_args()
    unknown = set(args.paths.split(",")) - {
        "microbatch", "spec_microbatch", "beam_microbatch", "pseudo_label"}
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = load_smoke()
    owners = Owners()
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    result = {"label": args.label or args.root, "card": smi}
    smoke.phase_build()          # the kernels built before the first pass
    with tempfile.TemporaryDirectory() as tmp:
        tok = smoke.synthetic_tokenizer(Path(tmp))
    for path in args.paths.split(","):
        if path == "pseudo_label":
            result[path] = pseudo_label(smoke, owners, work, args.num_beams)
        elif path == "beam_microbatch":
            with torch.no_grad():
                result[path] = beam_microbatch(smoke, owners, tok)
        else:
            with torch.no_grad():
                result[path] = microbatch(smoke, owners, tok,
                                          speculative=path != "microbatch")
        print(json.dumps(result[path]), flush=True)
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
