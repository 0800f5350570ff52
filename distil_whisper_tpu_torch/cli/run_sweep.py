"""Hyperparameter sweep runner: the offline stand-in for the reference's
W&B sweeps (flax/distillation_scripts/run_bs_sweep.yaml etc.).

The port of ``distil_whisper_tpu.cli.run_sweep``.  A sweep spec (JSON, or
YAML where ``yaml`` can be imported) uses the W&B layout:

    program: distillation            # distillation|finetuning|eval|pseudo_labelling
    method: grid                     # grid | random
    metric: {name: eval/wer, goal: minimize}
    command_args: [--freeze_encoder, --streaming]     # fixed flags
    parameters:
      learning_rate: {values: [1e-4, 3e-4]}
      per_device_train_batch_size: {values: [32, 64]}
      wer_threshold: {value: 10}

Each configuration runs the port's CLI ``main()`` in this process with
``--output_dir <sweep>/run-NNN``; the metric is read from the run's result
dict (eval) or the last row of its ``metrics.jsonl`` (trainers).  Results
land in ``sweep_results.jsonl`` plus a ``best.json`` summary.  A random
sweep draws its configurations with ``np.random.default_rng(seed)``, so a
spec and a seed give the JAX package's configurations in its order.

    python -m distil_whisper_tpu_torch.cli.run_sweep \\
        --sweep_config sweep.json --output_dir ./sweep \\
        -- --teacher_checkpoint ckpts/large-v3 ...   # extra fixed args
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

import numpy as np

from .common import logger, setup_logging

PROGRAMS = {
    "distillation": "run_distillation",
    "finetuning": "run_finetuning",
    "eval": "run_eval",
    "pseudo_labelling": "run_pseudo_labelling",
}


def load_spec(path: str) -> dict:
    """A sweep spec from a JSON file, or a YAML file where ``yaml`` can be
    imported."""
    text = Path(path).read_text()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(f"{path}: a YAML spec needs the yaml package; "
                               "write the spec as JSON") from e
        return yaml.safe_load(text)
    return json.loads(text)


def expand_configs(spec: dict, max_runs: int, seed: int):
    """Parameter dicts for every run (grid) or sampled (random)."""
    params = spec.get("parameters", {})
    fixed = {k: v["value"] for k, v in params.items() if "value" in v}
    swept = {k: v["values"] for k, v in params.items() if "values" in v}
    method = spec.get("method", "grid")
    keys = sorted(swept)
    if method == "grid":
        combos = list(itertools.product(*(swept[k] for k in keys)))
        if max_runs:
            combos = combos[:max_runs]
    elif method == "random":
        rng = np.random.default_rng(seed)
        combos = [tuple(swept[k][int(rng.integers(len(swept[k])))]
                        for k in keys)
                  for _ in range(max_runs or 10)]
    else:
        raise ValueError(f"unknown sweep method {method!r}")
    return [dict(fixed, **dict(zip(keys, c))) for c in combos]


def read_metric(result, run_dir: Path, name: str):
    """Metric from a returned dict (eval) or the run's metrics.jsonl."""
    if isinstance(result, dict) and name in result:
        return float(result[name])
    mpath = run_dir / "metrics.jsonl"
    if mpath.exists():
        val = None
        with open(mpath) as f:
            for line in f:
                row = json.loads(line)
                if name in row:
                    val = float(row[name])
        return val
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sweep_config", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_runs", type=int, default=0, help="0 = full grid")
    p.add_argument("--seed", type=int, default=0)
    # every unrecognised arg is passed through to the target CLI verbatim
    args, extra = p.parse_known_args(argv)
    args.extra = [a for a in extra if a != "--"]
    setup_logging()

    spec = load_spec(args.sweep_config)
    program = spec.get("program", "distillation")
    if program not in PROGRAMS:
        raise ValueError(f"program must be one of {sorted(PROGRAMS)}")
    import importlib
    target_main = importlib.import_module(f".{PROGRAMS[program]}",
                                          __package__).main

    metric_name = spec.get("metric", {}).get("name")
    goal = spec.get("metric", {}).get("goal", "minimize")
    configs = expand_configs(spec, args.max_runs, args.seed)
    logger.info("sweep: %d runs of %s (metric %s, %s)", len(configs),
                program, metric_name, goal)

    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    results_f = open(out_root / "sweep_results.jsonl", "w")
    best = None
    for i, cfg in enumerate(configs):
        run_dir = out_root / f"run-{i:03d}"
        argv_run = list(spec.get("command_args", [])) + list(args.extra)
        for k, v in cfg.items():
            argv_run += [f"--{k}", str(v)]
        if program == "eval":
            # run_eval has no --output_dir; its artifact is --output_json
            run_dir.mkdir(parents=True, exist_ok=True)
            argv_run += ["--output_json", str(run_dir / "result.json")]
        else:
            argv_run += ["--output_dir", str(run_dir)]
        logger.info("sweep run %d/%d: %s", i + 1, len(configs), cfg)
        try:
            result = target_main(argv_run)
            status = "ok"
        except SystemExit as e:
            # argparse errors raise SystemExit (a BaseException): a flag typo
            # in one config must fail that RUN, not abort the whole sweep
            logger.error("run %d exited (bad flags?): %s", i, e)
            result, status = None, f"exit: {e}"
        except Exception as e:  # noqa: BLE001 - a failed config ends one run
            logger.exception("run %d failed", i)
            result, status = None, f"error: {e}"
        metric = (read_metric(result, run_dir, metric_name)
                  if metric_name else None)
        row = {"run": i, "config": cfg, "status": status,
               "metric": metric_name, "value": metric}
        results_f.write(json.dumps(row) + "\n")
        results_f.flush()
        if metric is not None and (
                best is None
                or (goal == "minimize" and metric < best["value"])
                or (goal == "maximize" and metric > best["value"])):
            best = row
    results_f.close()
    if best is not None:
        with open(out_root / "best.json", "w") as f:
            json.dump(best, f, indent=2)
        logger.info("best: %s = %s with %s", metric_name, best["value"],
                    best["config"])
    return best


if __name__ == "__main__":
    main()
