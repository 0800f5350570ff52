"""A multi-process dry run of the distillation step and of generation.

The counterpart of the JAX package's ``dryrun_multichip``: ``n_ranks``
processes (spawned, each its own ``torch.distributed`` rank: gloo on the
CPU; on the card NCCL when every rank has its own card, else gloo) build
the ``(n_ranks / model_parallel, model_parallel)`` mesh, shard a tiny
teacher and student over its model axis (and with ``param_sharding="2d"``
over its data axis too, ``RULES_2D``, as JAX's dry run does) and replicate
them over its data axis from the first data rank, and each data rank feeds
its rows of one global batch, whose label-token counts differ per data
rank, to:

- the data-parallel distillation step (hidden-state MSE, remat) in fp32,
  held against one process's step on the whole global batch, each within
  1e-5 relative (L2 over every leaf): the summed gradient (read from
  Adam's first moment), the parameters after the step, and the loss;
  every rank's parameters bit-identical to rank 0's.  The update
  (parameters after the step less before) against the one-process update
  is reported, not held: Adam's first step moves an element by
  ``lr * g / (|g| + eps)``, so where ``|g|`` is of the order of ``eps``
  a rounding difference of another reduction order moves the element by
  a visible part of ``lr``.  The element that parts most is reported with
  its leaf, its update and the one-process gradient there;
- a step with the int8 teacher (quantized whole, then sharded) and a QAT
  (``w8a8``) step: finite losses, and the parameters after each within
  1e-5 relative of one process's same sequence of steps;
- greedy generation on the sharded teacher: the tokens of one process's
  unsharded generation, exactly (fp32);
- the continuous engine on the mesh (``serving_engine``, lanes over the
  data axis, the model sharded over the model axis, rank 0 leading): a
  serving-shaped tiny model (vocabulary 51865, d 64, 2 + 2 layers) with a
  1-layer draft, gamma 2, block 2, three concurrent requests, the third
  timestamped: texts equal to one process's engine, and no timestamp
  fallback.

    python -c "from distil_whisper_tpu_torch.parallel.dryrun import \\
        dryrun_multigpu; print(dryrun_multigpu(4, model_parallel=2))"

runs on the card (two ranks may share one); ``device='cpu'`` runs it on
the CPU over gloo.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np

# the step's update and loss against one process's on the global
# batch, fp32, relative
PARAM_TOL = 1e-5
ROWS_PER_RANK = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def global_batch(n_rows: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The dry run's batch: 80 mel bins of 3000 frames, 16 label tokens
    a row, about one in five masked at random (so the ranks' token counts
    differ)."""
    rng = np.random.default_rng(seed)
    labels = np.where(rng.random((n_rows, 16)) < 0.2, -100,
                      rng.integers(0, 1024, (n_rows, 16)))
    labels[0, 4:] = -100            # rank 0's first row: few tokens
    return {"input_features": rng.standard_normal(
                (n_rows, 80, 3000)).astype(np.float32),
            "decoder_input_ids": rng.integers(0, 1024, (n_rows, 16)
                                              ).astype(np.int64),
            "labels": labels.astype(np.int64)}


def _serving_tokenizer():
    """A byte-level tokenizer with Whisper's special tokens (no merges),
    as JAX's dry run builds one."""
    from ..tokenizer import WhisperTokenizer
    from ..tokenizer.bpe import ByteLevelBPE, bytes_to_unicode
    units = list(bytes_to_unicode().values())
    return WhisperTokenizer(
        ByteLevelBPE({u: i for i, u in enumerate(units)}, []),
        {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
         "<|en|>": 50259, "<|translate|>": 50358, "<|transcribe|>": 50359,
         "<|startofprev|>": 50361, "<|nospeech|>": 50362,
         "<|notimestamps|>": 50363})


def _engine_texts(params, cfg, draft, tok, dev, lanes: int, mesh=None):
    """Three concurrent requests (the third timestamped) through a
    speculative continuous engine (gamma 2, block 2): the leader's texts
    and stats, or None on a follower."""
    import threading
    import torch
    from ..pipeline import WhisperPipeline
    from ..serving_engine import ContinuousTranscriber
    pipe = WhisperPipeline(None, params=params, cfg=cfg, tokenizer=tok,
                           dtype=torch.float32, batch_size=2,
                           max_new_tokens=8, device=dev, mesh=mesh)
    tr = ContinuousTranscriber(pipe, batch_size=lanes, max_new_tokens=8,
                               block_steps=2, assistant=draft, gamma=2)
    if not tr.leader:
        tr.follow()
        return None
    tr.start()
    t = np.linspace(0, 1.0, 16000, dtype=np.float32)
    wavs = [(0.3 * np.sin(2 * np.pi * (200.0 + 60 * i) * t)
             ).astype(np.float32) for i in range(3)]
    texts = [None] * 3

    def post(i):
        texts[i] = tr.submit(wavs[i], language="en",
                             return_timestamps=(i == 2), timeout=600)["text"]
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        tr.stop()
    return texts, dict(tr.stats)


def _rank_main(rank: int, world: int, port: int, device: str,
               out_dir: str, model_parallel: int = 1,
               param_sharding: str = "1d") -> None:
    """One rank of the dry run; writes ``rank{rank}.json`` to ``out_dir``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..config import WhisperConfig
    from ..device import resolve_device
    from ..generation import GenerationOptions, encode_and_generate
    from ..models import init_params
    from ..models.params import tree_paths, unflatten_paths
    from ..ops.quant import quantize_teacher_params
    from ..training import (DistillConfig, OptimizerConfig, TrainState,
                            build_train_step, init_student_from_teacher,
                            place_state)
    from . import (DEFAULT_RULES, RULES_2D, make_mesh,
                   maybe_initialize_distributed, shard_params)
    from .mesh import coordinates

    maybe_initialize_distributed(force=True, device=device)
    dev = resolve_device(device)
    mesh = make_mesh((world // model_parallel, model_parallel))
    rules = RULES_2D if param_sharding == "2d" else DEFAULT_RULES
    d, n_data, _, _ = coordinates(mesh)
    cfg = WhisperConfig(vocab_size=1024, num_mel_bins=80, d_model=64,
                        encoder_layers=2, decoder_layers=4,
                        encoder_attention_heads=4, decoder_attention_heads=4,
                        encoder_ffn_dim=128, decoder_ffn_dim=128,
                        pad_token_id=0, eos_token_id=2,
                        decoder_start_token_id=1)
    # each data rank draws its own init (the model ranks of a group slice
    # one tree); the broadcast makes every shard data rank 0's
    full = init_params(cfg, seed=d, device=dev)
    teacher = shard_params(full, mesh, rules, cfg=cfg)
    student, scfg = init_student_from_teacher(full, cfg, decoder_layers=2)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                          precision="full", frozen_prefixes=("encoder",))
    dcfg = DistillConfig(mse_weight=1.0, remat=True)
    state = TrainState.create(student, opt)
    init = {p: x.detach().clone() for p, x in tree_paths(state.params).items()}
    state = place_state(state, mesh, rules)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in global_batch(ROWS_PER_RANK * n_data).items()}
    mine = {k: v[d * ROWS_PER_RANK:(d + 1) * ROWS_PER_RANK]
            for k, v in batch.items()}

    step, _ = build_train_step(scfg, cfg, dcfg, opt, mesh=mesh)
    t0 = time.perf_counter()
    state, metrics = step(state, teacher, mine)
    step_s = time.perf_counter() - t0
    out: Dict[str, Any] = {
        "rank": rank, "world": world, "model_parallel": model_parallel,
        "param_sharding": param_sharding,
        "backend": dist.get_backend(),
        "device": str(dev), "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
        "label_tokens": int((mine["labels"] != -100).sum())}
    # the unsharded state, gathered on every rank
    sd = state.state_dict()
    params = sd["params"]

    # every replica equals rank 0's, bit for bit
    from .multihost import gather_rows
    digest = np.asarray([[float(x.double().sum()) for x in params.values()]])
    out["replicas_identical"] = bool(
        (gather_rows(digest) == digest[0]).all())

    if rank == 0:
        # one process on the whole global batch, no collectives
        ref_state = TrainState.create(unflatten_paths(init), opt)
        ref_step, _ = build_train_step(scfg, cfg, dcfg, opt)
        ref_state, ref_metrics = ref_step(ref_state, full, batch)
        ref = {p: x.detach() for p, x in tree_paths(ref_state.params).items()}
        def rel_l2(a, b):
            diff = sum(float((a[p].double() - b[p].double()).square().sum())
                       for p in b)
            norm = sum(float(b[p].double().square().sum()) for p in b)
            return (diff / max(norm, 1e-300)) ** 0.5

        ref_upd = {p: ref[p].double() - init[p].double() for p in params}
        out["param_err"] = rel_l2(params, ref)
        out["update_err"] = rel_l2(
            {p: params[p].double() - init[p].double() for p in params},
            ref_upd)
        out["loss_rel_err"] = (abs(out["loss"] - float(ref_metrics["loss"]))
                               / abs(float(ref_metrics["loss"])))
        # after step 1, mu = (1 - b1) g: the summed gradient against the
        # one-process gradient, before Adam scales it
        out["grad_err"] = rel_l2(sd["mu"], ref_state.mu)
        # the element that parts most, and the one-process gradient there
        leaf = max(params, key=lambda p: float((params[p] - ref[p]).abs()
                                               .max()))
        i = int((params[leaf] - ref[leaf]).abs().argmax())
        mu = ref_state.mu.get(leaf)
        out["worst_element"] = {
            "leaf": leaf, "index": i,
            "abs_diff": float((params[leaf] - ref[leaf]).reshape(-1)[i]
                              .abs()),
            "of_leaf_max": float((params[leaf] - ref[leaf]).abs().max()
                                 / max(float(ref[leaf].abs().max()), 1e-30)),
            "update": float(ref_upd[leaf].reshape(-1)[i]),
            "grad_abs": (None if mu is None else
                         float(mu.reshape(-1)[i].abs()) / (1.0 - opt.b1)),
            "adam_eps": opt.eps, "lr": opt.learning_rate}

    # the int8 teacher (quantized whole, then sharded) and a QAT step,
    # each against one process's same sequence of steps
    full8 = quantize_teacher_params(full)
    teacher8 = shard_params(full8, mesh, rules, cfg=cfg)
    state, m8 = step(state, teacher8, mine)
    # copies: the next step updates the parameters in place
    params8 = {p: x.clone() for p, x in state.state_dict()["params"].items()}
    qat_cfg = DistillConfig(remat=True, quantize_student="w8a8")
    qat_step, _ = build_train_step(scfg, cfg, qat_cfg, opt, mesh=mesh)
    state, mq = qat_step(state, teacher, mine)
    params_q = state.state_dict()["params"]
    out.update(int8_teacher_loss=float(m8["loss"]), qat_loss=float(mq["loss"]))
    if rank == 0:
        ref_state, _ = ref_step(ref_state, full8, batch)
        ref8 = {p: x.detach().clone()
                for p, x in tree_paths(ref_state.params).items()}
        ref_qat, _ = build_train_step(scfg, cfg, qat_cfg, opt)
        ref_state, _ = ref_qat(ref_state, full, batch)
        out["int8_teacher_err"] = rel_l2(params8, ref8)
        out["qat_err"] = rel_l2(params_q, {
            p: x.detach() for p, x in tree_paths(ref_state.params).items()})

    # greedy generation on the sharded teacher (every rank the same rows)
    opts = GenerationOptions(max_new_tokens=12)
    prompt = torch.full((2, 1), cfg.decoder_start_token_id, device=dev)
    mel = batch["input_features"][:2]
    tokens = encode_and_generate(teacher, cfg, mel, prompt, opts,
                                 device=dev).sequences
    if rank == 0:
        ref = encode_and_generate(full, cfg, mel, prompt, opts,
                                  device=dev).sequences
        out["generate_tokens_equal"] = bool(torch.equal(tokens, ref))

    # the continuous engine on the mesh (the model sharded over 'model',
    # the lanes over 'data'), against one process's engine
    srv_cfg = WhisperConfig(vocab_size=51865, num_mel_bins=80, d_model=64,
                            encoder_layers=2, decoder_layers=2,
                            encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=96,
                            decoder_ffn_dim=96)
    srv = init_params(srv_cfg, seed=2, device=dev)
    draft = init_student_from_teacher(srv, srv_cfg, decoder_layers=1)
    tok = _serving_tokenizer()
    lanes = max(2, n_data)          # a lane a data rank at least
    served = _engine_texts(srv, srv_cfg, draft, tok, dev, lanes, mesh)
    if served is not None:
        texts, stats = served
        alone, _ = _engine_texts(srv, srv_cfg, draft, tok, dev, lanes)
        out.update(engine_texts=texts, engine_texts_equal=texts == alone,
                   engine_ts_fallback=int(stats["ts_fallback"]),
                   engine_drafted=int(stats["drafted"]))
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multigpu(n_ranks: int, model_parallel: int = 1,
                    param_sharding: str = "1d", device: str = "cuda",
                    timeout: float = 600.0) -> Dict[str, Any]:
    """Spawn ``n_ranks`` ranks on a ``(n_ranks / model_parallel,
    model_parallel)`` mesh, run the dry run (parameters sharded under
    ``RULES_2D`` with ``param_sharding="2d"``), and return rank 0's report
    with every rank's under ``ranks``.  Raises if a rank fails, if a step,
    the generated tokens or the engine's texts part from one process's,
    if the engine fell back for the timestamped request, or if the losses
    are not finite; every rank is killed on the way out."""
    if param_sharding not in ("1d", "2d"):
        raise ValueError(f"param_sharding {param_sharding!r} not in "
                         "('1d', '2d')")
    if n_ranks % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"{n_ranks} ranks")
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="dw_dryrun_") as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_ranks, port, device, out_dir,
                                   model_parallel, param_sharding))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dryrun_multigpu: rank exit codes {codes}")
        ranks = [json.loads(Path(out_dir, f"rank{r}.json").read_text())
                 for r in range(n_ranks)]
    report = {**ranks[0], "ranks": ranks}
    bad = []
    for k in ("grad_err", "param_err", "loss_rel_err", "int8_teacher_err",
              "qat_err"):
        if not report[k] <= PARAM_TOL:
            bad.append(f"{k} {report[k]} off the one-process step (update "
                       f"{report['update_err']}, worst element "
                       f"{report['worst_element']})")
    if not report["engine_texts_equal"]:
        bad.append(f"engine texts {report['engine_texts']} differ from one "
                   "process's")
    if report["engine_ts_fallback"]:
        bad.append("the engine sent the timestamped request to its fallback")
    if not all(r["replicas_identical"] for r in ranks):
        bad.append("replicas differ")
    if not report["generate_tokens_equal"]:
        bad.append("sharded greedy tokens differ from one process's")
    if len({r["loss"] for r in ranks}) != 1:
        bad.append("ranks report different losses")
    losses = [r[k] for r in ranks for k in ("loss", "int8_teacher_loss",
                                             "qat_loss")]
    if not np.isfinite(losses).all():
        bad.append(f"non-finite losses {losses}")
    if bad:
        raise AssertionError("dryrun_multigpu: " + "; ".join(bad))
    return report
