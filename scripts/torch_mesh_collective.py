#!/usr/bin/env python3
"""The device collective of the port (``csrc/mesh_collective.cu``) on the
card: every mode against its plain version and its time, the same with
device work between the calls, a meshed engine block graphed and eager (and graphed without its
host gather or its bounded read), and a small tensor-parallel decode
replayed as CUDA graphs against the plain loop.

    python3 scripts/torch_mesh_collective.py [--out mesh.json]

Spawns ``max(2, cards)`` ranks on a ``(1, ranks)`` mesh: two ranks share
one card (gloo for the host's collectives, the device comm for the card's),
four cards take one rank each (NCCL).  Each rank runs
``chip_smoke.mesh_collective_rows`` (the rows ``chip_smoke.py`` prints),
then ``generate`` and ``beam_search`` on a small fp32 model sharded over
the mesh, graphs against ``generate_eager`` / ``beam_search_eager``, bit
for bit.  Prints one JSON line a rank and the card's name and power
limit; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


#: device work between two collectives, µs (``torch.cuda._sleep``), and
#: the SM clock that turns it into cycles
GAPS_US = (0, 20, 100, 500)
CYCLES_PER_US = 1980


def interleaved(group, reps: int = 20) -> dict:
    """ms an iteration of ``reps`` iterations of (a kernel busy for a gap,
    then an fp32 all-reduce at decode size) captured in one CUDA graph,
    for each gap of ``GAPS_US``, and of the gaps alone: how the ranks'
    time-sliced contexts pass the card between them when work sits
    between the calls."""
    import torch
    from distil_whisper_tpu_torch.parallel import device_comm as DC
    x = torch.randn(c.MC_DECODE_ROWS, device="cuda")
    out = {}
    for gap in GAPS_US:
        cycles = gap * CYCLES_PER_US

        def busy():
            if cycles:
                torch.cuda._sleep(cycles)

        def step():
            busy()
            DC.all_reduce(x, "sum", group)
        out[str(gap)] = {"gap_alone_ms": c.cuda_graph_ms(busy, reps=reps),
                         "ms": c.cuda_graph_ms(step, reps=reps)}
    return out


def engine_variants(mesh, blocks: int = 4) -> dict:
    """Wall ms a block of a meshed continuous engine (distil-large-v3's
    decoder at full width over a 2-layer encoder, random bf16 weights, 16
    lanes, block 16, budget 96), graphed and eager; the graphed one
    without the block's gather of the packed vector over the host's
    collectives, without the bounded host wait before its read, and
    replayed on the owner's stream (with the caller's stream queued behind
    it, or the host waiting first): what the graphed block waits on when
    ranks share a card."""
    import numpy as np
    import torch
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.parallel import device_comm
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    from distil_whisper_tpu_torch.serving_engine import \
        ContinuousBatchingEngine
    cfg = PRESETS["distil-large-v3"].replace(encoder_layers=2)
    full = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        tok = c.synthetic_tokenizer(Path(tmp))
    pipe = WhisperPipeline(None, dtype=torch.bfloat16, batch_size=16,
                           max_new_tokens=96, params=full, cfg=cfg,
                           tokenizer=tok, device="cuda", mesh=mesh)
    mels = compute_mel(np.stack(c.synthetic_audio(16, 30.0, seed=21)),
                       pipe.cfg, device="cuda").to(torch.bfloat16)
    prompt = tok.prompt_ids(language="en")
    out = {}
    wait = device_comm.wait_device

    def on_owner_stream(synced):
        """The graphed block replayed on the owner's stream with the
        caller's stream queued behind it (``synced``: the host waiting for
        the block there first)."""
        def patch(eng):
            def step(sampling=False, gamma=None):
                graph, packed = eng._blocks[bool(sampling)]
                with eng.graphs.side(eng.device) as stream:
                    graph.replay()
                    if synced:
                        stream.synchronize()
                return packed.clone()
            return step
        return patch

    for name, graphed, gather, bounded, patch in (
            ("graph", True, True, True, None),
            ("eager", False, True, True, None),
            ("graph_no_gather", True, False, True, None),
            ("graph_unbounded_read", True, True, False, None),
            ("graph_on_owner_stream", True, True, True,
             on_owner_stream(False)),
            ("graph_on_owner_stream_synced", True, True, True,
             on_owner_stream(True))):
        eng = ContinuousBatchingEngine(pipe, lanes=16, block_steps=16,
                                       max_new_tokens=96)
        eng.graphed = graphed
        eng.init_state()
        eng._gather = gather
        if patch is not None:
            eng.step = patch(eng)
        device_comm.wait_device = wait if bounded else (lambda device: None)
        try:
            out[name] = c.engine_block_timing(eng, mels, prompt, False,
                                              blocks)
        finally:
            device_comm.wait_device = wait
        del eng
    return out


def rank_main(rank: int, world: int, port: int, spec: dict) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                     generate, generate_eager)
    from distil_whisper_tpu_torch.generation import beam as B
    from distil_whisper_tpu_torch.generation import graphs as G
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models.whisper import encode
    from distil_whisper_tpu_torch.parallel import (device_comm, make_mesh,
                                                   maybe_initialize_distributed)
    from distil_whisper_tpu_torch.parallel.mesh import model_group, shard_params
    maybe_initialize_distributed(force=True)
    mesh = make_mesh((1, world))
    report = {"rank": rank, "world": world, "backend": dist.get_backend()}
    t0 = time.perf_counter()
    report["rows"] = c.mesh_collective_rows(model_group(mesh))
    report["rows_s"] = time.perf_counter() - t0
    report["interleaved"] = interleaved(model_group(mesh))
    report["engine"] = engine_variants(mesh)

    # a small fp32 model sharded over the mesh: graphs against the plain
    # loops, bit for bit
    cfg = PRESETS["test-tiny"].replace(d_model=128, encoder_attention_heads=4,
                                       decoder_attention_heads=4)
    full = init_params(cfg, seed=3, device="cuda")
    tree = shard_params(full, mesh, cfg=cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mel = torch.randn((4, cfg.num_mel_bins, 3000), generator=gen,
                      device="cuda")
    enc = encode(tree["encoder"], cfg, mel)
    prompt = torch.full((4, 1), cfg.decoder_start_token_id, device="cuda")
    opts = GenerationOptions(max_new_tokens=24)
    owner = G.GraphOwner("probe")
    before = G.read_stats()
    t0 = time.perf_counter()
    graph = generate(tree["decoder"], cfg, enc, prompt, opts, graphs=owner)
    torch.cuda.synchronize()
    report["generate_graph_s"] = time.perf_counter() - t0
    plain = generate_eager(tree["decoder"], cfg, enc, prompt, opts)
    report["generate_equal"] = all(torch.equal(a, b)
                                   for a, b in zip(graph, plain))
    one = generate(full["decoder"], cfg, encode(full["encoder"], cfg, mel),
                   prompt, opts, graphs=G.GraphOwner("one"))
    report["generate_tokens_equal_one_rank"] = bool(
        torch.equal(graph.sequences, one.sequences))
    beam = B.beam_search(tree["decoder"], cfg, enc, prompt, opts,
                         num_beams=2, graphs=owner)
    beam_plain = B.beam_search_eager(tree["decoder"], cfg, enc, prompt, opts,
                                     num_beams=2)
    report["beam_equal"] = all(torch.equal(a, b)
                               for a, b in zip(beam, beam_plain))
    after = G.read_stats()
    report["captures"] = after["captures"] - before["captures"]
    report["collective_launches"] = {
        m: f.launches for m, f in device_comm.COUNTERS.items()}
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    from distil_whisper_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 2),
                      "ptxas": c.ptxas_report("mesh_collective")}),
          flush=True)
    world = max(2, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        ranks = c.run_ranks(world, {"out": tmp}, rank_main)
    bad = c.check_mesh_collective_rows(ranks[0]["rows"])
    for r in ranks:
        print(json.dumps(r), flush=True)
        if not (r["generate_equal"] and r["beam_equal"]):
            bad.append(f"rank {r['rank']}: graphs part from the plain loops")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(ranks))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": not bad, "bad": bad}), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
