"""Transcription server of the port: ``POST /v1/transcribe`` over HTTP.

Counterpart of ``distil_whisper_tpu.cli.run_server``, with the same
arguments and ``--device`` (default ``cuda``).  Two schedulers:

* ``--scheduler microbatch`` (default): concurrent single requests are
  drained into one batch of up to ``--batch_size`` 30 s windows
  (``serving.py``);
* ``--scheduler continuous``: in-flight batching (``serving_engine.py``) —
  ``--batch_size`` decode lanes run at per-lane cursors, and finished lanes
  are refilled between step blocks instead of waiting for the whole batch.

Long files: the microbatch scheduler runs the whole-file chunked pipeline;
the continuous scheduler cuts them into strided windows that share lanes
with short requests.  Speculative decoding (``--assistant_checkpoint``, or
draft-free ``--ngram_speculative``) on both schedulers is token-identical to
greedy; on the continuous scheduler the accept/verify loop runs per lane.
Sampling (``temperature=T&top_k=K&seed=S``) rides sampled lanes next to
greedy ones on the continuous scheduler.

    python -m distil_whisper_tpu_torch.cli.run_server \\
        --model_checkpoint ./distil-large-v3 --port 8000 \\
        --scheduler continuous

    curl -s -X POST --data-binary @audio.wav \\
        'localhost:8000/v1/transcribe?language=en&timestamps=1&max_tokens=64'

Several GPUs (``--distributed`` under ``torchrun``, one process a GPU):
the job's ranks form a ``(world / N, N)`` mesh for ``--model_parallel N``,
the model (and an ``--assistant_checkpoint`` draft) is sharded over its
model axis, and the scheduler's lanes or micro-batch rows are split over
its data axis.  Rank 0 binds the port and leads; the other ranks replay
its device calls (``parallel/lockstep.py``) until it stops.

    torchrun --nproc_per_node 4 -m distil_whisper_tpu_torch.cli.run_server \
        --model_checkpoint ./distil-large-v3 --scheduler continuous \
        --distributed --model_parallel 2
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..models import load_params
from ..pipeline import WhisperPipeline
from ..serving import BatchingTranscriber, make_http_server
from ..serving_engine import ContinuousTranscriber
from .common import setup_data_parallel, setup_logging

logger = logging.getLogger("distil_whisper_tpu_torch")


def build_server(argv=None):
    """Parse args, build (http_server, transcriber) — separated from main()
    so tests can bind port 0 and drive the server in-process.  Under
    ``--distributed`` only the leader (rank 0) gets a server and a started
    transcriber; the other ranks get ``(None, transcriber)`` to
    ``follow()``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=8,
                   help="max requests per micro-batch (microbatch) or decode "
                        "lanes (continuous)")
    p.add_argument("--max_wait_ms", type=float, default=50.0,
                   help="batching window: how long the worker waits to fill "
                        "a batch after the first request arrives "
                        "(microbatch scheduler only)")
    p.add_argument("--scheduler", default="microbatch",
                   choices=["microbatch", "continuous"],
                   help="'microbatch' drains concurrent requests into "
                        "whole-batch decodes; 'continuous' keeps "
                        "--batch_size decode lanes running and refills "
                        "finished lanes between step blocks")
    p.add_argument("--block_steps", type=int, default=16,
                   help="decode steps per engine block (continuous "
                        "scheduler)")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--assistant_checkpoint", default=None,
                   help="draft checkpoint for speculative decoding: the "
                        "draft proposes --gamma tokens, the served model "
                        "verifies — token-identical to plain greedy")
    p.add_argument("--gamma", type=int, default=5,
                   help="draft tokens per speculative round")
    p.add_argument("--ngram_speculative", action="store_true",
                   help="prompt-lookup decoding (draft-free speculation): "
                        "proposals are copied from repeated n-grams in the "
                        "sequence decoded so far; token-identical to greedy")
    p.add_argument("--max_ngram", type=int, default=3,
                   help="longest n-gram to match for --ngram_speculative")
    p.add_argument("--adaptive_gamma", action="store_true",
                   help="walk the draft length over {gamma/2, gamma, "
                        "2*gamma} toward the cost-optimal rung for the "
                        "measured per-draft acceptance (token-identical at "
                        "every gamma)")
    p.add_argument("--draft_cost", type=float, default=None,
                   help="draft/teacher per-token decode cost ratio for the "
                        "adaptive-gamma rung picker (default: decoder "
                        "layer-count ratio; 0 for --ngram_speculative)")
    p.add_argument("--max_body_mb", type=float, default=100.0,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--max_queue", type=int, default=None,
                   help="backlog bound (waiting requests / 30 s windows); "
                        "beyond it new requests are shed with 503 + "
                        "Retry-After (default: 8x batch_size)")
    p.add_argument("--language", default=None,
                   help="default language (else per-request/auto-detect)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quantize_encoder", action="store_true")
    p.add_argument("--quantize_decoder", action="store_true")
    p.add_argument("--quantize_self_kv", action="store_true")
    p.add_argument("--quantize_cross_kv", action="store_true")
    p.add_argument("--quantize_lm_head", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda or cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="serve from a multi-GPU job under torchrun (one "
                        "process a GPU): rank 0 binds the port, the others "
                        "follow; fails fast unless the job has several "
                        "ranks")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallelism: ranks a model group (the "
                        "mesh's model axis); the rest of the world size is "
                        "the data axis, over which the lanes are split")
    args = p.parse_args(argv)
    if args.ngram_speculative and args.assistant_checkpoint:
        p.error("--ngram_speculative and --assistant_checkpoint are "
                "mutually exclusive (pick one speculation method)")
    if (args.scheduler == "microbatch" and args.adaptive_gamma
            and not (args.assistant_checkpoint or args.ngram_speculative)):
        p.error("--adaptive_gamma requires a speculation method "
                "(--assistant_checkpoint or --ngram_speculative)")
    setup_logging()
    mesh = setup_data_parallel(args.distributed, args.device,
                               args.model_parallel)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params, cfg = load_params(args.model_checkpoint, dtype=dtype,
                              device=args.device)
    cfg = cfg.replace(
        quantize_encoder=args.quantize_encoder,
        quantize_decoder=args.quantize_decoder,
        quantize_self_kv=args.quantize_self_kv,
        quantize_cross_kv=args.quantize_cross_kv,
        quantize_lm_head=args.quantize_lm_head)
    pipe = WhisperPipeline(args.model_checkpoint, dtype=dtype,
                           batch_size=args.batch_size,
                           max_new_tokens=args.max_new_tokens,
                           params=params, cfg=cfg, device=args.device,
                           mesh=mesh)
    # the raw (params, cfg) pair: the transcribers prepare the draft
    # (speculative.prepare_assistant), as the pipeline does
    assistant = (load_params(args.assistant_checkpoint, dtype=dtype,
                             device=args.device)
                 if args.assistant_checkpoint else None)
    common = dict(batch_size=args.batch_size,
                  default_language=args.language,
                  max_new_tokens=args.max_new_tokens,
                  max_queue=args.max_queue,
                  assistant=assistant, gamma=args.gamma,
                  adaptive_gamma=args.adaptive_gamma,
                  ngram_speculative=args.ngram_speculative,
                  max_ngram=args.max_ngram, draft_cost=args.draft_cost)
    if args.scheduler == "continuous":
        transcriber = ContinuousTranscriber(
            pipe, block_steps=args.block_steps, **common)
    else:
        transcriber = BatchingTranscriber(
            pipe, max_wait_ms=args.max_wait_ms, **common)
    if not transcriber.leader:
        return None, transcriber
    transcriber.start()
    httpd = make_http_server(transcriber, args.host, args.port,
                             max_body_mb=args.max_body_mb)
    return httpd, transcriber


def main(argv=None) -> None:
    httpd, transcriber = build_server(argv)
    if httpd is None:
        transcriber.follow()        # a follower rank, until the leader stops
        return
    host, port = httpd.server_address[:2]
    logger.info("serving on http://%s:%d (POST /v1/transcribe, "
                "GET /healthz, GET /v1/stats); scheduler=%s batch_size=%d "
                "max_queue=%d", host, port, type(transcriber).__name__,
                transcriber.batch_size, transcriber.max_queue)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        transcriber.stop()


if __name__ == "__main__":
    main()
