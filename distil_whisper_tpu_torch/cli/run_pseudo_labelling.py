"""Pseudo-labelling: large-batch teacher transcription of a training corpus,
on one GPU or several (one process a GPU).

The port of ``distil_whisper_tpu.cli.run_pseudo_labelling`` with its flags
and defaults: speaker-aware 30 s audio packing with ``condition_on_prev``
tracking (reference run_pseudo_labelling.py:632-673), batched teacher
generation (greedy, or beam search with ``--num_beams``), the five
``--quantize_*`` flags, incremental CSV dumps (:887-925) and their
publication (``--publish_dir`` / ``--push_to_hub``), WER against the ground
truth, and the labelled dataset with the ``whisper_transcript`` column and
<|startofprev|> prompt ids (:971-996).

The corpus streams: rows are loaded and packed lazily, by a producer thread
or by ``--featurizer_workers`` subprocesses, and each batch is uploaded as
int16 PCM with its log-mel computed on the device (the mel kernel), while
the main thread generates and writes.  Runs on the GPU unless ``--device
cpu``.  ``--distributed`` (under ``torchrun``): labelling is embarrassingly
parallel, so each rank labels a contiguous shard of the (speaker-sorted)
corpus with its own replica and writes its own files,
``transcriptions-{rank}.csv``, ``dataset-{rank}.jsonl``, ``audio-{rank}/``
and ``pl_stats-{rank}.json``; only the WER counts are summed over the
ranks.  ``load_dataset_any`` reads the output directory's per-rank
manifests in rank order.

The one difference of output from the JAX package: the labelled dataset is
a JSONL manifest, ``<output_dir>/dataset.jsonl``, one row a packed sample
(``audio``, the path of its audio as a 32-bit float WAV under
``<output_dir>/audio/``, bit for bit the samples JAX stores; ``text``;
``whisper_transcript``; ``condition_on_prev``, a list of ids or null), not
an Arrow dataset, so that neither writing nor reading it needs the
``datasets`` package.  ``load_dataset_any`` and ``run_distillation`` read
it.  ``main`` returns the manifest's path.  The run's counts (rows,
batches, audio seconds, generated tokens, the steady-state RTFx, the WER
counts) go to ``<output_dir>/pl_stats.json``.

    python -m distil_whisper_tpu_torch.cli.run_pseudo_labelling \\
        --model_checkpoint /ckpts/whisper-large-v3 \\
        --dataset_path ./train.jsonl --output_dir ./pl_out \\
        --language en --per_device_batch_size 64
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..audio import compute_mel
from ..audio.io import load_audio, write_wav
from ..device import resolve_device
from ..generation import GenerateOutput, GenerationOptions, build_generate
from ..generation.beam import BeamOutput, encode_and_beam_search
from ..generation.graphs import GraphOwner
from ..metrics import WordErrors, process_words
from ..models import load_params
from ..ops.quant import maybe_quantize_encoder
from ..parallel.multihost import rank, world_size
from ..tokenizer import (BasicTextNormalizer, EnglishTextNormalizer,
                         WhisperTokenizer)
from ..training.data import pack_samples_iter, prev_prompt_from_output
from ..training.data_stream import Prefetcher
from ..utils.publish import make_publisher
from .common import (load_dataset_any, logger, rank_suffix,
                     setup_data_parallel, setup_logging, shard_rows,
                     sort_rows, summed_word_errors)

QUANTIZE_FLAGS = ("quantize_cross_kv", "quantize_self_kv", "quantize_encoder",
                  "quantize_decoder", "quantize_lm_head")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--split", default=None)
    p.add_argument("--per_device_batch_size", type=int, default=16)
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--return_timestamps", action="store_true", default=True)
    p.add_argument("--no_timestamps", dest="return_timestamps",
                   action="store_false")
    p.add_argument("--concatenate_audio", action="store_true", default=True)
    p.add_argument("--no_concatenate_audio", dest="concatenate_audio",
                   action="store_false")
    p.add_argument("--audio_column_name", default="audio")
    p.add_argument("--text_column_name", default="text")
    p.add_argument("--speaker_id_column_name", default=None)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--compute_wer", action="store_true", default=False,
                   help="WER of the pseudo-labels vs the text column (host "
                        "work that competes with feature preparation; the "
                        "reference computes it for val/test splits only)")
    p.add_argument("--quantize_cross_kv", action="store_true",
                   help="int8 cross-attention K/V")
    p.add_argument("--quantize_encoder", action="store_true",
                   help="W8A8 int8 encoder projections and MLP (the int8 MLP "
                        "kernel)")
    p.add_argument("--quantize_decoder", action="store_true",
                   help="W8A8 int8 decoder projections")
    p.add_argument("--quantize_self_kv", action="store_true",
                   help="int8 decoder self-attention cache")
    p.add_argument("--quantize_lm_head", action="store_true",
                   help="int8 logits against an int8 copy of the tied "
                        "embedding")
    p.add_argument("--distributed", action="store_true",
                   help="one process a GPU under torchrun, each labelling "
                        "its contiguous shard into per-rank files; fails "
                        "fast unless the job has several ranks")
    p.add_argument("--publish_dir", default=None,
                   help="mirror artifacts (CSV flushes, the final dataset) "
                        "into this directory as the run progresses")
    p.add_argument("--push_to_hub", default=None, metavar="REPO_ID",
                   help="push incremental CSVs and the final dataset to "
                        "this Hub dataset repo (needs network access)")
    p.add_argument("--hub_token", default=None)
    p.add_argument("--featurizer_workers", type=int, default=0,
                   help="N subprocess featurizers (audio load, 30 s packing "
                        "and int16 conversion outside this process; the "
                        "dataset is sharded contiguously per worker, so "
                        "condition-on-prev chains break only at worker "
                        "boundaries).  0 = an in-process producer thread")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    distributed = setup_data_parallel(args.distributed,
                                      args.device) is not None
    host_shard = (rank(), world_size())
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params, cfg = load_params(args.model_checkpoint, dtype=dtype,
                              device=device)
    if dtype == torch.bfloat16:
        cfg = cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
    cfg = cfg.replace(**{f: True for f in QUANTIZE_FLAGS if getattr(args, f)})
    params = maybe_quantize_encoder(params, cfg)
    tok = WhisperTokenizer.from_pretrained(args.model_checkpoint)

    ds = load_dataset_any(args.dataset_path, args.split)
    if not isinstance(ds, list):
        # Arrow -> numpy for the audio column (no list of floats per row)
        ds = ds.with_format("numpy", columns=[args.audio_column_name],
                            output_all_columns=True)
    if args.concatenate_audio and args.speaker_id_column_name:
        ds = sort_rows(ds, args.speaker_id_column_name)
    if distributed:
        # contiguous shards keep same-speaker runs (and condition-on-prev
        # chains) within one rank
        ds = shard_rows(ds, host_shard[1], host_shard[0])

    def raw_rows():
        for row in ds:
            yield {
                "audio": load_audio(row[args.audio_column_name],
                                    cfg.sampling_rate),
                "text": row.get(args.text_column_name, ""),
                "speaker_id": row.get(args.speaker_id_column_name)
                if args.speaker_id_column_name else None,
            }

    if args.concatenate_audio:
        sample_iter = pack_samples_iter(raw_rows(),
                                        max_input_samples=cfg.n_samples)
    else:
        def sample_iter_fn():
            for s in raw_rows():
                s["condition_on_prev"] = 0
                yield s
        sample_iter = sample_iter_fn()

    prompt = tok.prompt_ids(language=args.language, task=args.task,
                            no_timestamps=not args.return_timestamps)
    opts = GenerationOptions.from_config(
        cfg, max_new_tokens=args.max_new_tokens,
        return_timestamps=args.return_timestamps,
        no_speech_token_id=tok.no_speech)
    bsz = max(args.per_device_batch_size, 1)
    # the teacher's decode (greedy or beams) as CUDA graphs on the card: a
    # short batch (a featurizer's tail) is padded to the full one with
    # copies of its last row, as JAX pads it, so that every batch replays
    # one program
    generate_fn = build_generate(cfg, opts, dtype=dtype, device=device)
    beam_graphs = GraphOwner("pseudo_labelling_beam")

    def gen_fn(mel):
        n = mel.shape[0]
        if n < bsz:
            mel = torch.cat([mel, mel[-1:].expand(bsz - n, *mel.shape[1:])])
        if args.num_beams > 1:
            out = encode_and_beam_search(params, cfg, mel, [prompt] * bsz,
                                         opts, num_beams=args.num_beams,
                                         dtype=dtype, device=device,
                                         graphs=beam_graphs)
            return BeamOutput(*(t[:n] for t in out))
        out = generate_fn(params, mel, [prompt] * bsz)
        return GenerateOutput(*(t[:n] for t in out))

    out_dir = Path(args.output_dir)
    suffix = rank_suffix()
    audio_dir = out_dir / f"audio{suffix}"
    audio_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f"transcriptions{suffix}.csv"
    csv_f = open(csv_path, "w", newline="")
    csv_w = csv.writer(csv_f)
    csv_w.writerow(["index", "whisper_transcript", "text"])
    manifest_path = out_dir / f"dataset{suffix}.jsonl"
    manifest_f = open(manifest_path, "w")
    publisher = make_publisher(publish_dir=args.publish_dir,
                               push_to_hub=args.push_to_hub,
                               hub_token=args.hub_token)

    def featurize(group, wav16):
        """A batch's int16 PCM [n, n_samples] -> its log-mel on the device
        (uploaded as int16: half the bytes of fp32, exact for 16-bit
        audio)."""
        dev = torch.from_numpy(wav16).to(device).float() / 32768.0
        return group, compute_mel(dev, cfg, device=device).to(dtype)

    def make_feature_batches():
        if args.featurizer_workers > 0:
            from ..training.pl_workers import worker_feature_batches
            spec = dict(dataset_path=args.dataset_path, split=args.split,
                        audio_col=args.audio_column_name,
                        text_col=args.text_column_name,
                        speaker_col=args.speaker_id_column_name,
                        concatenate=args.concatenate_audio,
                        sampling_rate=cfg.sampling_rate,
                        n_samples=cfg.n_samples, local_bsz=bsz,
                        host_shard=host_shard)
            for item in worker_feature_batches(spec, args.featurizer_workers):
                n = item["n"]
                group = [{
                    "audio": (item["wav16"][j, :item["lens"][j]]
                              .astype(np.float32) / 32768.0),
                    "text": item["texts"][j],
                    "condition_on_prev": item["cond"][j],
                    "worker": item["worker"],
                } for j in range(n)]
                yield featurize(group, item["wav16"][:n])
            return
        group = []
        for s in sample_iter:
            group.append(s)
            if len(group) == bsz:
                yield featurize(group, int16_batch(group, cfg.n_samples))
                group = []
        if group:
            yield featurize(group, int16_batch(group, cfg.n_samples))

    normalizer = (EnglishTextNormalizer({})
                  if args.language in (None, "en", "english")
                  else BasicTextNormalizer())
    wer_stats = WordErrors()
    n_samples = 0
    n_batches = 0
    gen_tokens = 0
    audio_seconds = 0.0
    gen_seconds = 0.0
    rated_audio_s = 0.0     # audio counted toward the steady-state rate
    last_consume = None
    # the previous row's generated ids, keyed by featurizer-worker stream
    # (batches of different workers interleave; each worker's rows stay in
    # order, so the condition-on-prev chain is per stream)
    prev_ids: dict = {}

    def consume(group, out, batch_audio_s):
        """Decode and write one finished batch.  The steady-state rate is
        measured batch end to batch end, the first batch (the kernels'
        build and first launches) excluded."""
        nonlocal n_samples, n_batches, gen_tokens, wer_stats, gen_seconds
        nonlocal rated_audio_s, last_consume
        seqs = out.sequences.cpu().numpy()
        lens = out.seq_len.cpu().numpy()
        n_batches += 1
        gen_tokens += int(lens.sum()) - len(prompt) * len(lens)
        now = time.perf_counter()
        if last_consume is not None:
            gen_seconds += now - last_consume
            rated_audio_s += batch_audio_s
        last_consume = now
        for j, s in enumerate(group):
            ids = seqs[j][:lens[j]].tolist()
            transcript = tok.decode(ids, skip_special_tokens=False,
                                    decode_with_timestamps=True)
            wid = s.get("worker", 0)
            prev = (prev_prompt_from_output(tok, prev_ids[wid])
                    if s.get("condition_on_prev") and wid in prev_ids
                    else None)
            wav = audio_dir / f"{n_samples:08d}.wav"
            write_wav(str(wav), s["audio"], cfg.sampling_rate, float32=True)
            manifest_f.write(json.dumps({
                "audio": str(wav.resolve()), "text": s["text"],
                "whisper_transcript": transcript,
                "condition_on_prev": prev}) + "\n")
            csv_w.writerow([n_samples, transcript, s["text"]])
            n_samples += 1
            prev_ids[wid] = ids
            if args.compute_wer and s["text"]:
                r = normalizer(s["text"])
                h = normalizer(tok.decode(tok.encode_transcript(transcript)))
                if r.strip():
                    wer_stats = wer_stats + process_words([r], [h])

    # The producer (thread or workers) prepares batch N+1 while batch N
    # generates here; rows are written in batch order, as in JAX
    t_loop = time.perf_counter()
    try:
        for step, (group, mels) in enumerate(Prefetcher(make_feature_batches,
                                                        depth=2)):
            batch_audio_s = (sum(len(g["audio"]) for g in group)
                             / cfg.sampling_rate)
            audio_seconds += batch_audio_s
            consume(group, gen_fn(mels), batch_audio_s)
            del mels
            if (step + 1) % args.logging_steps == 0:
                csv_f.flush()
                manifest_f.flush()
                if publisher is not None:
                    publisher.publish(out_dir, [csv_path],
                                      f"PL flush at step {step + 1} "
                                      f"({audio_seconds / 3600:.2f} audio-h)")
                wall_rate = audio_seconds / max(time.perf_counter() - t_loop,
                                                1e-9)
                logger.info("step %d: %.2f audio-h labelled, %.0f audio-h/h "
                            "(incl. the first batch)", step + 1,
                            audio_seconds / 3600, wall_rate)
    finally:
        csv_f.close()
        manifest_f.close()
    if distributed and args.compute_wer:
        # summed over the ranks' shards, every rank in the collective
        wer_stats = summed_word_errors(wer_stats)
    rtfx = rated_audio_s / max(gen_seconds, 1e-9)
    (out_dir / f"pl_stats{suffix}.json").write_text(json.dumps({
        "rows": n_samples, "batches": n_batches, "audio_s": audio_seconds,
        "generated_tokens": gen_tokens, "rtfx_steady_state": rtfx,
        "wer_counts": dataclasses.asdict(wer_stats)}))
    if publisher is not None:
        publisher.finalize(out_dir, f"PL complete: {n_samples} samples, "
                                    f"{audio_seconds / 3600:.2f} audio-h")
    if args.compute_wer and wer_stats.num_ref_words:
        logger.info("PL WER vs ground truth: %.2f%% (S=%d I=%d D=%d)",
                    100 * wer_stats.wer, wer_stats.substitutions,
                    wer_stats.insertions, wer_stats.deletions)
    logger.info("done: %d samples, %.1f audio-h, RTFx %.1f (%.0f audio-h/h "
                "steady-state, first batch excluded)",
                n_samples, audio_seconds / 3600, rtfx, rtfx)
    return str(manifest_path)


def int16_batch(group, n_samples: int) -> np.ndarray:
    """The group's audio as zero-padded int16 PCM [len(group), n_samples]."""
    wav16 = np.zeros((len(group), n_samples), np.int16)
    for j, g in enumerate(group):
        w = g["audio"][:n_samples]
        wav16[j, :len(w)] = np.clip(np.round(w * 32768.0), -32768, 32767)
    return wav16


if __name__ == "__main__":
    main()
