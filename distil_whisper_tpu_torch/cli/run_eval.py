"""Evaluation harness of the port: three inference modes + WER / RTFx /
hallucination stats.

The counterpart of ``distil_whisper_tpu.cli.run_eval``, with its arguments
and output keys, on one GPU (``--device``, default ``cuda``):

* ``short``       — batched 30 s generate (greedy, or beam with
  ``--num_beams``)
* ``sequential``  — OpenAI-style long-form with the temperature-fallback
  ladder (chosen automatically when any input exceeds 30 s)
* ``chunked``     — strided-chunk pipeline with timestamp/LCS merge

* ``speculative`` — speculative greedy decoding of 30 s windows: a draft
  model (``--assistant_checkpoint``) or draft-free n-gram lookup
  (``--speculative_method ngram``) proposes ``--gamma`` tokens a round and
  the model verifies them; the tokens are greedy decoding's

The sequential and chunked modes speculate too with
``--assistant_checkpoint`` or ``--speculative_method ngram`` (sequential at
its temperature-0 rung).  ``--distributed`` (under ``torchrun``, one rank
a GPU) evaluates a contiguous shard of the dataset on each rank and sums
the error counts (and repeated 5-grams) over the ranks, so every rank
reports the same WER; ``--output_json`` gets a ``-{rank}`` suffix.

Metrics: WER (+I/S/D splits), RTFx = audio-time / transcription-time,
tokens/s, and the hallucination stats IER/SER/DER + repeated 5-grams.

    python -m distil_whisper_tpu_torch.cli.run_eval \
        --model_checkpoint ./distil-large-v3 --dataset_path ./test.jsonl \
        --mode short --language en
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..audio import compute_mel
from ..audio.io import load_audio
from ..device import resolve_device
from ..generation import (GenerationOptions, SequentialOptions,
                          SequentialTranscriber, encode_and_beam_search,
                          encode_and_generate, generate)
from ..generation.graphs import GraphOwner
from ..metrics import WordErrors, count_repeated_ngrams, process_words
from ..models import load_params
from ..models.whisper import encode
from ..parallel.multihost import rank, world_size
from ..pipeline import WhisperPipeline
from ..tokenizer import (BasicTextNormalizer, EnglishTextNormalizer,
                         WhisperTokenizer)
from .common import (add_noise_at_snr, batched, load_dataset_any, logger,
                     parse_args_with_json, rank_suffix, setup_data_parallel,
                     setup_logging, shard_rows, summed_word_errors)

QUANTIZE_FLAGS = ("quantize_cross_kv", "quantize_encoder", "quantize_decoder",
                  "quantize_self_kv", "quantize_lm_head")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_checkpoint", required=True)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--split", default=None)
    p.add_argument("--mode", default="short",
                   choices=["short", "sequential", "chunked", "speculative"])
    p.add_argument("--assistant_checkpoint", default=None)
    p.add_argument("--language", default=None)
    p.add_argument("--task", default="transcribe")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--chunk_length_s", type=float, default=25.0)
    p.add_argument("--return_timestamps", action="store_true")
    # sequential long-form knobs (defaults = the published eval defaults)
    p.add_argument("--temperature_fallback",
                   default="0.0,0.2,0.4,0.6,0.8,1.0",
                   help="comma-separated fallback temperature ladder")
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--no_speech_threshold", type=float, default=0.6)
    p.add_argument("--compression_ratio_threshold", type=float, default=1.35)
    p.add_argument("--condition_on_prev", action="store_true",
                   help="condition each window on the previous output")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--output_json", default=None)
    p.add_argument("--gamma", type=int, default=5,
                   help="draft tokens per speculative round")
    p.add_argument("--speculative_method", default="draft",
                   choices=["draft", "ngram"],
                   help="draft = assistant-model proposals (needs "
                        "--assistant_checkpoint); ngram = draft-free prompt "
                        "lookup, proposals copied from the most recent "
                        "repeat of the last n-gram")
    p.add_argument("--max_ngram", type=int, default=3,
                   help="longest n-gram to match for --speculative_method "
                        "ngram (tried max..1, longest match wins)")
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--noise_snr_db", type=float, default=None,
                   help="mix white noise at this SNR (noise evaluation)")
    p.add_argument("--quantize_cross_kv", action="store_true",
                   help="int8 cross-attention K/V")
    p.add_argument("--quantize_encoder", action="store_true",
                   help="W8A8 int8 encoder matmuls (the int8 MLP kernel)")
    p.add_argument("--quantize_decoder", action="store_true",
                   help="W8A8 int8 decoder projections")
    p.add_argument("--quantize_self_kv", action="store_true",
                   help="int8 decoder self-attention cache")
    p.add_argument("--quantize_lm_head", action="store_true",
                   help="int8 logits against an int8 copy of the tied "
                        "embedding")
    p.add_argument("--precise_tok_per_s", action="store_true",
                   help="fixed-token benchmark on random encoder outputs "
                        "(decouples tokens/s from WER)")
    p.add_argument("--prompt_text", default=None,
                   help="condition generation on this text via "
                        "<|startofprev|> prompt ids")
    p.add_argument("--distributed", action="store_true",
                   help="one process a GPU under torchrun, each on its "
                        "shard of the dataset, the error counts summed; "
                        "fails fast unless the job has several ranks")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return parse_args_with_json(p, argv)


def seq_options_from_args(args) -> SequentialOptions:
    """CLI flags -> SequentialOptions."""
    return SequentialOptions(
        temperatures=tuple(float(t) for t in
                           args.temperature_fallback.split(",")),
        logprob_threshold=args.logprob_threshold,
        no_speech_threshold=args.no_speech_threshold,
        compression_ratio_threshold=args.compression_ratio_threshold,
        condition_on_prev_tokens=args.condition_on_prev,
        max_new_tokens=args.max_new_tokens,
        num_beams=args.num_beams)


def _speculation(args, dtype, device):
    """``(speculative_method, assistant)`` of the flags, with JAX's
    argument errors: ``--speculative_method ngram`` is draft-free, and the
    draft method speculates when ``--assistant_checkpoint`` is given (in
    ``--mode speculative`` it must be).  Speculation verifies greedy
    tokens, so ``--mode speculative`` refuses ``--num_beams``."""
    if args.mode == "speculative" and args.num_beams > 1:
        raise ValueError("--mode speculative decodes greedily; drop "
                         "--num_beams")
    if args.speculative_method == "ngram":
        if args.assistant_checkpoint:
            raise ValueError(
                "--speculative_method ngram is draft-free; drop "
                "--assistant_checkpoint (or use --speculative_method "
                "draft to use it)")
        return "ngram", None
    if args.assistant_checkpoint:
        return "draft", load_params(args.assistant_checkpoint, dtype=dtype,
                                    device=device)
    if args.mode == "speculative":
        raise ValueError("--mode speculative with --speculative_method draft "
                         "requires --assistant_checkpoint")
    return None, None


def _precise_tok_per_s(args, pipe, dtype, device):
    """Fixed-token generation against random encoder states."""
    cfg, params = pipe.cfg, pipe.params
    opts = GenerationOptions.from_config(
        cfg, max_new_tokens=args.max_new_tokens,
        min_new_tokens=args.max_new_tokens)
    rng0 = np.random.default_rng(0)
    enc = torch.as_tensor(rng0.standard_normal(
        (args.batch_size, cfg.max_source_positions, cfg.d_model)),
        dtype=dtype, device=device)
    prompt = torch.full((args.batch_size, 1), cfg.decoder_start_token_id,
                        dtype=torch.long, device=device)

    graphs = GraphOwner("precise_tok_per_s")

    def fixed():
        out = generate(params["decoder"], cfg, enc, prompt, opts,
                       dtype=dtype, graphs=graphs)
        out.seq_len.cpu()

    with torch.no_grad():
        fixed()                                    # warm-up
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            fixed()
        dt = (time.perf_counter() - t0) / iters
    toks = args.batch_size * args.max_new_tokens
    return {"mode": "precise_tok_per_s",
            "tokens_per_second": round(toks / dt, 2),
            "batch_size": args.batch_size, "tokens": args.max_new_tokens}


def _short(args, pipe, audios, dtype, device):
    """Batched 30 s windows through generate, beam search or, in ``--mode
    speculative``, the pipeline's speculation: (hypotheses, generated token
    count)."""
    tok, cfg, params = pipe.tokenizer, pipe.cfg, pipe.params
    prefix = ([tok.sot_prev] + tok.encode(" " + args.prompt_text.strip())
              if args.prompt_text else [])
    opts = GenerationOptions.from_config(
        cfg, max_new_tokens=args.max_new_tokens,
        return_timestamps=args.return_timestamps,
        no_speech_token_id=tok.no_speech)
    detect = args.language is None and len(tok.lang_to_id) > 1
    hyps, n_tokens = [], 0
    for group in batched(audios, args.batch_size):
        wavs = np.zeros((len(group), cfg.n_samples), np.float32)
        for j, a in enumerate(group):
            w = a[:cfg.n_samples]
            wavs[j, :len(w)] = w
        mels = compute_mel(wavs, cfg, device=device).to(dtype)
        languages = (pipe.detect_language(mels) if detect
                     else [args.language] * len(group))
        prompts = [prefix + tok.prompt_ids(
            language=lang, task=args.task,
            no_timestamps=not args.return_timestamps) for lang in languages]
        if args.num_beams > 1:
            out = encode_and_beam_search(params, cfg, mels, prompts, opts,
                                         num_beams=args.num_beams,
                                         dtype=dtype, device=device,
                                         graphs=pipe.graphs)
        elif pipe.speculative_method:
            # through the pipeline's graphs: a timed batch of a shape seen
            # before replays its program
            with torch.no_grad():
                enc = encode(params["encoder"], cfg, mels, dtype=dtype)
                out = pipe.speculate(mels, enc,
                                     torch.tensor(prompts, device=device),
                                     opts)
        else:
            out = encode_and_generate(params, cfg, mels, prompts, opts,
                                      dtype=dtype, device=device,
                                      graphs=pipe.graphs)
        seqs, lens = out.sequences.cpu().numpy(), out.seq_len.cpu().numpy()
        for j in range(len(group)):
            ids = seqs[j][:lens[j]].tolist()
            plen = len(prompts[j])
            n_tokens += max(len(ids) - plen, 0)
            # slice the prompt off before decoding: --prompt_text tokens are
            # ordinary text tokens and must not leak into the hypothesis
            hyps.append(tok.decode(ids[plen:]))
    return hyps, n_tokens


def _sequential(args, pipe, audios, dtype, device, method, assistant):
    tok = pipe.tokenizer
    tr = SequentialTranscriber(
        pipe.params, pipe.cfg, tok, seq_options_from_args(args),
        language=args.language, task=args.task, batch_size=args.batch_size,
        dtype=dtype, speculative_method=method, assistant=assistant,
        gamma=args.gamma, max_ngram=args.max_ngram, device=device)
    # whole-file features on the device (the mel kernel on the card)
    feats = [compute_mel(a, pipe.cfg, pad_to_chunk=False, device=device)[0]
             for a in audios]
    init_prompt = None
    if args.prompt_text:
        if not args.condition_on_prev:
            raise SystemExit("--prompt_text in sequential mode requires "
                             "--condition_on_prev (the prompt layout "
                             "reserves the context budget only then)")
        init_prompt = tok.encode(" " + args.prompt_text.strip())
    results = tr.transcribe(feats, initial_prompt_tokens=init_prompt)
    hyps = [r["text"] for r in results]
    n_tokens = sum(len(s["tokens"]) for r in results for s in r["segments"])
    if tr.spec_stats["drafted"]:
        logger.info("sequential speculative acceptance rate: %.1f%% "
                    "(%d rounds)",
                    100 * tr.spec_stats["accepted"] / tr.spec_stats["drafted"],
                    tr.spec_stats["rounds"])
    return hyps, n_tokens


def _chunked(args, pipe, audios):
    gk = {"num_beams": args.num_beams} if args.num_beams > 1 else None
    hyps = []
    for a in audios:
        out = pipe(a, chunk_length_s=args.chunk_length_s,
                   language=args.language, task=args.task,
                   return_timestamps=True, generate_kwargs=gk)
        hyps.append(out["text"])
    return hyps, 0


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    distributed = setup_data_parallel(args.distributed,
                                      args.device) is not None
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    params, cfg = load_params(args.model_checkpoint, dtype=dtype,
                              device=device)
    cfg = cfg.replace(**{f: True for f in QUANTIZE_FLAGS if getattr(args, f)})
    tok = WhisperTokenizer.from_pretrained(args.model_checkpoint)
    method, assistant = _speculation(args, dtype, device)
    # the pipeline quantizes the weights once (cfg.quantize_*) and sets the
    # bf16 kernel flags; every mode runs its params and cfg, and the chunked
    # and speculative modes its speculation
    pipe_spec = args.mode in ("chunked", "speculative")
    pipe = WhisperPipeline(args.model_checkpoint, dtype=dtype,
                           batch_size=args.batch_size,
                           max_new_tokens=args.max_new_tokens, params=params,
                           cfg=cfg, tokenizer=tok,
                           speculative_method=method if pipe_spec else None,
                           assistant=assistant if pipe_spec else None,
                           gamma=args.gamma, max_ngram=args.max_ngram,
                           device=device)
    normalizer = (EnglishTextNormalizer(tok.spelling_mapping)
                  if args.language in (None, "en", "english")
                  else BasicTextNormalizer())

    ds = load_dataset_any(args.dataset_path, args.split)
    if distributed:
        ds = shard_rows(ds, world_size(), rank())
    audios, texts = [], []
    noise_rng = np.random.default_rng(0)
    for row in ds:
        a = load_audio(row["audio"], cfg.sampling_rate)
        if args.noise_snr_db is not None:
            a = add_noise_at_snr(a, args.noise_snr_db, noise_rng)
        audios.append(a)
        texts.append(row.get("text", ""))
    audio_seconds = sum(len(a) for a in audios) / cfg.sampling_rate
    # sequential long-form when any input exceeds one 30 s window
    if args.mode == "short" and any(len(a) > cfg.n_samples for a in audios):
        logger.info("inputs exceed 30 s: auto-enabling sequential long-form")
        args.mode = "sequential"
    logger.info("%d samples, %.1f audio-s, mode=%s, device=%s", len(audios),
                audio_seconds, args.mode, device)

    if args.precise_tok_per_s:
        result = _precise_tok_per_s(args, pipe, dtype, device)
        print(json.dumps(result))
        return result

    t0 = time.perf_counter()
    if args.mode == "sequential":
        hyps, n_tokens = _sequential(args, pipe, audios, dtype, device,
                                     method, assistant)
    elif args.mode in ("short", "speculative"):
        hyps, n_tokens = _short(args, pipe, audios, dtype, device)
    else:
        hyps, n_tokens = _chunked(args, pipe, audios)
    if pipe.spec_stats["drafted"]:
        logger.info("%sspeculative acceptance rate: %.1f%%",
                    "chunked " if args.mode == "chunked" else "",
                    100 * pipe.spec_stats["accepted"]
                    / pipe.spec_stats["drafted"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    result = {"mode": args.mode, "num_samples": len(audios),
              "audio_seconds": round(audio_seconds, 2),
              "transcription_seconds": round(wall, 2),
              "rtfx": round(audio_seconds / wall, 2),
              "tokens_per_second": round(n_tokens / wall, 2)}

    refs_n = [normalizer(t) for t in texts]
    hyps_n = [normalizer(h) for h in hyps]
    pairs = [(r, h) for r, h in zip(refs_n, hyps_n) if r.strip()]
    stats = (process_words([r for r, _ in pairs], [h for _, h in pairs])
             if pairs else WordErrors())
    rep5 = sum(count_repeated_ngrams(h, 5) for h in hyps_n)
    if distributed:
        # summed over the ranks' shards, every rank in the collective
        stats, rep5 = summed_word_errors(stats, rep5)
    if stats.num_ref_words:
        result.update({
            "wer": round(100 * stats.wer, 4),
            "ier": round(100 * stats.ier, 4),
            "ser": round(100 * stats.ser, 4),
            "der": round(100 * stats.der, 4),
            "repeated_5grams": rep5,
        })

    logger.info("results: %s", json.dumps(result))
    print(json.dumps(result))
    if args.output_json:
        out_path = Path(args.output_json)
        # a file a rank: predictions are the rank's own
        out_path = out_path.with_name(
            f"{out_path.stem}{rank_suffix()}{out_path.suffix}")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({**result, "predictions": hyps, "references": texts},
                      f, indent=2)
    return result


if __name__ == "__main__":
    main()
