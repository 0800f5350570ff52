"""User-facing ASR pipeline: short-form + chunked long-form transcription.

Counterpart of ``distil_whisper_tpu.pipeline.WhisperPipeline``: audio ->
strided 30 s chunks (stride = chunk/6 by default) -> batched log-mel ->
encode + generate (greedy, sampling through ``generate_kwargs``, or beam
with ``num_beams``) -> timestamp/LCS merge of overlapping chunks
(``WhisperTokenizer.decode_asr``), or with ``return_timestamps="word"`` the
cross-attention DTW alignment of each window and a stride-trimmed word
list.  It runs on the card by default.

A list of audios is transcribed in shared batches of windows (every file's
chunks are batched together; rows are independent) and returns one result
per file.  JAX pads a ragged last batch to its compiled shape; PyTorch runs
the rows that exist.

With ``cfg.quantize_*`` set it runs the int8 lane: W8A8 encoder and
decoder projections, int8 self-KV cache and cross K/V, int8 logits.

``speculative_method`` ("draft" with ``assistant=(params, cfg)``, or
"ngram") decodes the greedy windows by speculation: token for token the
greedy output (segment timestamps included), so the chunk merge is
unchanged.  Beam search, word timestamps and sampled requests take their
plain paths.

``mesh`` (``parallel.make_mesh((dp, tp))``, JAX's ``mesh=``): every rank of
the job builds the pipeline and calls it with the same audio (SPMD).  The
parameters (and a draft's) are sharded over the 'model' axis, so that each
model group runs one tensor-parallel copy; each batch of windows is padded
to a multiple of the data axis (the last window repeated), each data rank
decodes its slice, and the tokens are gathered over the ranks, so every
rank returns the whole result (:func:`decode_over_data`).  Speculation
counters are the rank's own.  The serving schedulers drive a meshed
pipeline from one leader rank (``parallel/lockstep.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio import compute_mel
from .audio.io import load_audio
from .config import WhisperConfig
from .device import resolve_device
from .generation import GenerationOptions, beam_search, generate
from .generation.speculative import (check_method, prepare_assistant,
                                      speculate_windows)
from .generation.word_timestamps import (default_alignment_heads,
                                         load_alignment_heads,
                                         selected_cross_weights,
                                         token_timestamps_from_weights,
                                         words_from_tokens)
from .models import load_params
from .models.whisper import cross_kv, decode, encode, init_cache, kv_width
from .ops.quant import maybe_quantize_encoder
from .parallel.mesh import coordinates, shard_params
from .tokenizer import WhisperTokenizer


def decode_over_data(mesh, b: int, fn):
    """``fn(rows)`` (a tuple of host arrays with one row per index of
    ``rows``, or Nones) over ``range(b)``, the rows split over the mesh's
    data axis: padded to a multiple of it with the last row, each data
    rank running its slice, and the results gathered from every rank (a
    data rank's from the first rank of its model group, the model axis
    being the inner one) in row order.  Every rank calls it alike."""
    d, n_data, _, tp = coordinates(mesh)
    if n_data == 1:
        return fn(list(range(b)))
    from .parallel.multihost import gather_rows
    per = -(-b // n_data)
    pad = [b - 1] * (per * n_data - b)
    parts = fn((list(range(b)) + pad)[d * per:(d + 1) * per])
    return tuple(None if p is None else
                 gather_rows(p).reshape(n_data, tp, *p.shape)[:, 0]
                 .reshape(-1, *p.shape[1:])[:b] for p in parts)


class WhisperPipeline:
    """``pipeline = WhisperPipeline(ckpt_dir); pipeline(audio, chunk_length_s=30)``"""

    def __init__(self, checkpoint: Optional[str], dtype=torch.bfloat16,
                 batch_size: int = 8, max_new_tokens: int = 128,
                 params=None, cfg: Optional[WhisperConfig] = None,
                 tokenizer: Optional[WhisperTokenizer] = None,
                 speculative_method: Optional[str] = None, assistant=None,
                 gamma: int = 5, max_ngram: int = 3, device="cuda",
                 mesh=None):
        check_method(speculative_method, assistant)
        self.device = resolve_device(device)
        if params is None or cfg is None:
            params, cfg = load_params(checkpoint, cfg, dtype=dtype,
                                      device=self.device)
        # the int8 lane (cfg.quantize_*): weights are quantized once here;
        # the cache and cross-K/V flags reach init_cache and cross_kv
        # through cfg
        params = maybe_quantize_encoder(params, cfg)
        if mesh is not None:
            params = shard_params(params, mesh, cfg=cfg)
        if dtype == torch.bfloat16:
            cfg = cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
        assistant = prepare_assistant(assistant, dtype, self.device, mesh)
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer or WhisperTokenizer.from_pretrained(checkpoint)
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self._checkpoint = checkpoint
        self._align_heads = None
        self.speculative_method = speculative_method
        self.assistant = assistant
        self.gamma = int(gamma)
        self.max_ngram = int(max_ngram)
        self.spec_stats = {"drafted": 0, "accepted": 0}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def detect_language(self, mel: torch.Tensor) -> List[str]:
        """Language id per window (argmax over language tokens at the SOT
        position)."""
        tok, cfg = self.tokenizer, self.cfg
        enc = encode(self.params["encoder"], cfg, mel, dtype=self.dtype)
        cross = cross_kv(self.params["decoder"], cfg, enc)
        cache = init_cache(cfg, mel.shape[0], dtype=self.dtype,
                           device=mel.device,
                           width=kv_width(self.params["decoder"]))
        prompt = torch.full((mel.shape[0], 1), cfg.decoder_start_token_id,
                            dtype=torch.long, device=mel.device)
        logits, _ = decode(self.params["decoder"], cfg, prompt, cross=cross,
                           cache=cache, pos_offset=0, dtype=self.dtype)
        lang_ids = sorted(tok.lang_to_id.values())
        scores = logits[:, 0, lang_ids].cpu().numpy()
        best = np.asarray(lang_ids)[np.argmax(scores, axis=-1)]
        return [tok.id_to_lang[int(i)] for i in best]

    # ------------------------------------------------------------------
    def _chunk(self, audio: np.ndarray, chunk_length_s: float,
               stride_length_s) -> List[Dict[str, Any]]:
        sr = self.cfg.sampling_rate
        chunk_len = int(round(chunk_length_s * sr))
        if stride_length_s is None:
            stride_length_s = chunk_length_s / 6.0
        if isinstance(stride_length_s, (int, float)):
            stride_length_s = [stride_length_s, stride_length_s]
        stride_left = int(round(stride_length_s[0] * sr))
        stride_right = int(round(stride_length_s[1] * sr))
        step = chunk_len - stride_left - stride_right
        if step <= 0:
            raise ValueError("strides are larger than the chunk length")

        chunks = []
        for start in range(0, max(len(audio), 1), step):
            piece = audio[start:start + chunk_len]
            is_first = start == 0
            is_last = start + chunk_len >= len(audio)
            chunks.append({
                "audio": piece,
                "start_s": start / sr,
                "stride": (len(piece) / sr,
                           0.0 if is_first else stride_left / sr,
                           0.0 if is_last else stride_right / sr),
            })
            if is_last:
                break
        return chunks

    # ------------------------------------------------------------------
    def _alignment_heads(self):
        """The checkpoint's alignment heads, else the top half of the
        decoder."""
        if self._align_heads is None:
            try:
                self._align_heads = load_alignment_heads(self._checkpoint,
                                                         self.cfg)
            except (TypeError, OSError):
                self._align_heads = default_alignment_heads(self.cfg)
        return self._align_heads

    def _decode_batch(self, mels: torch.Tensor, prompts: List[List[int]],
                      opts: GenerationOptions, num_beams: int,
                      length_penalty: float,
                      num_frames: Optional[List[int]] = None):
        """:meth:`_decode_rows` of a batch of windows; under a mesh with a
        data axis, of this data rank's slice of it (padded to a multiple
        of the axis with the last window), gathered from every rank."""
        return decode_over_data(self.mesh, mels.shape[0], lambda rows: (
            self._decode_rows(
                mels[rows], [prompts[r] for r in rows], opts, num_beams,
                length_penalty, None if num_frames is None
                else [num_frames[r] for r in rows])))

    @torch.no_grad()
    def _decode_rows(self, mels: torch.Tensor, prompts: List[List[int]],
                     opts: GenerationOptions, num_beams: int,
                     length_penalty: float,
                     num_frames: Optional[List[int]] = None):
        """One batch of windows: encode, cross K/V, generate or beam search,
        and with ``num_frames`` (word timestamps) the alignment pass over the
        chosen tokens, sharing the cross K/V.  Returns host arrays
        ``(sequences, seq_len, token_times or None)``.

        Sampling (``opts.do_sample``) runs at temperature 0 with a generator
        seeded with 0, as the JAX pipeline passes a fixed key."""
        cfg, dec = self.cfg, self.params["decoder"]
        prompt_ids = torch.tensor(prompts, dtype=torch.long, device=self.device)
        enc = encode(self.params["encoder"], cfg, mels, dtype=self.dtype)
        cross = cross_kv(dec, cfg, enc)
        if num_beams > 1:
            out = beam_search(dec, cfg, cross, prompt_ids, opts,
                              num_beams=num_beams,
                              length_penalty=length_penalty, dtype=self.dtype)
        elif (self.speculative_method and num_frames is None
              and not opts.do_sample):
            # token for token the greedy program's output
            out = self.speculate(mels, enc, cross, prompt_ids, opts)
        else:
            out = generate(dec, cfg, cross, prompt_ids, opts, temperature=0.0,
                           dtype=self.dtype)
        seqs = out.sequences.cpu().numpy()
        lens = out.seq_len.cpu().numpy()
        if num_frames is None:
            return seqs, lens, None
        # crop the attention columns to each window's real mel frames before
        # the DTW (num_frames // 2 inside): final tokens must not align into
        # the zero-padded tail past the audio
        sel = selected_cross_weights(dec, cfg, out.sequences[:, :-1],
                                     self._alignment_heads(), cross=cross,
                                     dtype=self.dtype)
        times = token_timestamps_from_weights(
            sel.float().cpu().numpy(), num_input_ids=len(prompts[0]),
            seq_lens=lens, num_frames=num_frames)
        return seqs, lens, times

    def speculate(self, mels: torch.Tensor, enc: torch.Tensor, cross,
                  prompt_ids: torch.Tensor, opts: GenerationOptions):
        """Speculative greedy decode of one batch of windows (encoder states
        ``enc``, cross K/V ``cross``) by the pipeline's method; adds the
        batch's drafted and accepted counts to ``spec_stats``."""
        out = speculate_windows(self.params, self.cfg, mels, enc, cross,
                                prompt_ids, opts, self.speculative_method,
                                self.assistant, self.gamma, self.max_ngram,
                                self.dtype)
        self.spec_stats["drafted"] += int(out.drafted.sum())
        self.spec_stats["accepted"] += int(out.accepted.sum())
        return out

    # ------------------------------------------------------------------
    def __call__(self, audio, chunk_length_s: float = 30.0,
                 stride_length_s=None, batch_size: Optional[int] = None,
                 language: Optional[str] = None, task: str = "transcribe",
                 return_timestamps=False,
                 return_language: bool = False,
                 max_new_tokens: Optional[int] = None,
                 generate_kwargs: Optional[dict] = None):
        """Transcribe one audio (path, bytes, array or HF-style dict) into
        ``{"text": ..., ("chunks": ...)}``, or a list of audios into a list
        of such results.  ``return_timestamps`` is False, True (segment
        timestamps) or ``"word"``; ``generate_kwargs`` may hold
        ``num_beams`` and ``length_penalty`` (beam search) and any
        :class:`GenerationOptions` field (``do_sample``, ``top_k``, ...)."""
        tok, cfg = self.tokenizer, self.cfg
        batch_size = batch_size or self.batch_size
        max_new = max_new_tokens or self.max_new_tokens
        word_timestamps = return_timestamps == "word"
        gen_kwargs = dict(generate_kwargs or {})
        num_beams = int(gen_kwargs.pop("num_beams", 1))
        length_penalty = float(gen_kwargs.pop("length_penalty", 1.0))

        many = isinstance(audio, (list, tuple))
        files = [self._chunk(load_audio(a, cfg.sampling_rate), chunk_length_s,
                             stride_length_s)
                 for a in (audio if many else [audio])]
        windows = [(f, c) for f, chunks in enumerate(files) for c in chunks]

        # features for every window, each a padded 30 s window, in one call
        wavs = np.zeros((len(windows), cfg.n_samples), np.float32)
        for j, (_, c) in enumerate(windows):
            w = c["audio"][:cfg.n_samples]
            wavs[j, :len(w)] = w
        mels = compute_mel(wavs, cfg, device=self.device).to(self.dtype)

        first = [next(j for j, (f, _) in enumerate(windows) if f == i)
                 for i in range(len(files))]
        if language is None and len(tok.lang_to_id) > 1:
            languages = [lang for i in range(0, len(first), batch_size)
                         for lang in self.detect_language(
                             mels[first[i:i + batch_size]])]
        else:
            languages = [language] * len(files)
        prompts = [tok.prompt_ids(language=languages[f], task=task,
                                  no_timestamps=not return_timestamps)
                   for f, _ in windows]
        opts = GenerationOptions.from_config(
            cfg, max_new_tokens=max_new,
            return_timestamps=bool(return_timestamps),
            no_speech_token_id=tok.no_speech, **gen_kwargs)
        full = 2 * cfg.max_source_positions

        outputs: List[List[Dict[str, Any]]] = [[] for _ in files]
        for i in range(0, len(windows), batch_size):
            batch = windows[i:i + batch_size]
            frames = ([min(int(round(c["stride"][0] * 100)), full)
                       for _, c in batch] if word_timestamps else None)
            seqs, lens, times = self._decode_batch(
                mels[i:i + batch_size], prompts[i:i + batch_size], opts,
                num_beams, length_penalty, frames)
            for j, (f, c) in enumerate(batch):
                entry = {"tokens": seqs[j][:lens[j]].tolist(),
                         "stride": c["stride"]}
                if times is not None:
                    entry["token_times"] = times[j][:lens[j]]
                    entry["start_s"] = c["start_s"]
                outputs[f].append(entry)

        if word_timestamps:
            results = [self._assemble_words(o, prompt_len=len(prompts[0]))
                       for o in outputs]
        else:
            results = [self._assemble(o, return_timestamps, return_language)
                       for o in outputs]
        return results if many else results[0]

    def transcribe_words_batch(self, wavs: List[np.ndarray],
                               languages: Optional[List[Optional[str]]] = None,
                               task: str = "transcribe",
                               max_new_tokens: Optional[int] = None,
                               ) -> List[Dict[str, Any]]:
        """Word-timestamp transcription of many short (<= 30 s) audios in
        shared batches; row for row the result of
        ``self(wav, return_timestamps="word")``.  Languages may differ per
        row; missing ones are detected in one batched pass."""
        tok, cfg = self.tokenizer, self.cfg
        n = len(wavs)
        max_new = max_new_tokens or self.max_new_tokens
        full = 2 * cfg.max_source_positions
        wav_arr = np.zeros((n, cfg.n_samples), np.float32)
        n_frames, durs = [], []
        for j, w in enumerate(wavs):
            if len(w) > cfg.n_samples:
                raise ValueError("transcribe_words_batch is single-window "
                                 f"only (audio {j} exceeds 30 s)")
            wav_arr[j, :len(w)] = w
            n_frames.append(min(int(round(len(w) / cfg.sampling_rate * 100)),
                                full))
            durs.append(len(w) / cfg.sampling_rate)
        mels = compute_mel(wav_arr, cfg, device=self.device).to(self.dtype)

        languages = list(languages) if languages else [None] * n
        if any(l is None for l in languages) and len(tok.lang_to_id) > 1:
            detected = self.detect_language(mels)
            languages = [l if l is not None else detected[j]
                         for j, l in enumerate(languages)]
        prompts = [tok.prompt_ids(language=languages[j], task=task,
                                  no_timestamps=False) for j in range(n)]
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("prompts of one batch must have one length")
        opts = GenerationOptions.from_config(
            cfg, max_new_tokens=max_new, return_timestamps=True,
            no_speech_token_id=tok.no_speech)

        results: List[Dict[str, Any]] = []
        for i in range(0, n, self.batch_size):
            k = min(self.batch_size, n - i)
            seqs, lens, times = self._decode_batch(
                mels[i:i + k], prompts[i:i + k], opts, 1, 1.0,
                n_frames[i:i + k])
            for j in range(k):
                entry = {"tokens": seqs[j][:lens[j]].tolist(),
                         "stride": (durs[i + j], 0.0, 0.0),
                         "token_times": times[j][:lens[j]],
                         "start_s": 0.0}
                res = self._assemble_words([entry], prompt_len=plen)
                res["language"] = languages[i + j]
                results.append(res)
        return results

    def _assemble(self, outputs: List[Dict[str, Any]], return_timestamps,
                  return_language) -> Dict[str, Any]:
        tok = self.tokenizer
        if len(outputs) == 1:
            ids = outputs[0]["tokens"]
            result: Dict[str, Any] = {
                "text": tok.decode(ids, skip_special_tokens=True)}
            if return_timestamps:
                _, opt = tok.decode_asr([{"tokens": ids}],
                                        return_timestamps=True,
                                        return_language=return_language)
                result.update(opt)
            return result
        text, optional = tok.decode_asr(outputs,
                                        return_timestamps=return_timestamps,
                                        return_language=return_language)
        return {"text": text, **optional}

    def _assemble_words(self, outputs: List[Dict[str, Any]],
                        prompt_len: int) -> Dict[str, Any]:
        """Per-window token times -> one word list with stride trimming:
        each word belongs to the window whose non-strided core holds its
        start (left/right strides are 0 on the first/last window)."""
        tok = self.tokenizer
        words: List[Dict[str, Any]] = []
        for o in outputs:
            dur, left, right = o["stride"]
            gen_ids = o["tokens"][prompt_len:]
            gen_times = o["token_times"][prompt_len:len(o["tokens"])]
            for w in words_from_tokens(tok, gen_ids, gen_times,
                                       time_offset=0.0):
                if w["start"] < left - 1e-6 or w["start"] >= dur - right:
                    continue
                words.append({
                    "text": w["word"],
                    "timestamp": (round(o["start_s"] + w["start"], 2),
                                  round(o["start_s"] + w["end"], 2)),
                })
        text = "".join(w["text"] for w in words)
        return {"text": text.strip(), "chunks": words}
