"""User-facing ASR pipeline: short-form + chunked long-form transcription.

Counterpart of ``distil_whisper_tpu.pipeline.WhisperPipeline`` on the greedy
path: audio -> strided 30 s chunks (stride = chunk/6 by default) -> batched
log-mel -> encode + greedy generate -> timestamp/LCS merge of overlapping
chunks (``WhisperTokenizer.decode_asr``).  It runs on the card by default.

A list of audios is transcribed in shared batches of windows (every file's
chunks are batched together; rows are independent) and returns one result
per file.  JAX pads a ragged last batch to its compiled shape; PyTorch runs
the rows that exist.

With ``cfg.quantize_*`` set it runs the int8 lane: W8A8 encoder and
decoder projections, int8 self-KV cache and cross K/V, int8 logits.

Not in this slice: the device mesh, beam search, word timestamps and
speculative decoding.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio import compute_mel
from .audio.io import load_audio
from .config import WhisperConfig
from .device import resolve_device
from .generation import GenerationOptions, encode_and_generate
from .models import load_params
from .models.whisper import cross_kv, decode, encode, init_cache
from .ops.quant import maybe_quantize_encoder
from .tokenizer import WhisperTokenizer


class WhisperPipeline:
    """``pipeline = WhisperPipeline(ckpt_dir); pipeline(audio, chunk_length_s=30)``"""

    def __init__(self, checkpoint: Optional[str], dtype=torch.bfloat16,
                 batch_size: int = 8, max_new_tokens: int = 128,
                 params=None, cfg: Optional[WhisperConfig] = None,
                 tokenizer: Optional[WhisperTokenizer] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if params is None or cfg is None:
            params, cfg = load_params(checkpoint, cfg, dtype=dtype,
                                      device=self.device)
        # the int8 lane (cfg.quantize_*): weights are quantized once here;
        # the cache and cross-K/V flags reach init_cache and cross_kv
        # through cfg
        params = maybe_quantize_encoder(params, cfg)
        if dtype == torch.bfloat16:
            cfg = cfg.replace(fast_bf16_attention=True, use_flash_encoder=True)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer or WhisperTokenizer.from_pretrained(checkpoint)
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens

    # ------------------------------------------------------------------
    @torch.no_grad()
    def detect_language(self, mel: torch.Tensor) -> List[str]:
        """Language id per window (argmax over language tokens at the SOT
        position)."""
        tok, cfg = self.tokenizer, self.cfg
        enc = encode(self.params["encoder"], cfg, mel, dtype=self.dtype)
        cross = cross_kv(self.params["decoder"], cfg, enc)
        cache = init_cache(cfg, mel.shape[0], dtype=self.dtype,
                           device=mel.device)
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
    def __call__(self, audio, chunk_length_s: float = 30.0,
                 stride_length_s=None, batch_size: Optional[int] = None,
                 language: Optional[str] = None, task: str = "transcribe",
                 return_timestamps: bool = False,
                 return_language: bool = False,
                 max_new_tokens: Optional[int] = None,
                 generate_kwargs: Optional[dict] = None):
        """Transcribe one audio (path, bytes, array or HF-style dict) into
        ``{"text": ..., ("chunks": ...)}``, or a list of audios into a list
        of such results."""
        if return_timestamps == "word":
            raise NotImplementedError("word timestamps come with a later "
                                      "slice of the port")
        tok, cfg = self.tokenizer, self.cfg
        batch_size = batch_size or self.batch_size
        max_new = max_new_tokens or self.max_new_tokens
        gen_kwargs = dict(generate_kwargs or {})
        if int(gen_kwargs.pop("num_beams", 1)) > 1:
            raise NotImplementedError("beam search comes with a later slice "
                                      "of the port")
        gen_kwargs.pop("length_penalty", None)

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

        outputs: List[List[Dict[str, Any]]] = [[] for _ in files]
        for i in range(0, len(windows), batch_size):
            out = encode_and_generate(
                self.params, cfg, mels[i:i + batch_size],
                torch.tensor(prompts[i:i + batch_size], dtype=torch.long),
                opts, dtype=self.dtype, device=self.device)
            seqs = out.sequences.cpu().numpy()
            lens = out.seq_len.cpu().numpy()
            for j in range(len(seqs)):
                f, c = windows[i + j]
                outputs[f].append({"tokens": seqs[j][:lens[j]].tolist(),
                                   "stride": c["stride"]})

        results = [self._assemble(o, return_timestamps, return_language)
                   for o in outputs]
        return results if many else results[0]

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
