"""Sequential (OpenAI-style) long-form transcription with batched cursors.

Counterpart of ``distil_whisper_tpu.generation.sequential``: decode a 30 s
window, cut it into segments at paired timestamp tokens, advance the window
to the last complete segment, optionally condition the next window on
previous output, and retry each window up the temperature ladder when its
average logprob or compression ratio fails.

Every window of a group shares one fixed-size left-padded prompt layout
(``pad_len`` masking), as in JAX.  JAX pads a ragged group to ``batch_size``
because jit needs a static shape; the port runs the rows that exist (rows
are independent).  Each rung encodes its windows again, as JAX does.
Sampling rungs draw from a ``torch.Generator`` split per rung from the
caller's generator (JAX splits a threefry key per rung).

With ``speculative_method`` ("draft" with ``assistant=(params, cfg)``, or
"ngram") the temperature-0 rung decodes by speculation on the left-padded
prompt layout (``pad_len`` and ``sot_slot``): token for token the greedy
rung, so the ladder's decisions are unchanged.  Sampled rungs keep the
plain sampling path.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WhisperConfig
from ..device import resolve_device
from ..tokenizer import WhisperTokenizer
from .beam import encode_and_beam_search
from .generate import (GenerationOptions, check_params_device,
                       encode_and_generate)
from .graphs import GraphOwner
from .speculative import (check_method, prepare_assistant,
                          speculate_windows)
from ..models.whisper import encode

FRAMES_PER_SECOND = 100   # mel frames per second (hop 160 @ 16 kHz)
INPUT_STRIDE = 2          # mel frames per 0.02 s timestamp unit


@dataclasses.dataclass(frozen=True)
class SequentialOptions:
    """Defaults = the reference eval defaults (BASELINE.md: fallback
    temperatures 0.0->1.0 step 0.2, logprob -1.0, no-speech 0.6,
    compression 1.35)."""
    temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    logprob_threshold: Optional[float] = -1.0
    no_speech_threshold: Optional[float] = 0.6
    compression_ratio_threshold: Optional[float] = 1.35
    condition_on_prev_tokens: bool = False
    prompt_reset_on_temperature: float = 0.5
    max_new_tokens: int = 224
    max_initial_timestamp_index: Optional[int] = 50
    # Beam search at the temperature-0 rung only; fallback rungs sample with
    # one beam (HF generate_with_fallback sets do_sample = t > 0 and forces
    # num_beams = 1 when sampling — the combination the reference exposes by
    # passing num_beams straight into sequential generate,
    # training/run_eval.py:690-718).
    num_beams: int = 1
    length_penalty: float = 1.0


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


class SequentialTranscriber:
    """Host orchestrator around the window generate (or beam) call."""

    def __init__(self, params, cfg: WhisperConfig, tokenizer: WhisperTokenizer,
                 opts: SequentialOptions = SequentialOptions(),
                 language: Optional[str] = None, task: str = "transcribe",
                 batch_size: int = 8, dtype: torch.dtype = torch.float32,
                 speculative_method: Optional[str] = None, assistant=None,
                 gamma: int = 5, max_ngram: int = 3, device="cuda"):
        check_method(speculative_method, assistant)
        if speculative_method and opts.num_beams > 1:
            raise ValueError("speculative decoding verifies greedy argmax "
                             "agreement; it does not compose with beam "
                             "search (num_beams > 1)")
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.spec_method = speculative_method
        self.assistant = prepare_assistant(assistant, dtype, self.device)
        self.gamma = int(gamma)
        self.max_ngram = int(max_ngram)
        self.spec_stats = {"drafted": 0, "accepted": 0, "rounds": 0}
        # the CUDA graphs of the rungs' decodes: one greedy and one
        # sampling program a batch size (the temperature is their input),
        # or the beam or speculative t = 0 rung's program in place of the
        # greedy one
        self.graphs = GraphOwner("sequential")
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.opts = opts
        self.batch_size = batch_size
        self.dtype = dtype
        self.base_prompt = tokenizer.prompt_ids(language=language, task=task,
                                                no_timestamps=False)
        # fixed prompt layout: [pad ... pad | <|startofprev|> ctx... | base]
        self.ctx_budget = (cfg.max_target_positions // 2 - 1
                           if opts.condition_on_prev_tokens else 0)
        self.prompt_len = len(self.base_prompt) + (
            self.ctx_budget + 1 if opts.condition_on_prev_tokens else 0)
        self.sot_slot = self.prompt_len - len(self.base_prompt)
        max_new = min(opts.max_new_tokens,
                      cfg.max_target_positions - self.prompt_len)
        self._gen_opts = {
            do_sample: GenerationOptions.from_config(
                cfg, max_new_tokens=max_new, do_sample=do_sample,
                return_timestamps=True,
                max_initial_timestamp_index=opts.max_initial_timestamp_index,
                no_speech_token_id=tokenizer.no_speech)
            for do_sample in (False, True)}

    # ------------------------------------------------------------------
    def _build_prompt(self, prev_tokens: List[int]) -> Tuple[List[int], int]:
        """(fixed-length prompt, pad_len) with prev context left-padded."""
        if not self.opts.condition_on_prev_tokens:
            return list(self.base_prompt), 0
        ctx = prev_tokens[-self.ctx_budget:] if prev_tokens else []
        prev = [self.tok.sot_prev] + ctx if ctx else []
        pad = self.prompt_len - len(prev) - len(self.base_prompt)
        return ([self.cfg.pad_token_id] * pad + prev + list(self.base_prompt),
                pad)

    def _run_window(self, mels: torch.Tensor, prompts: np.ndarray,
                    pads: np.ndarray, temperature: float,
                    generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """One encode + generate (or beam at the t = 0 rung) over the rows of
        a group that are still pending."""
        prompts_t = torch.as_tensor(prompts, dtype=torch.long,
                                    device=self.device)
        pads_t = torch.as_tensor(pads, dtype=torch.long, device=self.device)
        if temperature == 0 and self.opts.num_beams > 1:
            # beam at the t=0 rung only; fallback rungs sample with 1 beam
            # (HF generate_with_fallback semantics)
            out = encode_and_beam_search(
                self.params, self.cfg, mels, prompts_t, self._gen_opts[False],
                num_beams=self.opts.num_beams,
                length_penalty=self.opts.length_penalty,
                sot_slot=self.sot_slot, pad_len=pads_t, dtype=self.dtype,
                device=self.device, graphs=self.graphs)
        elif temperature == 0 and self.spec_method:
            out = self._speculate(mels, prompts_t, pads_t)
        else:
            out = encode_and_generate(
                self.params, self.cfg, mels, prompts_t,
                self._gen_opts[temperature > 0], temperature=temperature,
                generator=generator, pad_len=pads_t, sot_slot=self.sot_slot,
                dtype=self.dtype, device=self.device, graphs=self.graphs)
        return {
            "sequences": out.sequences.cpu().numpy(),
            "seq_len": out.seq_len.cpu().numpy(),
            "sum_logprobs": out.sum_logprobs.float().cpu().numpy(),
            "no_speech_prob": out.no_speech_prob.float().cpu().numpy(),
        }

    @torch.no_grad()
    def _speculate(self, mels: torch.Tensor, prompts: torch.Tensor,
                   pads: torch.Tensor):
        """The speculative t = 0 rung: encode, then the batched draft or
        n-gram loop on the padded prompts; adds the rows' counters to
        ``spec_stats``."""
        enc = encode(self.params["encoder"], self.cfg, mels, dtype=self.dtype)
        out = speculate_windows(self.params, self.cfg, mels, enc, prompts,
                                self._gen_opts[False], self.spec_method,
                                self.assistant, self.gamma, self.max_ngram,
                                self.dtype, pad_len=pads,
                                sot_slot=self.sot_slot, graphs=self.graphs)
        for key in self.spec_stats:
            self.spec_stats[key] += int(getattr(out, key).sum())
        return out

    def _split(self, generator: torch.Generator) -> torch.Generator:
        """A generator for one rung, seeded by a draw from ``generator``."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def _cut_segments(self, tokens: List[int], time_offset: float,
                      seek_num_frames: int) -> Tuple[List[Dict], int]:
        """Split a window's generated tokens at paired timestamps; return
        (segments, frames_to_advance).  Mirrors HF ``_retrieve_segment``."""
        ts_begin = self.tok.timestamp_begin
        tp = 0.02
        is_ts = [t >= ts_begin for t in tokens]
        single_ending = (len(tokens) >= 2 and is_ts[-1] and not is_ts[-2])
        pair_idx = [i + 1 for i in range(len(tokens) - 1)
                    if is_ts[i] and is_ts[i + 1]]

        segments: List[Dict] = []
        if pair_idx:
            slices = list(pair_idx)
            if single_ending:
                slices.append(len(tokens))
            else:
                slices[-1] += 1
            last = 0
            for i, cur in enumerate(slices):
                seg_tokens = tokens[last:cur]
                is_last_slice = i == len(slices) - 1
                start_pos = seg_tokens[0] - ts_begin
                end_idx = -1 if (not is_last_slice or single_ending) else -2
                end_pos = seg_tokens[end_idx] - ts_begin
                segments.append({
                    "start": time_offset + start_pos * tp,
                    "end": time_offset + end_pos * tp,
                    "tokens": seg_tokens,
                })
                last = cur
            if single_ending:
                advance = seek_num_frames
            else:
                last_ts_pos = tokens[last - 2] - ts_begin
                advance = last_ts_pos * INPUT_STRIDE
        else:
            ts = [t for t in tokens if t >= ts_begin]
            end_pos = seek_num_frames // INPUT_STRIDE
            if ts and ts[-1] != ts_begin:
                end_pos = ts[-1] - ts_begin
            segments = [{
                "start": time_offset,
                "end": time_offset + end_pos * tp,
                "tokens": tokens,
            }]
            advance = seek_num_frames
        return segments, max(advance, 1)

    # ------------------------------------------------------------------
    def transcribe(self, features: Sequence[np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   initial_prompt_tokens: Optional[List[int]] = None,
                   ) -> List[Dict[str, Any]]:
        """features: per-sample full-length log-mel [n_mels, total_frames]
        (numpy or tensors; windows are cut where the features lie and moved
        to the transcriber's device).  ``generator`` seeds the sampling
        rungs (a CPU generator seeded with 0 when not given).

        ``initial_prompt_tokens`` seeds the <|startofprev|> context of the
        FIRST window (the reference's prompt_ids / openai-whisper
        initial_prompt; requires ``condition_on_prev_tokens`` — the prompt
        layout reserves the context budget only then).

        Returns per sample: {"text", "segments": [{start, end, text, tokens,
        temperature, avg_logprob, compression_ratio, no_speech_prob}]}.
        """
        opts = self.opts
        if initial_prompt_tokens and not opts.condition_on_prev_tokens:
            raise ValueError("initial_prompt_tokens requires "
                             "condition_on_prev_tokens=True (the prompt "
                             "layout reserves context space only then)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        features = [torch.as_tensor(f) for f in features]
        n = len(features)
        window = self.cfg.nb_max_frames  # 3000
        seeks = [0] * n
        totals = [f.shape[-1] for f in features]
        prev_tokens: List[List[int]] = [
            list(initial_prompt_tokens or []) for _ in range(n)]
        condition_flags = [opts.condition_on_prev_tokens] * n
        results: List[Dict[str, Any]] = [
            {"segments": [], "text": ""} for _ in range(n)]

        while True:
            active = [i for i in range(n) if seeks[i] < totals[i]]
            if not active:
                break
            for group_start in range(0, len(active), self.batch_size):
                group = active[group_start:group_start + self.batch_size]
                mels, prompts, pads = [], [], []
                for i in group:
                    seg = features[i][:, seeks[i]:seeks[i] + window]
                    if seg.shape[-1] < window:
                        seg = F.pad(seg, (0, window - seg.shape[-1]))
                    mels.append(seg.to(self.device, torch.float32))
                    ptoks, pad = self._build_prompt(
                        prev_tokens[i] if condition_flags[i] else [])
                    prompts.append(ptoks)
                    pads.append(pad)
                mels = torch.stack(mels).to(self.dtype)
                prompts_np = np.asarray(prompts, np.int32)
                pads_np = np.asarray(pads, np.int32)

                pending = list(range(len(group)))
                accepted: Dict[int, Dict[str, Any]] = {}
                for temperature in opts.temperatures:
                    if not pending:
                        break
                    step = self._split(generator)
                    out = self._run_window(mels[pending], prompts_np[pending],
                                           pads_np[pending], temperature, step)
                    still_pending = []
                    for row, g in enumerate(pending):
                        p_len = self.prompt_len if opts.condition_on_prev_tokens \
                            else len(self.base_prompt)
                        seq = out["sequences"][row][:out["seq_len"][row]]
                        gen = [int(t) for t in seq[p_len:]]
                        text = self.tok.decode(gen)
                        ratio = compression_ratio(text)
                        avg_lp = (out["sum_logprobs"][row] / max(len(gen), 1))
                        needs_fallback = False
                        if (opts.compression_ratio_threshold is not None
                                and ratio > opts.compression_ratio_threshold):
                            needs_fallback = True
                        if (opts.logprob_threshold is not None
                                and avg_lp < opts.logprob_threshold):
                            needs_fallback = True
                        if (opts.no_speech_threshold is not None
                                and out["no_speech_prob"][row] > opts.no_speech_threshold
                                and (opts.logprob_threshold is None
                                     or avg_lp < opts.logprob_threshold)):
                            needs_fallback = False  # silence: don't retry
                            gen = []
                        if needs_fallback and temperature != opts.temperatures[-1]:
                            still_pending.append(g)
                        else:
                            accepted[g] = {
                                "tokens": gen, "temperature": temperature,
                                "avg_logprob": float(avg_lp),
                                "compression_ratio": ratio,
                                "no_speech_prob": float(out["no_speech_prob"][row]),
                            }
                    pending = still_pending

                for row_g, acc in accepted.items():
                    i = group[row_g]
                    seek_num = min(window, totals[i] - seeks[i])
                    time_offset = seeks[i] / FRAMES_PER_SECOND
                    if not acc["tokens"]:  # skipped as silence
                        seeks[i] += seek_num
                        condition_flags[i] = opts.condition_on_prev_tokens
                        continue
                    segments, advance = self._cut_segments(
                        acc["tokens"], time_offset, seek_num)
                    for s in segments:
                        s.update(temperature=acc["temperature"],
                                 avg_logprob=acc["avg_logprob"],
                                 compression_ratio=acc["compression_ratio"],
                                 no_speech_prob=acc["no_speech_prob"],
                                 text=self.tok.decode(s["tokens"]))
                        results[i]["segments"].append(s)
                        kept = s["tokens"]
                        # drop a trailing paired end-timestamp from the prompt
                        # context (HF skip_ending_double_timestamps)
                        if (len(kept) >= 2
                                and kept[-1] >= self.tok.timestamp_begin
                                and kept[-2] >= self.tok.timestamp_begin):
                            kept = kept[:-1]
                        prev_tokens[i].extend(kept)
                    seeks[i] += advance
                    condition_flags[i] = (
                        opts.condition_on_prev_tokens
                        and acc["temperature"] <= opts.prompt_reset_on_temperature)
                    if not condition_flags[i]:
                        prev_tokens[i] = []

        for r in results:
            r["text"] = "".join(s["text"] for s in r["segments"])
        return results
