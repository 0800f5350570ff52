"""Whisper model / front-end configuration (the port's own copy).

A single frozen dataclass drives the whole stack (front-end, model,
generation).  Field for field the same as ``distil_whisper_tpu.config``, so a
checkpoint's ``config.json`` and the presets mean the same thing in both
packages; the port keeps a copy so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Static architecture + special-token configuration for a Whisper model."""

    # --- architecture ---
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500   # encoder positions (30 s of audio)
    max_target_positions: int = 448    # decoder positions
    activation_function: str = "gelu"
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    # inference fast path: compute attention logits/softmax in the model dtype
    # instead of fp32 (no-op for fp32 runs).  Training/parity paths keep fp32
    # attention (the T5X float32_logits trick).
    fast_bf16_attention: bool = False
    # OPT-IN approximate inference mode (off everywhere by default): dtype-
    # native LayerNorm statistics + tanh-approximate gelu.  Deviates from the
    # exact numerics — validate WER on your eval set before enabling.
    fast_approx_activations: bool = False
    # Hand-written encoder self-attention kernel (ops/encoder_attention.py,
    # csrc/encoder_attention.cu): never materialises the [B,H,1500,1500]
    # logits/probs in device memory.  fp32 softmax internally (matches the
    # f32 numerics policy).  bf16 only on the card.
    use_flash_encoder: bool = False
    # OPT-IN int8 cross-attention K/V storage (per layer/batch/head absmax
    # scales): halves the dominant per-token HBM traffic of long decodes.
    # Validate WER before enabling in production.
    quantize_cross_kv: bool = False
    # OPT-IN int8 decoder self-attention KV cache (per token/head absmax
    # scales): halves the self-cache HBM traffic of deep-decoder (teacher)
    # generation.  Validate WER before enabling in production.
    quantize_self_kv: bool = False
    # OPT-IN W8A8 int8 encoder (per-channel weights + dynamic per-token
    # activations on the projection/MLP matmuls; the MLP through the fused
    # int8 kernel on the card, ops/int8_mlp.py).
    quantize_encoder: bool = False
    # OPT-IN W8A8 int8 decoder projections/MLP: low-batch decode is
    # weight-read bound, so int8 weights nearly halve the per-token floor
    # (the bs1-4 serving/speculative regime).  Validate WER before enabling.
    quantize_decoder: bool = False
    # OPT-IN int8 logits matmul: an int8 copy of the tied token embedding
    # is used for the [d_model, vocab] output projection (the input
    # embedding lookup stays exact).  Engages only at batch >= 8.
    # Validate WER before enabling.
    quantize_lm_head: bool = False

    # --- special tokens (defaults = multilingual v2 layout) ---
    pad_token_id: int = 50257
    bos_token_id: int = 50257
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    suppress_tokens: Tuple[int, ...] = ()
    begin_suppress_tokens: Tuple[int, ...] = (220, 50257)
    forced_decoder_ids: Tuple[Tuple[int, int], ...] = ()

    # --- front-end ---
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    chunk_length: int = 30  # seconds

    # ------------------------------------------------------------------
    @property
    def n_samples(self) -> int:
        return self.chunk_length * self.sampling_rate  # 480_000

    @property
    def nb_max_frames(self) -> int:
        return self.n_samples // self.hop_length  # 3000

    @property
    def encoder_head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def decoder_head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    # Token-id helpers for the timestamp vocabulary.  The multilingual Whisper
    # vocab appends 1501 timestamp tokens <|0.00|>..<|30.00|> after the special
    # tokens; their first id is ``no_timestamps + 1`` (HF convention).
    @property
    def no_timestamps_token_id(self) -> int:
        # <|notimestamps|> sits right before the timestamp block.
        return self.timestamp_begin - 1

    @property
    def timestamp_begin(self) -> int:
        return self.vocab_size - 1501  # id of <|0.00|>

    def replace(self, **kw) -> "WhisperConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @classmethod
    def from_hf_dict(cls, d: dict) -> "WhisperConfig":
        """Build from a HF ``config.json`` dict (extra keys ignored)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k in fields:
                if isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                if v is None and k in ("suppress_tokens", "forced_decoder_ids",
                                       "begin_suppress_tokens"):
                    v = ()
                kw[k] = v
        return cls(**kw)

    @classmethod
    def from_pretrained(cls, path: str) -> "WhisperConfig":
        with open(Path(path) / "config.json") as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = "whisper"
        d["architectures"] = ["WhisperForConditionalGeneration"]
        d["is_encoder_decoder"] = True
        d["suppress_tokens"] = list(self.suppress_tokens)
        d["forced_decoder_ids"] = [list(p) for p in self.forced_decoder_ids] or None
        return d

    def save_pretrained(self, path: str) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        with open(p / "config.json", "w") as f:
            json.dump(self.to_hf_dict(), f, indent=2)


# ----------------------------------------------------------------------
# Presets matching the published checkpoints.
# ----------------------------------------------------------------------

def _preset(**kw) -> WhisperConfig:
    return WhisperConfig(**kw)


PRESETS = {
    "tiny": _preset(d_model=384, encoder_layers=4, decoder_layers=4,
                    encoder_attention_heads=6, decoder_attention_heads=6,
                    encoder_ffn_dim=1536, decoder_ffn_dim=1536),
    "base": _preset(d_model=512, encoder_layers=6, decoder_layers=6,
                    encoder_attention_heads=8, decoder_attention_heads=8,
                    encoder_ffn_dim=2048, decoder_ffn_dim=2048),
    "small": _preset(d_model=768, encoder_layers=12, decoder_layers=12,
                     encoder_attention_heads=12, decoder_attention_heads=12,
                     encoder_ffn_dim=3072, decoder_ffn_dim=3072),
    "medium": _preset(d_model=1024, encoder_layers=24, decoder_layers=24,
                      encoder_attention_heads=16, decoder_attention_heads=16,
                      encoder_ffn_dim=4096, decoder_ffn_dim=4096),
    "large-v2": _preset(d_model=1280, encoder_layers=32, decoder_layers=32,
                        encoder_attention_heads=20, decoder_attention_heads=20,
                        encoder_ffn_dim=5120, decoder_ffn_dim=5120),
    "large-v3": _preset(d_model=1280, encoder_layers=32, decoder_layers=32,
                        encoder_attention_heads=20, decoder_attention_heads=20,
                        encoder_ffn_dim=5120, decoder_ffn_dim=5120,
                        vocab_size=51866, num_mel_bins=128),
    # Distilled students: full encoder, shallow decoder (README.md:15-18).
    "distil-large-v2": _preset(d_model=1280, encoder_layers=32, decoder_layers=2,
                               encoder_attention_heads=20, decoder_attention_heads=20,
                               encoder_ffn_dim=5120, decoder_ffn_dim=5120),
    "distil-large-v3": _preset(d_model=1280, encoder_layers=32, decoder_layers=2,
                               encoder_attention_heads=20, decoder_attention_heads=20,
                               encoder_ffn_dim=5120, decoder_ffn_dim=5120,
                               vocab_size=51866, num_mel_bins=128),
    "distil-medium.en": _preset(d_model=1024, encoder_layers=24, decoder_layers=2,
                                encoder_attention_heads=16, decoder_attention_heads=16,
                                encoder_ffn_dim=4096, decoder_ffn_dim=4096,
                                vocab_size=51864),
    "distil-small.en": _preset(d_model=768, encoder_layers=12, decoder_layers=4,
                               encoder_attention_heads=12, decoder_attention_heads=12,
                               encoder_ffn_dim=3072, decoder_ffn_dim=3072,
                               vocab_size=51864),
    # Tiny random config for tests (distil-whisper/tiny-random-whisper's role).
    "test-tiny": _preset(vocab_size=51865, d_model=64, encoder_layers=2, decoder_layers=2,
                         encoder_attention_heads=4, decoder_attention_heads=4,
                         encoder_ffn_dim=128, decoder_ffn_dim=128,
                         max_source_positions=1500, max_target_positions=448),
}
