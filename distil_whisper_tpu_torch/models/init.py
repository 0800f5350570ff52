"""Random initialisation of the Whisper param tree."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import WhisperConfig
from ..device import resolve_device

Params = Dict[str, Any]


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """OpenAI-Whisper sinusoids (the encoder's fixed position table)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def init_params(cfg: WhisperConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """HF-style init (normal, std 0.02) with sinusoidal encoder positions.

    Same tree and shapes as ``distil_whisper_tpu.models.init_params``; the
    values come from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (they differ from JAX's: tests hand both packages one tree through
    ``convert.params_from_numpy`` instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    std = 0.02

    def norm(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (std * x).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ln(*lead):
        return {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                                    device=dev),
                "bias": zeros(lead + (cfg.d_model,))}

    def attn(n_layers):
        d = cfg.d_model

        def blk(with_bias):
            out = {"kernel": norm((n_layers, d, d))}
            if with_bias:
                out["bias"] = zeros((n_layers, d))
            return out
        return {"q": blk(True), "k": blk(False), "v": blk(True),
                "out": blk(True)}

    def mlp(n_layers, f):
        d = cfg.d_model
        return {"fc1": {"kernel": norm((n_layers, d, f)),
                        "bias": zeros((n_layers, f))},
                "fc2": {"kernel": norm((n_layers, f, d)),
                        "bias": zeros((n_layers, d))}}

    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    return {
        "encoder": {
            "conv1": {"kernel": norm((3, cfg.num_mel_bins, cfg.d_model)),
                      "bias": zeros((cfg.d_model,))},
            "conv2": {"kernel": norm((3, cfg.d_model, cfg.d_model)),
                      "bias": zeros((cfg.d_model,))},
            "pos_emb": torch.from_numpy(sinusoidal_positions(
                cfg.max_source_positions, cfg.d_model)).to(dev, dtype),
            "layers": {"self_attn": attn(n_enc), "self_attn_ln": ln(n_enc),
                       **mlp(n_enc, cfg.encoder_ffn_dim),
                       "final_ln": ln(n_enc)},
            "ln_post": ln(),
        },
        "decoder": {
            "tok_emb": norm((cfg.vocab_size, cfg.d_model)),
            "pos_emb": norm((cfg.max_target_positions, cfg.d_model)),
            "layers": {"self_attn": attn(n_dec), "self_attn_ln": ln(n_dec),
                       "cross_attn": attn(n_dec), "cross_attn_ln": ln(n_dec),
                       **mlp(n_dec, cfg.decoder_ffn_dim),
                       "final_ln": ln(n_dec)},
            "ln": ln(),
        },
    }


def _attn_axes():
    kern = ("layers", "embed", "joined_kv")
    bias = ("layers", "joined_kv")
    return {"q": {"kernel": kern, "bias": bias}, "k": {"kernel": kern},
            "v": {"kernel": kern, "bias": bias},
            "out": {"kernel": ("layers", "joined_kv", "embed"),
                    "bias": ("layers", "embed")}}


def param_axes(cfg: WhisperConfig) -> Params:
    """Tree of logical-axis tuples, the structure of :func:`init_params`
    (the JAX package's table; ``parallel.mesh`` maps it onto mesh axes)."""
    ln_l = {"scale": ("layers", "embed"), "bias": ("layers", "embed")}
    ln_0 = {"scale": ("embed",), "bias": ("embed",)}
    mlp_l = {
        "fc1": {"kernel": ("layers", "embed", "mlp"),
                "bias": ("layers", "mlp")},
        "fc2": {"kernel": ("layers", "mlp", "embed"),
                "bias": ("layers", "embed")},
    }
    return {
        "encoder": {
            "conv1": {"kernel": ("stack", "unmodeled", "embed"),
                      "bias": ("embed",)},
            "conv2": {"kernel": ("stack", "unmodeled", "embed"),
                      "bias": ("embed",)},
            "pos_emb": ("length", "embed"),
            "layers": {"self_attn": _attn_axes(), "self_attn_ln": ln_l,
                       "final_ln": ln_l, **mlp_l},
            "ln_post": ln_0,
        },
        "decoder": {
            "tok_emb": ("vocab", "embed"),
            "pos_emb": ("length", "embed"),
            "layers": {"self_attn": _attn_axes(), "self_attn_ln": ln_l,
                       "cross_attn": _attn_axes(), "cross_attn_ln": ln_l,
                       "final_ln": ln_l, **mlp_l},
            "ln": ln_0,
        },
    }
