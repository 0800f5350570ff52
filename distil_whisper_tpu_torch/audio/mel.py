"""Log-mel spectrogram front-end: constants and the plain PyTorch path.

Numerics pinned to the reference's torch-STFT feature extractor:

    stft       : n_fft=400, hop=160, hann(periodic) window, center=True (reflect pad)
    magnitudes : |stft[..., :-1]|**2            (last frame dropped -> 3000 frames)
    mel        : slaney-scale, slaney-norm filter bank (201 bins -> 80/128 mels)
    compress   : log10(clamp(., 1e-10)); max(., max-8); (.+4)/4   (max is per-sample)

The numpy constant builders are byte-for-byte those of
``distil_whisper_tpu.audio.mel``.  :func:`log_mel_spectrogram` runs the fused
kernel's plain PyTorch version (``mel_kernel.log10_mel_plain``: the DFT as a
matmul against the windowed cos/sin basis) and is the always-available path
(CPU tensors, or ``pad_to_chunk=False``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WhisperConfig

# ----------------------------------------------------------------------
# Constant builders (numpy)
# ----------------------------------------------------------------------


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window(n_fft)``."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)


def _hertz_to_mel_slaney(freq):
    """Slaney-style mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= min_log_hertz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
                    mels)


def _mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    freq)


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int,
                    min_frequency: float, max_frequency: float,
                    sampling_rate: int) -> np.ndarray:
    """Slaney-normalised triangular mel filter bank.

    Matches HF ``transformers.audio_utils.mel_filter_bank(norm='slaney',
    mel_scale='slaney')`` which is what ``WhisperFeatureExtractor`` uses.
    Returns ``(num_frequency_bins, num_mel_filters)`` float32.
    """
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = _hertz_to_mel_slaney(min_frequency)
    mel_max = _hertz_to_mel_slaney(max_frequency)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz_slaney(mel_pts)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    # Slaney energy normalisation.
    enorm = 2.0 / (filter_freqs[2: num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def stft_basis(n_fft: int) -> np.ndarray:
    """Windowed DFT basis: ``(2*n_freq, n_fft)`` rows = [cos_k ; -sin_k] * hann.

    ``frames @ basis.T`` yields ``[re_0..re_200, im_0..im_200]`` per frame, so the
    power spectrum is ``re**2 + im**2``.
    """
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    win = hann_window(n_fft).astype(np.float64)
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * win[None, :]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=8)
def folded_stft_basis(n_fft: int) -> np.ndarray:
    """The windowed DFT basis folded on the window's symmetry:
    ``(2, n_fft//2, n_freq)``, [cos rows ; -sin rows] over k.

    The periodic Hann window has w[n] = w[n_fft - n] and w[0] = 0, so with
    a[n] = x[n] + x[n_fft - n] and d[n] = x[n] - x[n_fft - n] the real and
    imaginary parts of a frame's DFT are ``a' @ basis[0]`` and
    ``d' @ basis[1]``, where row 0 of both operands is the middle sample
    x[n_fft/2] (row 0 of the basis is column n_fft/2 of :func:`stft_basis`)
    and row n = 1 .. n_fft/2 - 1 is a[n] or d[n].  Half the multiply-adds of
    the dense basis; built in float64 and cast to float32, as
    :func:`stft_basis`.
    """
    half = n_fft // 2
    n = np.concatenate([[half], np.arange(1, half)]).astype(np.float64)
    k = np.arange(half + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n[:, None] * k / n_fft
    win = hann_window(n_fft).astype(np.float64)[n.astype(np.int64), None]
    basis = np.stack([np.cos(ang), -np.sin(ang)]) * win[None]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=8)
def whisper_mel_filters(num_mel_bins: int, n_fft: int = 400,
                        sampling_rate: int = 16000) -> np.ndarray:
    """The exact filter bank Whisper uses: 0..8 kHz, slaney/slaney. (201, n_mels)."""
    return mel_filter_bank(
        num_frequency_bins=1 + n_fft // 2,
        num_mel_filters=num_mel_bins,
        min_frequency=0.0,
        max_frequency=float(sampling_rate) / 2.0,
        sampling_rate=sampling_rate,
    )


# ----------------------------------------------------------------------
# PyTorch compute path
# ----------------------------------------------------------------------


def pad_or_trim(audio: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Zero-pad or truncate the trailing time axis to ``n_samples``."""
    t = audio.shape[-1]
    if t >= n_samples:
        return audio[..., :n_samples]
    return F.pad(audio, (0, n_samples - t))


def compress(log_spec: torch.Tensor) -> torch.Tensor:
    """Per-sample dynamic-range clamp (max - 8) and (x + 4) / 4 scaling: the
    reference extractor is called per waveform, so the max is over each
    sample's whole spectrogram."""
    max_val = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, max_val - 8.0) + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, cfg: WhisperConfig,
                        pad_to_chunk: bool = True) -> torch.Tensor:
    """Whisper log-mel features.  audio [T] or [B, T] -> [B, n_mels, 3000]."""
    if audio.ndim == 1:
        audio = audio[None]
    if pad_to_chunk:
        audio = pad_or_trim(audio, cfg.n_samples)
    from .mel_kernel import log10_mel_plain
    log_spec = log10_mel_plain(audio.to(torch.float32), cfg.num_mel_bins,
                               cfg.n_fft, cfg.hop_length, cfg.sampling_rate)
    return compress(log_spec)
