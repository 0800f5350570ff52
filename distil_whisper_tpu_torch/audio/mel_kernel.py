"""Fused log-mel front-end: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/mel.cu``) replaces the Pallas TPU kernel of
``distil_whisper_tpu/audio/mel_pallas.py``: framing -> windowed-DFT -> power
-> mel projection -> log10 in one pass, so neither the [T, 400] frame matrix
nor the [T, 402] spectrum reaches device memory.  The per-sample max clamp and
(x+4)/4 scaling are a cheap epilogue (``mel.compress``), as in JAX.  The
kernel folds the DFT on the Hann window's symmetry (``mel.folded_stft_basis``)
and multiplies each group of 8 mel filters over its band of nonzero bins only
(:func:`filter_bands`): the same function as the plain version.

:func:`log10_mel_fused` launches the kernel for a CUDA tensor and runs
:func:`log10_mel_plain` (the same arithmetic in plain PyTorch) for a CPU
tensor; anything else raises.  ``log10_mel_fused.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import WhisperConfig
from ..ops import _build
from .mel import (compress, folded_stft_basis, pad_or_trim, stft_basis,
                  whisper_mel_filters)

_N_FFT = 400
_HOP = 160
_BINS_PADDED = 208          # the kernel's 201 bins in 26 groups of 8


def reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of numpy's (and ``jnp.pad``'s) reflect padding of ``n``
    samples by ``pad`` on each side, reflecting again while the pad is not
    shorter than the input: ``x[reflect_index(n, pad)]`` is the padded
    signal."""
    return np.pad(np.arange(n), pad, mode="reflect")


def _check_frames(n: int, hop: int) -> int:
    if n < hop:
        raise ValueError(f"log-mel of {n} samples: fewer than the hop of "
                         f"{hop} samples give no frame")
    return n // hop


def log10_mel_plain(audio: torch.Tensor, num_mel_bins: int, n_fft: int = 400,
                    hop: int = 160, sampling_rate: int = 16000) -> torch.Tensor:
    """``log10(max(mel, 1e-10))`` of fp32 audio [B, N] -> [B, n_mels, N // hop].

    torch.stft(center=True) semantics: reflect-pad n_fft//2 on both sides; the
    reference drops the final frame, so only ``N // hop`` frames are computed.
    An input of ``n_fft // 2`` samples or fewer is reflected again past its
    ends (:func:`reflect_index`), as ``jnp.pad`` does.  Frames are gathered,
    multiplied by the windowed DFT basis, squared into power, projected onto
    the mel filters and logged — all in fp32.
    """
    n_frames = _check_frames(audio.shape[-1], hop)
    if audio.shape[-1] > n_fft // 2:
        x = torch.nn.functional.pad(audio[:, None], (n_fft // 2, n_fft // 2),
                                    mode="reflect")[:, 0]
    else:
        idx = reflect_index(audio.shape[-1], n_fft // 2)
        x = audio[:, torch.from_numpy(idx).to(audio.device)]
    frames = x.unfold(-1, n_fft, hop)[:, :n_frames]            # [B, T, n_fft]
    basis = torch.from_numpy(stft_basis(n_fft)).to(audio.device)
    spec = torch.matmul(frames, basis.T)                       # [B, T, 2*n_freq]
    n_freq = n_fft // 2 + 1
    power = spec[..., :n_freq] ** 2 + spec[..., n_freq:] ** 2  # [B, T, n_freq]
    filters = torch.from_numpy(
        whisper_mel_filters(num_mel_bins, n_fft, sampling_rate)).to(audio.device)
    mel = torch.matmul(power, filters)                         # [B, T, n_mels]
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def short_input_index(n: int) -> np.ndarray:
    """For an input of ``n <= 200`` samples: the indices of ``n_fft // 2 + 1
    = 201`` samples of its reflect-padded signal, starting at the first
    input sample, that the kernel takes as its input.  The padded signal is
    symmetric about the first sample, so the kernel's own single reflection
    of these 201 samples rebuilds the padded signal's first frame (the only
    frame of 160-200 samples)."""
    pad = _N_FFT // 2
    return reflect_index(n, pad)[pad:2 * pad + 1]


def filter_bands(filters: np.ndarray, group: int = 8) -> np.ndarray:
    """``[n_mels // group, 2]`` int32: for each group of ``group`` mel
    filters, the half-open range of bins where any of them is nonzero (the
    kernel multiplies over these rows only; the others add exact zeros)."""
    n_bins, n_mels = filters.shape
    nz = filters.reshape(n_bins, n_mels // group, group).any(axis=2)  # [bin, g]
    lo = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    hi = np.where(nz.any(axis=0), n_bins - nz[::-1].argmax(axis=0), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _device_constants(num_mel_bins: int, device: torch.device):
    """(folded basis [2, 200, 208], filters [201, n_mels], bands
    [n_mels / 8, 2]) on ``device``: the basis's 201 bins are padded with
    zero columns to 26 groups of 8."""
    folded = folded_stft_basis(_N_FFT)
    basis = np.zeros(folded.shape[:2] + (_BINS_PADDED,), np.float32)
    basis[..., :folded.shape[2]] = folded
    filters = whisper_mel_filters(num_mel_bins)
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(filters).to(device),
            torch.from_numpy(filter_bands(filters)).to(device))


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("mel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dw_log_mel.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.dw_log_mel.restype = ctypes.c_int
    return lib


def log10_mel_fused(audio: torch.Tensor, num_mel_bins: int) -> torch.Tensor:
    """``log10(max(mel, 1e-10))`` of fp32 audio [B, N] -> [B, n_mels, N // 160]
    through the CUDA kernel (a CPU tensor takes :func:`log10_mel_plain`)."""
    if audio.device.type == "cpu":
        return log10_mel_plain(audio, num_mel_bins, _N_FFT, _HOP)
    if audio.device.type != "cuda":
        raise ValueError(f"log10_mel_fused: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.ndim != 2:
        raise ValueError("log10_mel_fused wants fp32 audio [B, N], got "
                         f"{audio.dtype} {tuple(audio.shape)}")
    if num_mel_bins % 8:
        raise ValueError("log10_mel_fused: the kernel takes a multiple of 8 "
                         f"mel bins, got {num_mel_bins}")
    n_frames = _check_frames(audio.shape[1], _HOP)
    if audio.shape[1] <= _N_FFT // 2:
        # the kernel reflects once; repeated reflection is padded on the
        # card before it (no plain version on a CUDA tensor)
        idx = torch.from_numpy(short_input_index(audio.shape[1]))
        audio = audio[:, idx.to(audio.device)]
    audio = audio.contiguous()
    b, n = audio.shape
    basis, filters, bands = _device_constants(num_mel_bins, audio.device)
    out = torch.empty((b, num_mel_bins, n_frames), dtype=torch.float32,
                      device=audio.device)
    # the .so launches on the CUDA runtime's current card
    with torch.cuda.device(audio.device):
        err = _lib().dw_log_mel(
            audio.data_ptr(), basis.data_ptr(), filters.data_ptr(),
            bands.data_ptr(), out.data_ptr(), b, n, n_frames, num_mel_bins,
            torch.cuda.current_stream(audio.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mel kernel launch failed (cudaError {err})")
    _build.count_launch(log10_mel_fused)
    return out


log10_mel_fused.launches = 0


def log_mel_spectrogram_fused(audio: torch.Tensor, cfg: WhisperConfig,
                              pad_to_chunk: bool = True) -> torch.Tensor:
    """Drop-in for ``mel.log_mel_spectrogram`` through the fused kernel:
    audio [T] or [B, T] -> [B, n_mels, 3000], or [B, n_mels, T // 160]
    without ``pad_to_chunk``."""
    if (cfg.n_fft, cfg.hop_length) != (_N_FFT, _HOP):
        raise ValueError("the fused mel kernel is built for n_fft 400, hop 160")
    if audio.ndim == 1:
        audio = audio[None]
    if pad_to_chunk:
        audio = pad_or_trim(audio, cfg.n_samples)
    return compress(log10_mel_fused(audio.to(torch.float32), cfg.num_mel_bins))
