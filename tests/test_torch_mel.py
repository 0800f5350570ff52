"""Port log-mel front-end vs the JAX package (CPU).

The CPU path of the port's ``compute_mel`` is the fused kernel's plain
version; it is held against the JAX Pallas kernel run in interpret mode at
JAX's own tolerance (tests/test_pallas_kernels.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from distil_whisper_tpu.audio import mel as jmel
from distil_whisper_tpu.audio.mel_pallas import log_mel_spectrogram_fused
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu_torch.audio import compute_mel, mel as tmel
from distil_whisper_tpu_torch.audio import mel_kernel
from distil_whisper_tpu_torch.config import WhisperConfig


@pytest.mark.parametrize("n_mels", [80, 128])
def test_constants_equal_jax(n_mels):
    np.testing.assert_array_equal(tmel.hann_window(400), jmel.hann_window(400))
    np.testing.assert_array_equal(tmel.stft_basis(400), jmel.stft_basis(400))
    np.testing.assert_array_equal(tmel.whisper_mel_filters(n_mels),
                                  jmel.whisper_mel_filters(n_mels))
    np.testing.assert_array_equal(
        tmel.mel_filter_bank(201, n_mels, 0.0, 8000.0, 16000),
        jmel.mel_filter_bank(201, n_mels, 0.0, 8000.0, 16000))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_compute_mel_matches_fused_pallas_interpret(n_mels):
    cfg = WhisperConfig(num_mel_bins=n_mels)
    rng = np.random.default_rng(0)
    audio = (0.2 * rng.standard_normal((2, cfg.n_samples))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        golden = np.asarray(log_mel_spectrogram_fused(
            jnp.asarray(audio), JConfig(num_mel_bins=n_mels)))
    before = mel_kernel.log10_mel_fused.launches
    ours = compute_mel(audio, cfg, device="cpu").numpy()
    assert ours.shape == golden.shape == (2, n_mels, 3000)
    np.testing.assert_allclose(ours, golden, atol=2e-4, rtol=1e-4)
    # the CPU tensor took the plain version: no kernel launch was counted
    assert mel_kernel.log10_mel_fused.launches == before == 0


def test_unpadded_matches_log_mel_spectrogram():
    cfg = WhisperConfig()
    rng = np.random.default_rng(1)
    t = np.arange(5 * 16000) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 440.0 * t)
             + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
    golden = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), JConfig(),
                                                 pad_to_chunk=False))
    ours = compute_mel(audio, cfg, pad_to_chunk=False, device="cpu").numpy()
    assert ours.shape == golden.shape == (1, 80, 500)
    np.testing.assert_allclose(ours, golden, atol=2e-4, rtol=1e-4)


def test_fused_wrapper_on_cpu_is_plain_version():
    """log10_mel_fused hands a CPU tensor to its plain version unchanged."""
    rng = np.random.default_rng(2)
    audio = torch.from_numpy(
        (0.1 * rng.standard_normal((1, 16000))).astype(np.float32))
    np.testing.assert_array_equal(
        mel_kernel.log10_mel_fused(audio, 80).numpy(),
        mel_kernel.log10_mel_plain(audio, 80).numpy())
    assert mel_kernel.log10_mel_fused.launches == 0


def test_folded_basis_reproduces_dense_dft():
    """The folded basis (the CUDA kernel's DFT) gives the dense basis's
    re/im of random frames, in float64 up to rounding."""
    folded = tmel.folded_stft_basis(400).astype(np.float64)
    dense = tmel.stft_basis(400).astype(np.float64)
    assert folded.shape == (2, 200, 201)
    x = np.random.default_rng(3).standard_normal((64, 400))
    n = np.arange(1, 200)
    mid = x[:, 200:201]
    a = np.concatenate([mid, x[:, n] + x[:, 400 - n]], axis=1)
    d = np.concatenate([mid, x[:, n] - x[:, 400 - n]], axis=1)
    spec = x @ dense.T
    np.testing.assert_allclose(a @ folded[0], spec[:, :201], rtol=0, atol=1e-10)
    np.testing.assert_allclose(d @ folded[1], spec[:, 201:], rtol=0, atol=1e-10)


def _log10_mel_folded(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel's formulation in float32: fold each frame on the window's
    symmetry, then two products with the folded basis."""
    n_frames = audio.shape[-1] // 160
    x = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0]
    frames = x.unfold(-1, 400, 160)[:, :n_frames]
    n = torch.arange(1, 200)
    mid = frames[..., 200:201]
    a = torch.cat([mid, frames[..., n] + frames[..., 400 - n]], dim=-1)
    d = torch.cat([mid, frames[..., n] - frames[..., 400 - n]], dim=-1)
    basis = torch.from_numpy(tmel.folded_stft_basis(400))
    power = (a @ basis[0]) ** 2 + (d @ basis[1]) ** 2
    mel = power @ torch.from_numpy(tmel.whisper_mel_filters(n_mels))
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_folded_log_mel_matches_plain(n_mels):
    """In float32, log-mel through the folded DFT is within the kernel's
    tolerance (2e-4 after compress) of the plain version's dense DFT."""
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(
        (0.2 * rng.standard_normal((2, 5 * 16000))).astype(np.float32))
    ours = tmel.compress(_log10_mel_folded(audio, n_mels))
    ref = tmel.compress(mel_kernel.log10_mel_plain(audio, n_mels))
    assert ours.shape == ref.shape == (2, n_mels, 500)
    torch.testing.assert_close(ours, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filter_bands_cover_every_nonzero_weight(n_mels):
    """The kernel multiplies each group of 8 mels over its band of bins only:
    every weight outside the band is zero, and the band's ends are not."""
    filters = tmel.whisper_mel_filters(n_mels)
    bands = mel_kernel.filter_bands(filters)
    assert bands.shape == (n_mels // 8, 2) and bands.dtype == np.int32
    for g, (lo, hi) in enumerate(bands):
        block = filters[:, 8 * g:8 * g + 8]
        assert 0 <= lo < hi <= filters.shape[0]
        assert not block[:lo].any() and not block[hi:].any()
        assert block[lo].any() and block[hi - 1].any()
    # band-limited products are the dense products
    power = np.random.default_rng(7).random((6, filters.shape[0])).astype(np.float32)
    banded = np.concatenate([power[:, lo:hi] @ filters[lo:hi, 8 * g:8 * g + 8]
                             for g, (lo, hi) in enumerate(bands)], axis=1)
    np.testing.assert_allclose(banded, power @ filters, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [160, 170, 200, 201])
def test_short_whole_file_matches_jax(n):
    """160-200 samples give one frame whose padding reflects more than once
    (``jnp.pad(mode="reflect")``); the port's whole-file features equal
    JAX's there and just past it."""
    audio = (0.2 * np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)
    golden = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), JConfig(),
                                                 pad_to_chunk=False))
    ours = compute_mel(audio, WhisperConfig(), pad_to_chunk=False,
                       device="cpu").numpy()
    assert ours.shape == golden.shape == (1, 80, 1)
    np.testing.assert_allclose(ours, golden, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 100, 159])
def test_fewer_than_160_samples_raise(n):
    audio = np.zeros(n, np.float32)
    with pytest.raises(ValueError):
        np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), JConfig(),
                                            pad_to_chunk=False))
    with pytest.raises(ValueError):
        compute_mel(audio, WhisperConfig(), pad_to_chunk=False, device="cpu")


@pytest.mark.parametrize("n", [160, 171, 200])
def test_short_input_index_rebuilds_the_first_frame(n):
    """For 200 samples or fewer the wrapper gives the kernel 201 samples of
    the reflect-padded signal (``short_input_index``); the kernel's single
    reflection of them (``csrc/mel.cu``: a -> -a left, 2(n-1) - a right)
    rebuilds the padded signal's first frame, which the plain version
    reads."""
    x = np.random.default_rng(n).standard_normal(n)
    padded = x[mel_kernel.reflect_index(n, 200)]
    given = x[mel_kernel.short_input_index(n)]
    m = len(given)
    a = np.arange(400) - 200
    a = np.where(a < 0, -a, a)
    a = np.where(a >= m, 2 * (m - 1) - a, a)
    np.testing.assert_array_equal(given[np.clip(a, 0, m - 1)], padded[:400])
