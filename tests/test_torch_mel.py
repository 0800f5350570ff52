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
