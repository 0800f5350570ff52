import torch

from .mel import log_mel_spectrogram, mel_filter_bank, whisper_mel_filters, pad_or_trim  # noqa: F401
from .mel_kernel import log_mel_spectrogram_fused  # noqa: F401
from ..device import resolve_device


def compute_mel(audio, cfg, pad_to_chunk: bool = True, device="cuda"):
    """Log-mel features of audio [T] or [B, T] (numpy or tensor), computed on
    ``device``: [B, n_mels, 3000] for 30 s windows (``pad_to_chunk``), else
    [B, n_mels, T // 160] over the whole input (sequential long-form).

    On the card every length goes through the fused CUDA kernel; the plain
    PyTorch path runs for the CPU only."""
    dev = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    if dev.type == "cuda":
        return log_mel_spectrogram_fused(audio, cfg, pad_to_chunk=pad_to_chunk)
    return log_mel_spectrogram(audio, cfg, pad_to_chunk=pad_to_chunk)
