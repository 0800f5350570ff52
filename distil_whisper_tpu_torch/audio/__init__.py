import torch

from .mel import log_mel_spectrogram, mel_filter_bank, whisper_mel_filters, pad_or_trim  # noqa: F401
from .mel_kernel import log_mel_spectrogram_fused  # noqa: F401
from ..device import resolve_device


def compute_mel(audio, cfg, pad_to_chunk: bool = True, device="cuda"):
    """Log-mel features [B, n_mels, 3000] of audio [T] or [B, T] (numpy or
    tensor), computed on ``device``.

    As in the JAX package: 30 s windows (``pad_to_chunk``) on the card go
    through the fused CUDA kernel; CPU tensors and ``pad_to_chunk=False`` take
    the plain PyTorch path."""
    dev = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(dev)
    if dev.type == "cuda" and pad_to_chunk:
        return log_mel_spectrogram_fused(audio, cfg, pad_to_chunk=True)
    return log_mel_spectrogram(audio, cfg, pad_to_chunk=pad_to_chunk)
