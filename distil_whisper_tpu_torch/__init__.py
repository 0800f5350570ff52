"""distil_whisper_tpu_torch — the PyTorch/CUDA port of distil_whisper_tpu.

The same Whisper stack (log-mel front-end, encoder-decoder with static KV
caches, greedy generation under the Whisper logits rules, chunked long-form
pipeline) written in PyTorch for one NVIDIA H100.  The module layout and the
function names follow ``distil_whisper_tpu`` so each module's counterpart is
easy to find; the two kernels that were Pallas TPU kernels there (the fused
log-mel and the encoder self-attention) are hand-written CUDA for Hopper
here (``csrc/``).  This package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .config import WhisperConfig, PRESETS  # noqa: F401
