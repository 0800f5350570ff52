"""Port WhisperPipeline vs the JAX pipeline with all five int8 flags (CPU,
fp32, the tiny random checkpoint): equal text short-form and chunked."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.pipeline import WhisperPipeline as JPipeline
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.pipeline import WhisperPipeline

INT8 = dict(quantize_encoder=True, quantize_decoder=True,
            quantize_lm_head=True, quantize_cross_kv=True,
            quantize_self_kv=True)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """Batch size 2 on both sides: JAX pads a ragged last batch to it and the
    port does not, and below batch 8 both take the exact lm head."""
    from helpers import make_tiny_checkpoint
    ck = make_tiny_checkpoint(tmp_path_factory.mktemp("pipe8") / "tiny")
    kw = dict(batch_size=2, max_new_tokens=16)
    jpipe = JPipeline(ck, dtype=jnp.float32,
                      cfg=JConfig.from_pretrained(ck).replace(**INT8), **kw)
    tpipe = WhisperPipeline(ck, dtype=torch.float32, device="cpu",
                            cfg=WhisperConfig.from_pretrained(ck).replace(**INT8),
                            **kw)
    assert "kernel_q" in tpipe.params["encoder"]["layers"]["fc1"]
    assert "tok_emb_q" in tpipe.params["decoder"]
    return jpipe, tpipe


@pytest.mark.parametrize("seconds", [5.0, 70.0])
def test_int8_text_matches_jax(pipes, seconds):
    jpipe, tpipe = pipes
    t = np.arange(int(seconds * 16000)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * (220 + 60 * np.sin(0.5 * t)) * t)
             + 0.02 * np.random.default_rng(0).standard_normal(t.shape)
             ).astype(np.float32)
    golden = jpipe(audio, language="en", return_timestamps=seconds > 30)
    ours = tpipe(audio, language="en", return_timestamps=seconds > 30)
    assert ours == golden
    assert isinstance(ours["text"], str)
