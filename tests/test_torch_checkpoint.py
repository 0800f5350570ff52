"""The port's CheckpointManager, resume and save_pretrained (CPU).

Save / restore / rotation / best rotation as tests/test_checkpoint.py holds
JAX's Orbax manager; a resumed run continues bit for bit (params, moments,
counters and a half-accumulated gradient); ``save_pretrained`` writes a
checkpoint that JAX's ``load_params`` and transformers'
``WhisperForConditionalGeneration.from_pretrained`` load, with logits equal
to the port's at 1e-5.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models import load_params as j_load_params
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.models import (forward, init_params, load_params,
                                             save_pretrained)
from distil_whisper_tpu_torch.models.params import tree_paths
from distil_whisper_tpu_torch.training import (CheckpointManager,
                                               DistillConfig, OptimizerConfig,
                                               TrainState, build_train_step)

DIMS = dict(vocab_size=128, num_mel_bins=8, d_model=16, encoder_layers=1,
            decoder_layers=2, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=32, decoder_ffn_dim=32,
            max_source_positions=16, max_target_positions=16,
            pad_token_id=100, bos_token_id=100, eos_token_id=100,
            decoder_start_token_id=101)
CFG = WhisperConfig(**DIMS)


def _state(**opt):
    params = init_params(CFG, seed=0, device="cpu")
    return TrainState.create(params, OptimizerConfig(
        total_steps=10, **{"precision": "full", **opt}))


def _batch(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 128, (2, 6))
    labels[:, :2] = -100
    return {"input_features": torch.from_numpy(
                rng.standard_normal((2, 8, 32)).astype(np.float32)),
            "decoder_input_ids": torch.from_numpy(rng.integers(0, 128, (2, 6))),
            "labels": torch.from_numpy(labels)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(5, state, metadata={"epoch": 1})
    assert mgr.latest()[0] == 5
    assert json.loads((tmp_path / "checkpoint-5" / "meta.json").read_text()) \
        == {"step": 5, "epoch": 1}
    template = _state()
    with torch.no_grad():
        template.params["decoder"]["tok_emb"].zero_()
    step, restored = mgr.resume_latest(template)
    assert step == 5 and restored is template
    torch.testing.assert_close(restored.params["decoder"]["tok_emb"],
                               state.params["decoder"]["tok_emb"],
                               atol=0, rtol=0)
    assert CheckpointManager(str(tmp_path / "empty")).resume_latest(
        template) is None


def test_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_total_limit=2)
    state = _state()
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert [s for s, _ in mgr.all_checkpoints()] == [2, 3]


def test_best_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), best_total_limit=2)
    state = _state()
    mgr.save_best(1, state, 12.5)
    mgr.save_best(2, state, 10.0)
    mgr.save_best(3, state, 11.0)
    best = mgr.best_checkpoints()
    assert [round(w, 1) for w, _, _ in best] == [10.0, 11.0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint-2-val-wer-10.000", "checkpoint-3-val-wer-11.000"]


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_continues_bit_for_bit(tmp_path, accum):
    """Five steps straight, against three steps, a checkpoint, a fresh
    state restored from it and two more steps: every parameter, moment and
    counter identical (with accumulation 2 the checkpoint holds half an
    accumulated gradient)."""
    opt = dict(learning_rate=1e-2, warmup_steps=1, weight_decay=0.01,
               gradient_accumulation_steps=accum, precision="half_mixed",
               frozen_prefixes=("encoder",))
    step, _ = build_train_step(CFG, CFG, DistillConfig(),
                               OptimizerConfig(total_steps=10, **opt))
    teacher = init_params(CFG, seed=1, device="cpu")
    straight = _state(**opt)
    for i in range(5):
        straight, _ = step(straight, teacher, _batch(i))
    first = _state(**opt)
    for i in range(3):
        first, _ = step(first, teacher, _batch(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, first)
    _, resumed = mgr.resume_latest(_state(**opt))
    assert (resumed.step, resumed.count, resumed.mini_step) == \
        (first.step, first.count, first.mini_step)
    assert sorted(resumed.acc) == sorted(first.acc)
    for i in range(3, 5):
        resumed, _ = step(resumed, teacher, _batch(i))
    a, b = tree_paths(straight.params), tree_paths(resumed.params)
    for p in a:
        assert a[p].dtype == b[p].dtype
        assert torch.equal(a[p], b[p]), p
    for p in straight.mu:
        assert torch.equal(straight.mu[p], resumed.mu[p])
        assert torch.equal(straight.nu[p], resumed.nu[p])
    assert (straight.step, straight.count) == (resumed.step, resumed.count)


def test_restore_refuses_another_frozen_set(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(frozen_prefixes=("encoder",)))
    with pytest.raises(ValueError, match="frozen"):
        mgr.resume_latest(_state())


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jp = jax_init_params(JConfig(**DIMS), 3)
    params = torch_params(jp)
    out = tmp_path_factory.mktemp("export") / "ckpt"
    save_pretrained(params, CFG, str(out))
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((2, 8, 32)).astype(np.float32)
    tokens = rng.integers(0, 128, (2, 5))
    logits, _ = forward(params, CFG, torch.from_numpy(mel),
                        torch.from_numpy(tokens))
    return out, params, mel, tokens, logits.numpy()


def test_save_pretrained_round_trips_in_both_packages(exported):
    out, params, *_ = exported
    header_len = int.from_bytes((out / "model.safetensors").read_bytes()[:8],
                                "little")
    header = json.loads((out / "model.safetensors").read_bytes()[8:8 + header_len])
    assert header["__metadata__"] == {"format": "pt"}
    assert "proj_out.weight" in header
    jp, jcfg = j_load_params(str(out))
    tp, tcfg = load_params(str(out), device="cpu")
    assert tcfg == CFG and jcfg.d_model == CFG.d_model
    want = tree_paths(params)
    for p, x in j_tree_paths(jp).items():
        np.testing.assert_array_equal(np.asarray(x), want[p].numpy(), p)
    for p, x in tree_paths(tp).items():
        torch.testing.assert_close(x, want[p], atol=0, rtol=0)


def test_save_pretrained_loads_in_transformers(exported):
    from transformers import WhisperForConditionalGeneration
    out, _, mel, tokens, logits = exported
    model = WhisperForConditionalGeneration.from_pretrained(str(out)).eval()
    with torch.no_grad():
        hf = model(input_features=torch.from_numpy(mel),
                   decoder_input_ids=torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(hf.numpy(), logits, atol=1e-5, rtol=1e-5)
    # the tied head was written as its own copy of the embedding
    torch.testing.assert_close(model.proj_out.weight,
                               model.model.decoder.embed_tokens.weight)


def test_save_pretrained_bf16(tmp_path):
    params = init_params(CFG, seed=4, device="cpu")
    save_pretrained(params, CFG, str(tmp_path), dtype=torch.bfloat16)
    tp, _ = load_params(str(tmp_path), device="cpu")
    for p, x in tree_paths(params).items():
        torch.testing.assert_close(tree_paths(tp)[p],
                                   x.to(torch.bfloat16).float(), atol=0, rtol=0)
