"""Port ``run_eval`` vs the JAX CLI (CPU, fp32) on a JSONL manifest of WAV
files and the tiny checkpoint: ``--mode short``, ``chunked`` and
``sequential`` give the JAX CLI's WER and hypotheses; ``--mode
speculative`` (draft and n-gram) gives the hypotheses of the JAX CLI's
short mode, and the speculation flags of the sequential and chunked modes
leave their hypotheses as they were.  Also: the copied normalizers and WER equal the
JAX package's, JAX's argument errors raise, and ``--distributed`` fails
fast without a multi-GPU job."""

import json
import logging
import re

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from distil_whisper_tpu.cli.run_eval import main as j_main
from distil_whisper_tpu.metrics.wer import count_repeated_ngrams as j_repeats
from distil_whisper_tpu.metrics.wer import process_words as j_process_words
from distil_whisper_tpu.metrics.wer import wer as j_wer
from distil_whisper_tpu.tokenizer import normalizers as JN
from distil_whisper_tpu_torch.audio.io import write_wav
from distil_whisper_tpu_torch.cli import run_eval, run_long_form_transcription
from distil_whisper_tpu_torch.cli.common import load_dataset_any
from distil_whisper_tpu_torch.metrics import (count_repeated_ngrams,
                                               process_words, wer)
from distil_whisper_tpu_torch.tokenizer import normalizers as TN

SR = 16000
# one JAX CLI run a mode; the two long-form modes read a 40 s file
MODES = {"short": "short", "chunked": "long", "sequential": "long"}
COMMON = ["--language", "en", "--batch_size", "2", "--max_new_tokens", "16",
          "--dtype", "float32", "--temperature_fallback", "0.0",
          "--chunk_length_s", "20"]


def _tone(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def _manifest(tmp, name, clips):
    rows = []
    for j, (seconds, text) in enumerate(clips):
        wav = tmp / f"{name}{j}.wav"
        write_wav(str(wav), _tone(seconds, j), SR)
        rows.append({"audio": str(wav), "text": text})
    path = tmp / f"{name}.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from helpers import make_tiny_checkpoint
    tmp = tmp_path_factory.mktemp("eval")
    ck = make_tiny_checkpoint(tmp / "tiny")
    data = {"short": _manifest(tmp, "short", [(3.0, "the cat sat"),
                                              (6.0, "a dog ran fast")]),
            "long": _manifest(tmp, "long", [(40.0, "hello world now"),
                                            (5.0, "we are here")])}
    data["draft"] = make_tiny_checkpoint(tmp / "draft", decoder_layers=1,
                                         seed=1)
    golden = {}
    for mode, which in MODES.items():
        out = tmp / f"jax_{mode}.json"
        j_main(["--model_checkpoint", ck, "--dataset_path", data[which],
                "--mode", mode, "--output_json", str(out)] + COMMON)
        golden[mode] = json.loads(out.read_text())
    return ck, data, tmp, golden


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_eval_matches_jax(setup, mode):
    ck, data, tmp, golden = setup
    out = tmp / f"torch_{mode}.json"
    res = run_eval.main(["--model_checkpoint", ck, "--dataset_path",
                         data[MODES[mode]], "--mode", mode, "--device", "cpu",
                         "--output_json", str(out)] + COMMON)
    ours, ref = json.loads(out.read_text()), golden[mode]
    assert ours["predictions"] == ref["predictions"]
    assert ours["references"] == ref["references"]
    for key in ("wer", "ier", "ser", "der", "repeated_5grams", "num_samples",
                "audio_seconds"):
        assert ours[key] == ref[key], key
    assert res["mode"] == ref["mode"] == mode
    assert sorted(res) == sorted(k for k in ref
                                 if k not in ("predictions", "references"))


def test_long_form_cli_defaults_to_chunked(setup):
    ck, data, _, golden = setup
    res = run_long_form_transcription.main(
        ["--model_checkpoint", ck, "--dataset_path", data["long"],
         "--device", "cpu"] + COMMON)
    assert res["mode"] == "chunked" and res["wer"] == golden["chunked"]["wer"]


def test_unported_modes_raise(setup):
    """Speculation and ``--distributed`` are ported now: ``--distributed``
    without a multi-GPU job fails fast (as JAX's), and JAX's argument
    errors raise (the n-gram method with a draft checkpoint, the
    speculative mode's draft method without one) and the speculative mode
    with beam search."""
    ck, data, _, _ = setup
    base = ["--model_checkpoint", ck, "--dataset_path", data["short"],
            "--device", "cpu"]
    with pytest.raises(RuntimeError, match="no multi-GPU job"):
        run_eval.main(base + ["--distributed"])
    for extra in (["--mode", "speculative"],
                  ["--mode", "sequential", "--speculative_method", "ngram",
                   "--assistant_checkpoint", data["draft"]],
                  ["--mode", "speculative", "--speculative_method", "ngram",
                   "--num_beams", "2"]):
        with pytest.raises(ValueError):
            run_eval.main(base + extra)


def _rate(caplog, name):
    rates = [re.search(r"acceptance rate: ([0-9.]+)%", r.getMessage())
             for r in caplog.records if r.name == name]
    rates = [float(m.group(1)) for m in rates if m]
    assert len(rates) == 1, rates
    return rates[0]


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_speculative_mode_matches_jax(setup, caplog, method):
    """``--mode speculative`` emits the greedy tokens: the JAX CLI's
    hypotheses and WER of ``--mode short`` (which JAX's speculative mode
    reproduces token for token), and it logs its acceptance rate."""
    ck, data, tmp, golden = setup
    flags = (["--assistant_checkpoint", data["draft"]] if method == "draft"
             else ["--speculative_method", "ngram"])
    out = tmp / f"torch_spec_{method}.json"
    caplog.set_level(logging.INFO)
    res = run_eval.main(["--model_checkpoint", ck, "--dataset_path",
                         data["short"], "--mode", "speculative", "--gamma",
                         "3", "--device", "cpu", "--output_json", str(out)]
                        + flags + COMMON)
    ours, ref = json.loads(out.read_text()), golden["short"]
    assert ours["predictions"] == ref["predictions"]
    for key in ("wer", "num_samples", "audio_seconds"):
        assert ours[key] == ref[key], key
    assert res["mode"] == "speculative"
    assert 0.0 <= _rate(caplog, "distil_whisper_tpu_torch") <= 100.0


@pytest.mark.parametrize("mode,flags", [
    ("sequential", ["--speculative_method", "ngram"]),
    ("chunked", ["--speculative_method", "ngram"]),
    ("sequential", ["--assistant_checkpoint", "draft"])])
def test_speculation_flags_keep_hypotheses(setup, caplog, mode, flags):
    """Speculation in the sequential and chunked modes emits the greedy
    tokens: the same hypotheses as the JAX CLI's plain run of the mode."""
    ck, data, tmp, golden = setup
    flags = [data.get(f, f) for f in flags]
    out = tmp / f"torch_{mode}_{flags[1]}.json"
    caplog.set_level(logging.INFO)
    run_eval.main(["--model_checkpoint", ck, "--dataset_path", data["long"],
                   "--mode", mode, "--device", "cpu", "--gamma", "3",
                   "--output_json", str(out)] + flags + COMMON)
    assert json.loads(out.read_text())["predictions"] == \
        golden[mode]["predictions"]
    assert 0.0 <= _rate(caplog, "distil_whisper_tpu_torch") <= 100.0


def test_manifest_reader_needs_no_datasets(tmp_path):
    path = tmp_path / "m.jsonl"
    rows = [{"audio": {"array": [0.0, 0.5], "sampling_rate": 16000},
             "text": "a"}, {"audio": "x.wav", "text": "b"}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert load_dataset_any(str(path)) == rows


def test_normalizers_equal_jax():
    """On the strings of tests/test_normalizers.py."""
    import test_normalizers
    strings = list(test_normalizers.BATTERY)
    spelling = {"colour": "color", "favourite": "favorite"}
    pairs = [(TN.EnglishTextNormalizer(spelling),
              JN.EnglishTextNormalizer(spelling)),
             (TN.BasicTextNormalizer(), JN.BasicTextNormalizer()),
             (TN.BasicTextNormalizer(remove_diacritics=True),
              JN.BasicTextNormalizer(remove_diacritics=True)),
             (TN.EnglishNumberNormalizer(), JN.EnglishNumberNormalizer())]
    for ours, ref in pairs:
        assert [ours(s) for s in strings] == [ref(s) for s in strings]


# the pairs of tests/test_wer.py, and a few more
WER_PAIRS = [("the cat sat", "the cat sat"), ("a b c d", "a x c"),
             ("a b", "a q b"), ("a b", "a b"), ("c d", "c x"), ("a b c", ""),
             ("this is a test", "this is the test"),
             (" ".join(["a b c d e"] * 3), " ".join(["a b c d e"] * 3)),
             ("the cat sat on the mat", "the cat sat on mat"),
             ("one two three", "hello there one world three")]


def test_wer_equals_jax():
    import dataclasses
    refs, hyps = [r for r, _ in WER_PAIRS], [h for _, h in WER_PAIRS]
    for rs, hs in [(refs, hyps)] + [([r], [h]) for r, h in WER_PAIRS]:
        assert (dataclasses.asdict(process_words(rs, hs))
                == dataclasses.asdict(j_process_words(rs, hs)))
        assert wer(rs, hs) == j_wer(rs, hs)
    for text in hyps + ["a b c d e f g"]:
        for n in (1, 2, 5):
            assert count_repeated_ngrams(text, n) == j_repeats(text, n)
