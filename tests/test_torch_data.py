"""The port's training-data pipeline vs the JAX package's
(tests/test_data.py's cases, both packages on the same inputs): the
collator's masking, the WER filter, label preparation under the same numpy
generator (timestamp and condition-on-prev draws), the prompt cutoff,
timestamp rounding, speaker-aware packing and the length gates; plus the
port's dataset-spec parsing and interleaving against ``datasets``."""

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from distil_whisper_tpu.tokenizer import EnglishTextNormalizer as JNorm
from distil_whisper_tpu.tokenizer import WhisperTokenizer as JTok
from distil_whisper_tpu.tokenizer.bpe import ByteLevelBPE as JBPE
from distil_whisper_tpu.tokenizer.bpe import bytes_to_unicode
from distil_whisper_tpu.training import data as JD
from distil_whisper_tpu.cli import common as JC
from distil_whisper_tpu_torch.cli import common as TC
from distil_whisper_tpu_torch.tokenizer import EnglishTextNormalizer as TNorm
from distil_whisper_tpu_torch.tokenizer import WhisperTokenizer as TTok
from distil_whisper_tpu_torch.tokenizer.bpe import ByteLevelBPE as TBPE
from distil_whisper_tpu_torch.training import data as TD

SOT = 50258
PAD = 50257
ADDED = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
         "<|en|>": 50259, "<|fr|>": 50265,
         "<|translate|>": 50358, "<|transcribe|>": 50359,
         "<|startoflm|>": 50360, "<|startofprev|>": 50361,
         "<|nospeech|>": 50362, "<|notimestamps|>": 50363}


@pytest.fixture(scope="module")
def toks():
    vocab = {u: i for i, u in enumerate(bytes_to_unicode().values())}
    return JTok(JBPE(vocab, []), dict(ADDED)), TTok(TBPE(vocab, []), dict(ADDED))


@pytest.mark.parametrize("multiple", [None, 8])
def test_shift_and_mask_matches_jax(multiple):
    label_ids = [[SOT, 11, 12, 13, PAD],
                 [50361, 7, 8, SOT, 21, 22, PAD],
                 [SOT, 31, PAD]]
    kw = dict(decoder_start_token_id=SOT, pad_token_id=PAD,
              max_target_length=448, pad_to_multiple_of=multiple)
    j, t = JD.shift_and_mask(label_ids, **kw), TD.shift_and_mask(label_ids, **kw)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype


@pytest.mark.parametrize("gt,pl,thr", [
    ("the cat sat on the mat", "the cat sat on the mat", 10.0),
    ("the cat sat on the mat", "a dog stood near a door", 10.0),
    ("the cat sat on the mat", "the cat sat on a mat", 20.0),
    ("hello world", "HELLO WORLD", 100.0),
    ("hello", None, 10.0),
    ("", "something", 10.0)])
def test_wer_filter_matches_jax(gt, pl, thr):
    assert (TD.is_wer_in_range(gt, pl, TNorm({}), thr)
            == JD.is_wer_in_range(gt, pl, JNorm({}), thr))


TRANSCRIPTS = [
    ("the world", False),
    ("<|startoftranscript|><|en|><|transcribe|><|0.00|> abc<|2.00|>"
     "<|2.00|> de<|4.46|><|endoftext|>", True),
    ("<|startoftranscript|><|en|><|transcribe|><|notimestamps|> plain"
     "<|endoftext|>", True)]


@pytest.mark.parametrize("ts_prob,prev_prob,round_ts", [
    (0.0, 0.0, False), (1.0, 1.0, True), (0.5, 0.5, False)])
def test_prepare_labels_matches_jax(toks, ts_prob, prev_prob, round_ts):
    """Every transcript kind, 20 draws each from one generator seed: the
    same ids (timestamp keep / strip, <|notimestamps|> insertion, prompt
    conditioning and its cutoff, rounding)."""
    jt, tt = toks
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    prev = list(range(300, 700))
    for _ in range(20):
        for text, pseudo in TRANSCRIPTS:
            kw = dict(is_pseudo_label=pseudo, language="en",
                      prev_ids=prev, timestamp_probability=ts_prob,
                      condition_on_prev_probability=prev_prob,
                      max_label_length=64, round_timestamps=round_ts)
            assert (TD.prepare_labels(tt, text, rng=tr, **kw)
                    == JD.prepare_labels(jt, text, rng=jr, **kw))


def test_round_timestamp_ids_and_prev_prompt_match_jax(toks):
    jt, tt = toks
    ids = [50364, 50364 + 7, 50364 + 12, 65, 50364 + 223, 50364 + 1500]
    assert (TD.round_timestamp_ids(ids, 50364)
            == JD.round_timestamp_ids(ids, 50364))
    gen = [SOT, 50259, 50359, 65, 66, PAD]
    assert (TD.prev_prompt_from_output(tt, gen)
            == JD.prev_prompt_from_output(jt, gen) == [50361, 65, 66])


def test_collator_matches_jax():
    samples = [{"input_features": np.full((8, 30), i, np.float32),
                "labels": [SOT] + list(range(1, 3 + 4 * i)) + [PAD]}
               for i in range(3)]
    kw = dict(decoder_start_token_id=SOT, pad_token_id=PAD,
              max_target_length=448, pad_target_to_multiple_of=32)
    j, t = JD.Collator(**kw)(samples), TD.Collator(**kw)(samples)
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    assert t["decoder_input_ids"].shape[1] == 31


def test_pack_samples_matches_jax():
    sr = 16000
    rng = np.random.default_rng(0)
    samples = [{"audio": rng.standard_normal(int(s * sr)).astype(np.float32),
                "text": f"t{i}", "speaker_id": spk}
               for i, (s, spk) in enumerate([(10, "a"), (10, "a"), (15, "a"),
                                             (5, "b"), (29, "b"), (1, "b")])]
    j = JD.pack_samples(samples, max_input_samples=30 * sr)
    t = TD.pack_samples(samples, max_input_samples=30 * sr)
    assert len(t) == len(j) == 4
    for a, b in zip(t, j):
        assert (a["text"], a["speaker_id"], a["condition_on_prev"]) == \
            (b["text"], b["speaker_id"], b["condition_on_prev"])
        np.testing.assert_array_equal(a["audio"], b["audio"])
    assert [p["text"] for p in TD.pack_samples_iter(iter(samples), 30 * sr)] \
        == [p["text"] for p in j]


@pytest.mark.parametrize("args", [(16000, 10, 8000, 480000, 2, 448),
                                  (16000, 1, 8000, 480000, 2, 448),
                                  (480000, 10, 8000, 480000, 2, 448)])
def test_length_range_matches_jax(args):
    assert TD.in_length_range(*args) == JD.in_length_range(*args)


@pytest.mark.parametrize("spec", [("a", None, None),
                                  ("a+b", "train+validation", "0.7+0.3"),
                                  ("a+b+c", None, None)])
def test_parse_dataset_spec_matches_jax(spec):
    assert TC.parse_dataset_spec(*spec) == JC.parse_dataset_spec(*spec)
    with pytest.raises(ValueError):
        TC.parse_dataset_spec("a+b", "train", None)


@pytest.mark.parametrize("strategy", ["all_exhausted", "first_exhausted"])
def test_load_multiple_jsonl_interleaves_as_datasets(tmp_path, strategy):
    """Two JSONL manifests interleave, read with the standard library, in
    the order ``datasets.interleave_datasets`` gives the same rows (the
    JAX trainer's order)."""
    import datasets
    a = [{"text": f"a{i}"} for i in range(7)]
    b = [{"text": f"b{i}"} for i in range(3)]
    TC.write_jsonl(str(tmp_path / "a.jsonl"), a)
    TC.write_jsonl(str(tmp_path / "b.jsonl"), b)
    ours = TC.load_multiple_datasets(
        f"{tmp_path}/a.jsonl+{tmp_path}/b.jsonl", probabilities="0.6+0.4",
        seed=5, stopping_strategy=strategy)
    golden = datasets.interleave_datasets(
        [datasets.Dataset.from_list(a), datasets.Dataset.from_list(b)],
        probabilities=[0.6, 0.4], seed=5, stopping_strategy=strategy)
    assert [r["text"] for r in ours] == golden["text"]
    assert TC.load_multiple_datasets(str(tmp_path / "a.jsonl")) == a


def test_copy_tokenizer_files(tmp_path):
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    for name in ("vocab.json", "merges.txt", "model.safetensors"):
        (src / name).write_text(name)
    TC.copy_tokenizer_files(str(src), str(dst))
    assert sorted(p.name for p in dst.iterdir()) == ["merges.txt",
                                                      "vocab.json"]
    assert TC.TOKENIZER_FILES == JC.TOKENIZER_FILES
