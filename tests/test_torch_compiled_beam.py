"""Beam search as a compiled loop (CPU, fp32, tiny widths).

On the card beam search replays its prefill and blocks of steps as CUDA
graphs; on the CPU the same body runs eagerly, which is what these tests
hold:

* the blocked loop against the plain loop (``beam_search_eager``) bit for
  bit on every output field, for blocks of 1, 3 and 16 steps: 2 and 4
  beams, timestamps, left-padded prompts with an SOT slot, an int8
  self-KV cache, length penalties 0.5 and 2.0, a budget of 10, and every
  hypothesis finishing early;
* both routes against JAX's beam search under the two length penalties
  (``tests/test_torch_beam.py`` holds the other cases);
* the device cursor's length penalty equal to the plain loop's;
* one host read a block, and a stop before the budget when every
  hypothesis has finished;
* that the prefill's warm-up leaves the block and the output reading
  nothing from the device (a capture would fail on the card);
* the program keys: the beams, the length penalty and the rows each make
  another program, equal shapes the same one;
* that the callers hand their encoder states and their owners to the
  loop, the labelling run one owner and full batches, and that no tree
  branches to the plain loop (sharded ones run the blocked loop too).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from test_torch_compiled_decode import no_host_reads  # noqa: F401
from torch_port_helpers import jax_init_params, tone, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation.beam import \
    encode_and_beam_search as j_beam
from distil_whisper_tpu_torch import pipeline as TP
from distil_whisper_tpu_torch import serving as TS
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import GenerationOptions
from distil_whisper_tpu_torch.generation import beam as B
from distil_whisper_tpu_torch.generation import graphs as TGR
from distil_whisper_tpu_torch.models import load_params
from distil_whisper_tpu_torch.models import whisper as TW
from distil_whisper_tpu_torch.pipeline import WhisperPipeline

# tests/test_torch_beam.py's widths and vocabulary tail
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
CFG = WhisperConfig(**ARCH)
PROMPT = [[3, 310, 320], [3, 310, 320]]
# condition-on-prev layout: [pad | <|startofprev|> ctx | SOT ...], SOT at 3
PADDED = [[0, 0, 0, 3, 310, 320], [0, 390, 17, 3, 310, 320]]
PAD_LEN, SOT_SLOT = [3, 1], 3

# name: (tree, beams, timestamps, padded, int8 self-KV, length penalty,
# budget).  The "eos" tree finishes hypotheses at different lengths; in
# the "early" one every hypothesis finishes within a few steps
CASES = {
    "k2": ("eos", 2, False, False, False, 1.0, 20),
    "k4": ("eos", 4, False, False, False, 1.0, 20),
    "k4_timestamps": ("eos", 4, True, False, False, 1.0, 20),
    "k2_padded_timestamps": ("eos", 2, True, True, False, 1.0, 20),
    "k4_int8_self_kv": ("eos", 4, False, True, True, 1.0, 20),
    "k2_length_penalty_0.5": ("eos", 2, False, False, False, 0.5, 20),
    "k4_length_penalty_2.0": ("eos", 4, True, False, False, 2.0, 20),
    "k4_budget_10": ("eos", 4, False, False, False, 1.0, 10),
    "k4_all_finish_early": ("early", 4, False, False, False, 1.0, 20),
}


def _eos_tree(jp, scale):
    """``jp`` with the EOS row of the tied embedding scaled: -3 turns EOS
    round so that hypotheses finish at different lengths; at -8 every
    hypothesis finishes within a few steps (4 beams stop after 6)."""
    emb = np.asarray(jp["decoder"]["tok_emb"]).copy()
    emb[ARCH["eos_token_id"]] *= scale
    return {**jp, "decoder": {**jp["decoder"], "tok_emb": jnp.asarray(emb)}}


@pytest.fixture(scope="module")
def setup():
    """The trees in both packages, the encoder states, and JAX's beam
    search at the two length penalties (one compile each)."""
    jp = jax_init_params(JConfig(**ARCH), 1)
    rng = np.random.default_rng(7)
    mel = (0.5 * rng.standard_normal((2, 80, 3000))).astype(np.float32)
    j_eos = _eos_tree(jp, -3.0)
    trees = {"plain": torch_params(jp), "eos": torch_params(j_eos),
             "early": torch_params(_eos_tree(jp, -8.0))}
    enc = TW.encode(trees["plain"]["encoder"], CFG, torch.from_numpy(mel))
    golden = {}
    for lp in (0.5, 2.0):
        out = j_beam(j_eos, JConfig(**ARCH), jnp.asarray(mel),
                     jnp.asarray(PROMPT),
                     JOpts.from_config(JConfig(**ARCH), max_new_tokens=20,
                                       return_timestamps=True,
                                       no_speech_token_id=350),
                     num_beams=2, length_penalty=lp)
        golden[lp] = {f: np.asarray(getattr(out, f)) for f in out._fields}
    return dict(trees=trees, mel=mel, enc=enc, golden=golden, eager={})


@pytest.fixture
def block_steps(monkeypatch):
    """Sets the blocked loop's block length for one test."""
    def set_steps(k):
        monkeypatch.setattr(B, "BLOCK_STEPS", k)
    return set_steps


def _run(setup, fn, case):
    tree, k, timestamps, padded, int8, lp, budget = CASES[case]
    cfg = CFG.replace(quantize_self_kv=int8)
    opts = GenerationOptions.from_config(cfg, max_new_tokens=budget,
                                         return_timestamps=timestamps,
                                         no_speech_token_id=350)
    extra = (dict(pad_len=torch.tensor(PAD_LEN), sot_slot=SOT_SLOT)
             if padded else {})
    return fn(setup["trees"][tree]["decoder"], cfg, setup["enc"],
              torch.tensor(PADDED if padded else PROMPT), opts, num_beams=k,
              length_penalty=lp, **extra)


def _eager(setup, case):
    """The plain loop's output of ``case``, run once a module."""
    if case not in setup["eager"]:
        setup["eager"][case] = _run(setup, B.beam_search_eager, case)
    return setup["eager"][case]


def _assert_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("steps", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_equals_eager(setup, block_steps, case, steps):
    """Bit for bit on every field, for blocks of 1 step, 3 (which divide
    neither budget) and 16 (past the early stops)."""
    eager = _eager(setup, case)
    block_steps(steps)
    _assert_equal(_run(setup, B.beam_search, case), eager)
    total = len((PADDED if CASES[case][3] else PROMPT)[0]) + CASES[case][6]
    if case == "k4_all_finish_early":
        assert (eager.seq_len < total - 10).all()
    if CASES[case][0] == "eos":
        assert (eager.scores > -math.inf).all()


@pytest.mark.parametrize("route", ["blocked", "eager"])
@pytest.mark.parametrize("lp", [0.5, 2.0])
def test_length_penalty_matches_jax(setup, route, lp):
    """Both routes give JAX's tokens and lengths at length penalties 0.5
    and 2.0 (with timestamps), and its scores at 1e-5."""
    fn = B.beam_search if route == "blocked" else B.beam_search_eager
    opts = GenerationOptions.from_config(CFG, max_new_tokens=20,
                                         return_timestamps=True,
                                         no_speech_token_id=350)
    out = fn(setup["trees"]["eos"]["decoder"], CFG, setup["enc"],
             torch.tensor(PROMPT), opts, num_beams=2, length_penalty=lp)
    ref = setup["golden"][lp]
    np.testing.assert_array_equal(out.sequences.numpy(), ref["sequences"])
    np.testing.assert_array_equal(out.seq_len.numpy(), ref["seq_len"])
    for f in ("scores", "sum_logprobs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f],
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("lp", [0.5, 1.0, 1.3, 2.0])
def test_device_penalty_equals_the_host_penalty(lp):
    """``cur ** length_penalty`` of the device cursor is the plain loop's
    penalty of the host int bit for bit, a 0-dim fp32 tensor both ways."""
    for cur in (1, 3, 7, 100, 448):
        a = B._device_penalty(torch.tensor(cur), lp)
        b = B._penalty(cur, lp, "cpu")
        assert a.shape == b.shape == () and a.dtype == b.dtype
        assert torch.equal(a, b)


def _syncs(fn):
    before = TGR.read_stats()["host_syncs"]
    out = fn()
    return TGR.read_stats()["host_syncs"] - before, out


@pytest.mark.parametrize("steps", [1, 4])
def test_host_syncs_once_a_block(setup, block_steps, steps):
    """The random tree emits no EOS, so the loop runs its 12-step budget:
    ⌈12 / steps⌉ reads of the device.  In the early tree 4 beams stop
    after 6 steps: ⌈6 / steps⌉ reads."""
    opts = GenerationOptions.from_config(CFG, max_new_tokens=12)
    block_steps(steps)

    def run(tree):
        return B.beam_search(setup["trees"][tree]["decoder"], CFG,
                             setup["enc"], torch.tensor(PROMPT), opts,
                             num_beams=4)
    n, out = _syncs(lambda: run("plain"))
    assert n == math.ceil(12 / steps) and (out.seq_len == 15).all()
    n, out = _syncs(lambda: run("early"))
    assert n == math.ceil(6 / steps) and (out.seq_len < 15).all()


def test_block_reads_nothing_from_the_device(setup, no_host_reads):
    """After the warm-up a capture starts with (host tables built once),
    the prefill, a block and the output read nothing from the device: every
    processor (forced ids, begin suppression, the minimum length, the
    timestamp rules), left-padded prompts and an int8 self-KV cache."""
    cfg = CFG.replace(quantize_self_kv=True)
    opts = GenerationOptions.from_config(
        cfg, max_new_tokens=8, return_timestamps=True, min_new_tokens=2,
        forced_decoder_ids=((7, 42),), no_speech_token_id=350)
    dec = setup["trees"]["eos"]["decoder"]
    prompt, pad_len = torch.tensor(PADDED), torch.tensor(PAD_LEN)

    def run(steps):
        s = B._beam_prefill(dec, cfg, opts, setup["enc"], prompt, 3,
                            SOT_SLOT, pad_len, torch.float32)
        flags = B._beam_block(dec, cfg, opts, s, steps, 6, 0.5,
                              torch.float32)
        return flags, B._beam_output(cfg, s, 0.5)

    run(1)
    no_host_reads()
    flags, out = run(4)
    assert flags.shape == (2,) and out.sequences.shape == (2, 14)


def test_program_keys(setup):
    """The beams, the length penalty and the rows each make another
    program; another call of the same shapes is the same program."""
    opts = GenerationOptions.from_config(CFG, max_new_tokens=20)
    dec = setup["trees"]["eos"]["decoder"]

    def key(k=2, lp=1.0, rows=2, seed=0):
        g = torch.Generator().manual_seed(seed)
        enc = torch.randn(rows, 1500, 64, generator=g)
        prompt = torch.randint(0, 300, (rows, 3), generator=g)
        return B._beam_key(dec, CFG, opts, enc, prompt, None, 0,
                           torch.float32, 16, k, lp)

    base = key()
    assert key(seed=1) == base
    assert len({base, key(k=4), key(lp=0.5), key(rows=3)}) == 4


# ----------------------------------------------------------------------
# the callers
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("beam_graphs")
    ck = make_tiny_checkpoint(root / "ck")
    params, cfg = load_params(ck, dtype=torch.float32, device="cpu")
    pipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=3,
                           max_new_tokens=6, params=params, cfg=cfg,
                           device="cpu")
    clips = []
    for i in range(3):
        path = root / f"{i}.wav"
        from distil_whisper_tpu_torch.audio.io import write_wav
        write_wav(str(path), tone(2.0 + i, 250.0 + 40 * i, i), 16000)
        clips.append({"audio": str(path), "text": "a b"})
    manifest = root / "m.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in clips))
    return dict(root=root, ck=ck, pipe=pipe, manifest=str(manifest))


@pytest.fixture
def spy(monkeypatch):
    """Records the cross-attention input, the prompt rows and the owner of
    every beam search, called by name from the pipeline and the
    micro-batch scheduler or through ``encode_and_beam_search``."""
    calls = []
    real = B.beam_search

    def record(dec, cfg, cross, prompt_ids, opts, *a, graphs=None, **k):
        calls.append((cross, prompt_ids.shape[0], graphs))
        return real(dec, cfg, cross, prompt_ids, opts, *a, graphs=graphs,
                    **k)

    for mod in (B, TP, TS):
        monkeypatch.setattr(mod, "beam_search", record)
    return calls


@pytest.mark.parametrize("caller", ["pipeline", "sequential", "micro_batch",
                                    "run_eval", "pseudo_label"])
def test_callers_pass_encoder_states_and_their_owner(ckpt, spy, caller):
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.cli import run_eval
    from distil_whisper_tpu_torch.cli import run_pseudo_labelling as PL
    from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                      SequentialTranscriber)
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    pipe, root = ckpt["pipe"], ckpt["root"]
    wav = tone(2.0, 300.0, seed=1)
    owner, rows = None, None
    if caller == "pipeline":
        pipe(wav, language="en", generate_kwargs={"num_beams": 2})
        owner = pipe.graphs
    elif caller == "sequential":
        tr = SequentialTranscriber(
            pipe.params, pipe.cfg, pipe.tokenizer,
            SequentialOptions(temperatures=(0.0,), max_new_tokens=6,
                              num_beams=2),
            language="en", batch_size=2, dtype=torch.float32, device="cpu")
        tr.transcribe([compute_mel(wav, pipe.cfg, pad_to_chunk=False,
                                   device="cpu")[0]])
        owner = tr.graphs
    elif caller == "micro_batch":
        tr = BatchingTranscriber(pipe, max_new_tokens=6).start()
        try:
            tr.submit(wav, language="en", num_beams=2)
        finally:
            tr.stop()
        owner = pipe.graphs
    elif caller == "run_eval":
        run_eval.main(["--model_checkpoint", str(ckpt["ck"]),
                       "--dataset_path", ckpt["manifest"], "--device", "cpu",
                       "--language", "en", "--batch_size", "2",
                       "--max_new_tokens", "6", "--dtype", "float32",
                       "--num_beams", "2"])
    else:
        # three clips at batch 2: the short second batch is padded to 2
        PL.main(["--model_checkpoint", str(ckpt["ck"]),
                 "--dataset_path", ckpt["manifest"],
                 "--output_dir", str(root / "pl"), "--language", "en",
                 "--per_device_batch_size", "2", "--max_new_tokens", "6",
                 "--dtype", "float32", "--device", "cpu", "--num_beams", "2",
                 "--no_concatenate_audio"])
        rows = 2
    assert spy
    owners = {id(graphs) for _, _, graphs in spy}
    for cross, n, graphs in spy:
        assert isinstance(cross, torch.Tensor) and cross.ndim == 3
        assert isinstance(graphs, TGR.GraphOwner)
        assert owner is None or graphs is owner
        assert rows is None or n == rows
    assert len(owners) == 1
    if caller == "pseudo_label":
        assert len(spy) == 2


def test_sharded_tree_decodes_through_the_plain_loop(setup, monkeypatch):
    """No tree takes ``beam_search_eager`` any more: a tree sharded over a
    mesh runs the blocked loop too (its collectives on the device comms,
    inside the graphs on the card; tests/test_torch_mesh_graphs.py drives
    real meshes), with the plain loop's output bit for bit."""
    calls = []
    real = B.beam_search_eager

    def record(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    plain = _run(setup, real, "k4_timestamps")
    monkeypatch.setattr(B, "beam_search_eager", record)
    _assert_equal(_run(setup, B.beam_search, "k4_timestamps"), plain)
    assert calls == []