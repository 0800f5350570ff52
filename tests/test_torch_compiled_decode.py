"""The compiled decode loops (CPU, fp32, tiny widths).

On the card ``generate`` and the continuous engine's step blocks replay as
CUDA graphs; on the CPU the same bodies run eagerly, which is what these
tests hold:

* the port's ``build_generate`` and blocked ``generate`` against JAX's
  ``build_generate`` (tokens and ``seq_len`` identical, ``sum_logprobs``
  and ``no_speech_prob`` at 1e-5; the int8 flags at 1e-4 with a row
  allowed to part only at a near-tie);
* the blocked loop against the plain step loop (``generate_eager``) bit
  for bit, for block lengths that do and do not divide the budget, with
  every row finished early, and sampled under one seeded generator;
* the host syncs of the blocked loop: one a block;
* that the block bodies of ``generate`` and of the engine read nothing
  from the device (a capture would fail on the card);
* the engine's state updated in place (admissions keep every buffer's
  storage) and its packed vectors equal to the rebinding step the engine
  had before its blocks were captured;
* the graph owner's cache and the launch counts of captured kernels;
* that programs let go of their weights with their owner, and that the
  pseudo-labelling teacher decodes a short batch padded to the full one.
"""

import importlib
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import jax_init_params, tone, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import encode_and_generate as j_generate
from distil_whisper_tpu.generation.generate import \
    build_generate as j_build_generate
from distil_whisper_tpu.ops import quant as JQ
from distil_whisper_tpu_torch.audio import compute_mel
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                  build_generate, generate,
                                                  generate_eager)
from distil_whisper_tpu_torch.generation import graphs as TGR
from distil_whisper_tpu_torch.generation import logits as TL
from distil_whisper_tpu_torch.models import init_params, load_params
from distil_whisper_tpu_torch.models import whisper as TW
from distil_whisper_tpu_torch.ops import _build
from distil_whisper_tpu_torch.ops import quant as TQ
from distil_whisper_tpu_torch.pipeline import WhisperPipeline
from distil_whisper_tpu_torch.serving_engine import ContinuousBatchingEngine

# the module (the package exports its function under the same name)
TG = importlib.import_module("distil_whisper_tpu_torch.generation.generate")

# small vocabulary with the real tail layout (tests/test_torch_generate.py)
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
INT8 = dict(quantize_encoder=True, quantize_decoder=True,
            quantize_lm_head=True, quantize_cross_kv=True,
            quantize_self_kv=True)
CFG, JCFG = WhisperConfig(**ARCH), JConfig(**ARCH)
QCFG, JQCFG = WhisperConfig(**ARCH, **INT8), JConfig(**ARCH, **INT8)
PROMPT = [[3, 310, 320]] * 2
# condition-on-prev layout: [pad | <|startofprev|> ctx | SOT ...], SOT at 3
PADDED = [[0, 0, 0, 3, 310, 320], [0, 390, 17, 3, 310, 320]]
PAD_LEN = [3, 1]

CASES = {
    "greedy": dict(max_new_tokens=12),
    "timestamps_forced": dict(max_new_tokens=12, return_timestamps=True,
                              forced_decoder_ids=((4, 42),),
                              min_new_tokens=3),
    "padded": dict(max_new_tokens=10, return_timestamps=True),
    "int8": dict(max_new_tokens=12),
}


def _mel(batch, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((batch, 80, 3000))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """The tiny model in both packages, its int8 tree (JAX quantizes, the
    port converts), and JAX's ``build_generate`` on every case."""
    jp = jax_init_params(JCFG, 1)
    jq = JQ.maybe_quantize_encoder(jp, JQCFG)
    mel, mel8 = _mel(2, 7), _mel(8, 3)
    golden = {}
    for case, kw in CASES.items():
        kw = dict(kw, no_speech_token_id=350)
        if case == "padded":
            # build_generate takes no pad_len: its encode_and_generate does
            out = j_generate(jp, JCFG, jnp.asarray(mel), jnp.asarray(PADDED),
                             JOpts.from_config(JCFG, **kw),
                             pad_len=jnp.asarray(PAD_LEN), sot_slot=3)
        elif case == "int8":
            fn = j_build_generate(JQCFG, JOpts.from_config(JQCFG, **kw))
            out = fn(jq, jnp.asarray(mel8), jnp.asarray(PROMPT * 4), 0.0,
                     jax.random.PRNGKey(0))
        else:
            fn = j_build_generate(JCFG, JOpts.from_config(JCFG, **kw))
            out = fn(jp, jnp.asarray(mel), jnp.asarray(PROMPT), 0.0,
                     jax.random.PRNGKey(0))
        golden[case] = {f: np.asarray(getattr(out, f)) for f in out._fields}
    return dict(tp=torch_params(jp), tq=torch_params(jq), mel=mel,
                mel8=mel8, golden=golden)


def _port(setup, case):
    kw = dict(CASES[case], no_speech_token_id=350)
    if case == "padded":
        enc = TW.encode(setup["tp"]["encoder"], CFG,
                        torch.from_numpy(setup["mel"]))
        return generate(setup["tp"]["decoder"], CFG, enc,
                        torch.tensor(PADDED),
                        GenerationOptions.from_config(CFG, **kw),
                        pad_len=torch.tensor(PAD_LEN), sot_slot=3)
    cfg, params, mel, prompt = ((QCFG, setup["tq"], setup["mel8"], PROMPT * 4)
                                if case == "int8" else
                                (CFG, setup["tp"], setup["mel"], PROMPT))
    fn = build_generate(cfg, GenerationOptions.from_config(cfg, **kw),
                        device="cpu")
    return fn(params, mel, prompt)


def _near_tie_gap(setup, seqs, row, col, other):
    """The port's raw logit of its own token at (row, col) minus that of
    ``other``, from a teacher-forced pass over its own tokens."""
    tq = setup["tq"]
    enc = TW.encode(tq["encoder"], QCFG, torch.from_numpy(setup["mel8"]))
    logits, _ = TW.decode(tq["decoder"], QCFG,
                          torch.from_numpy(seqs[:, :col]), enc=enc)
    lg = logits[row, col - 1]
    return float(lg[seqs[row, col]] - lg[other])


@pytest.fixture
def block_steps(monkeypatch):
    """Sets the blocked loop's block length for one test."""
    def set_steps(k):
        monkeypatch.setattr(TG, "BLOCK_STEPS", k)
    return set_steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_generate_matches_jax(setup, block_steps, case):
    block_steps(5)
    ref = setup["golden"][case]
    out = _port(setup, case)
    seqs, jseqs = out.sequences.numpy(), ref["sequences"]
    same = list(range(seqs.shape[0]))
    tol = 1e-5
    if case == "int8":
        # requantization quanta (~1e-3 a logit) that fp32 rounding moves:
        # a row may part from JAX only at a near-tie of the port's logits
        tol = 1e-4
        parted = []
        for r in np.flatnonzero((seqs != jseqs).any(axis=1)):
            c = int(np.argmax(seqs[r] != jseqs[r]))
            parted.append((int(r), c, _near_tie_gap(setup, seqs, r, c,
                                                    int(jseqs[r, c]))))
        assert len(parted) <= 1 and all(abs(g) < 5e-3 for *_, g in parted), \
            parted
        same = [r for r in same if r not in {p[0] for p in parted}]
    np.testing.assert_array_equal(seqs[same], jseqs[same])
    np.testing.assert_array_equal(out.seq_len.numpy()[same],
                                  ref["seq_len"][same])
    np.testing.assert_allclose(out.sum_logprobs.numpy()[same],
                               ref["sum_logprobs"][same], rtol=tol, atol=tol)
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               ref["no_speech_prob"], rtol=tol, atol=tol)
    if case == "timestamps_forced":
        assert (seqs[:, 4] == 42).all()


def _assert_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("case", ["budget_10", "all_finish_early"])
@pytest.mark.parametrize("steps", [1, 3, 16])
def test_blocked_equals_eager(setup, block_steps, steps, case):
    """Bit for bit, for blocks that do (1) and do not (3, 16 > 10) divide
    the budget, and when every row emits EOS at its fourth token (the
    blocked loop runs on to the end of its block)."""
    kw = dict(max_new_tokens=10, return_timestamps=True,
              no_speech_token_id=350)
    if case == "all_finish_early":
        kw.update(return_timestamps=False,
                  forced_decoder_ids=((5, CFG.eos_token_id),))
    opts = GenerationOptions.from_config(CFG, **kw)
    dec = setup["tp"]["decoder"]
    enc = TW.encode(setup["tp"]["encoder"], CFG,
                    torch.from_numpy(setup["mel"]))
    prompt = torch.tensor(PROMPT)
    eager = generate_eager(dec, CFG, TW.cross_kv(dec, CFG, enc), prompt,
                           opts)
    block_steps(steps)
    blocked = generate(dec, CFG, enc, prompt, opts)
    _assert_equal(blocked, eager)
    if case == "all_finish_early":
        assert (eager.seq_len == 6).all()


def test_sampled_blocked_equals_eager(setup, block_steps):
    """One seeded generator: the blocked loop draws what the step loop
    draws (three blocks of 4 steps, top-k, a tensor temperature)."""
    opts = GenerationOptions.from_config(CFG, max_new_tokens=12,
                                         do_sample=True, top_k=50,
                                         no_speech_token_id=350)
    dec = setup["tp"]["decoder"]
    enc = TW.encode(setup["tp"]["encoder"], CFG,
                    torch.from_numpy(setup["mel"]))
    prompt = torch.tensor(PROMPT)

    def run(fn, seed, temperature):
        return fn(dec, CFG, enc, prompt, opts, temperature=temperature,
                  generator=torch.Generator().manual_seed(seed))

    block_steps(4)
    eager = run(generate_eager, 4, 0.9)
    blocked = run(generate, 4, torch.tensor(0.9))
    _assert_equal(blocked, eager)
    other = run(generate, 5, 0.9)
    assert not torch.equal(other.sequences, eager.sequences)


def test_host_syncs_once_a_block(setup, block_steps):
    """A 12-token budget at blocks of 5: three reads of the device."""
    block_steps(5)
    opts = GenerationOptions.from_config(CFG, max_new_tokens=12,
                                         min_new_tokens=12)
    enc = TW.encode(setup["tp"]["encoder"], CFG,
                    torch.from_numpy(setup["mel"]))
    before = TGR.read_stats()["host_syncs"]
    generate(setup["tp"]["decoder"], CFG, enc, torch.tensor(PROMPT), opts)
    assert TGR.read_stats()["host_syncs"] - before == math.ceil(12 / 5)


@pytest.fixture
def no_host_reads(monkeypatch):
    """Within the fixture's test, reading the device from the host (a
    Tensor's bool, item, tolist, cpu) or building a tensor from host data
    raises: a capture on the card would fail there."""
    def refuse(name):
        def fn(*a, **k):
            raise AssertionError(f"host read in a block body: {name}")
        return fn

    def guard():
        for name in ("__bool__", "item", "tolist", "cpu"):
            monkeypatch.setattr(torch.Tensor, name, refuse(name))
        monkeypatch.setattr(torch, "tensor", refuse("torch.tensor"))
        monkeypatch.setattr(torch, "as_tensor", refuse("torch.as_tensor"))
    return guard


@pytest.mark.parametrize("do_sample", [False, True])
def test_generate_block_reads_nothing_from_the_device(setup, no_host_reads,
                                                      do_sample):
    opts = GenerationOptions.from_config(
        CFG, max_new_tokens=8, return_timestamps=True, do_sample=do_sample,
        top_k=20, forced_decoder_ids=((4, 42),), min_new_tokens=2,
        no_speech_token_id=350)
    dec = setup["tp"]["decoder"]
    enc = TW.encode(setup["tp"]["encoder"], CFG,
                    torch.from_numpy(setup["mel"]))
    prompt, pad_len = torch.tensor(PADDED), torch.tensor(PAD_LEN)
    temp = TG._temperature(0.7, "cpu")
    gen = torch.Generator().manual_seed(0)
    # the warm-up a capture starts with: host tables built once
    state = TG._prefill(dec, CFG, opts, enc, prompt, pad_len, 3,
                        torch.float32)
    TG._block(dec, CFG, opts, state, 1, 6, temp, gen, pad_len, torch.float32)
    no_host_reads()
    flags = TG._block(dec, CFG, opts, state, 4, 6, temp, gen, pad_len,
                      torch.float32)
    assert flags.shape == (2,)


@pytest.fixture(scope="module")
def engine_pipe(tmp_path_factory):
    ck = make_tiny_checkpoint(tmp_path_factory.mktemp("compiled") / "ck")
    params, cfg = load_params(ck, dtype=torch.float32, device="cpu")
    return WhisperPipeline(ck, dtype=torch.float32, batch_size=3,
                           max_new_tokens=10, params=params, cfg=cfg,
                           device="cpu")


def _rebinding_step(self, s, sampling):
    """The engine's step as it was before its blocks were captured: every
    update bound to a new tensor (the reference of the in-place step)."""
    from distil_whisper_tpu_torch.generation.speculative import _process
    from distil_whisper_tpu_torch.serving_engine import sample_lanes
    cfg, opts = self.cfg, self.opts
    gen_idx = s["pos"] - s["prompt_len"]
    scores = _process(s["last_logits"], gen_idx, cfg, opts, s["prompt_len"],
                      ts_state=s["ts"], use_ts=s["use_ts"])
    nxt = torch.argmax(scores, dim=-1)
    if sampling:
        drawn = sample_lanes(scores, s["temp"], s["topk"], s["seed_lo"],
                             s["seed_hi"], gen_idx, self.k_max)
        nxt = torch.where(s["temp"] > 0, drawn, nxt)
    tok_logp = torch.log_softmax(scores, dim=-1).gather(1, nxt[:, None])[:, 0]
    frozen = s["finished"]
    nxt = torch.where(frozen, cfg.pad_token_id, nxt)
    s["sum_logprobs"] = s["sum_logprobs"] + torch.where(frozen, 0.0,
                                                        tok_logp)
    s["finished"] = (frozen | (nxt == cfg.eos_token_id)
                     | (gen_idx + 1 >= s["budget"]))
    rows = torch.arange(self.local, device=self.device)
    pos = s["pos"]
    s["tokens"][rows, pos] = nxt
    new_ts = s["ts"].update(nxt, cfg.timestamp_begin)
    s["ts"] = TL.TimestampState(*(torch.where(frozen, o, n)
                                  for n, o in zip(new_ts, s["ts"])))
    s["pos"] = torch.where(frozen, pos, pos + 1)
    lg, _ = TW.decode(self.pipe.params["decoder"], cfg, nxt[:, None],
                      cross=s["cross"], cache=s["cache"], pos_offset=pos,
                      dtype=self.dtype)
    s["last_logits"] = torch.where(frozen[:, None], s["last_logits"],
                                   lg[:, -1].float())


def _buffers(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t.data_ptr() for n, t in v.items()})
        elif isinstance(v, tuple):
            out.update({f"{k}.{n}": t.data_ptr()
                        for n, t in zip(v._fields, v)})
        else:
            out[k] = v.data_ptr()
    return out


def test_engine_state_in_place_equals_the_rebinding_engine(engine_pipe):
    """One admission sequence (greedy and sampled lanes, re-admission of a
    finished lane, timestamps on one lane) through the in-place engine and
    through the rebinding step: equal packed vectors after every block, and
    every state buffer of the in-place engine keeps its storage."""
    pipe = engine_pipe
    tok = pipe.tokenizer
    mels = torch.cat([compute_mel(tone(1.0, 200.0 + 60 * i, seed=i)[None],
                                  pipe.cfg, device="cpu") for i in range(4)])
    prompt = tok.prompt_ids(language="en", task="transcribe",
                            no_timestamps=True)
    ts_prompt = tok.prompt_ids(language="en", task="transcribe",
                               no_timestamps=False)
    admissions = {
        0: dict(idx=[0, 1], prompts=[prompt, ts_prompt], budgets=[3, 9],
                use_ts=[False, True], lanes=[0, 1], temps=[0.0, 0.0]),
        1: dict(idx=[2, 3], prompts=[prompt, prompt], budgets=[8, 5],
                use_ts=[False, False], lanes=[0, 2], temps=[0.9, 0.0]),
    }
    engines = []
    for rebinding in (False, True):
        eng = ContinuousBatchingEngine(pipe, lanes=3, block_steps=4,
                                       max_new_tokens=10)
        if rebinding:
            eng._greedy_step = _rebinding_step.__get__(eng)
        eng.init_state()
        engines.append(eng)
    ptrs = _buffers(engines[0]._state)
    packed = [[], []]
    for block in range(4):
        sampling = block in (1, 2)
        for j, eng in enumerate(engines):
            a = admissions.get(block)
            if a is not None:
                eng.admit(mels[a["idx"]], a["prompts"], a["budgets"],
                          a["use_ts"], a["lanes"], temps=a["temps"],
                          top_ks=[5, 0], seeds=[11, 12])
            packed[j].append(eng.step(sampling=sampling))
        assert _buffers(engines[0]._state) == ptrs
    for a, b in zip(*packed):
        assert torch.equal(a, b)
    finished, pos, tokens, _ = engines[0].unpack(packed[0][-1])
    assert finished.all() and (pos > len(prompt)).all()


def test_engine_block_reads_nothing_from_the_device(engine_pipe,
                                                    no_host_reads):
    pipe = engine_pipe
    eng = ContinuousBatchingEngine(pipe, lanes=2, block_steps=3,
                                   max_new_tokens=10)
    eng.init_state()
    mels = torch.cat([compute_mel(tone(1.0, f, seed=0)[None], pipe.cfg,
                                  device="cpu") for f in (250.0, 330.0)])
    prompt = pipe.tokenizer.prompt_ids(language="en", task="transcribe",
                                       no_timestamps=False)
    eng.admit(mels, [prompt] * 2, [8, 8], [True, False], [0, 1],
              temps=[0.8, 0.0], top_ks=[4, 0], seeds=[1, 2])
    eng._block(True)          # the warm-up a capture starts with
    no_host_reads()
    for sampling in (False, True):
        packed = eng._block(sampling)
    assert packed.shape == (2 + 2 + 2 * eng.t_buf,)


def test_graph_owner_cache_is_least_recently_used(monkeypatch):
    monkeypatch.setattr(TGR, "MAX_PROGRAMS", 2)
    owner = TGR.GraphOwner("test")
    built = []

    def build(name):
        built.append(name)
        return name

    for key in ("a", "b", "a", "c", "b", "a"):
        assert owner.entry(key, lambda key=key: build(key)) == key
    # "b" was dropped by "c" (least recently used after "a"), then "a" by
    # the rebuilt "b"
    assert built == ["a", "b", "c", "b", "a"]
    assert list(owner.entries) == ["b", "a"]
    assert owner.report() == {"programs": 2, "built": 5, "evicted": 3,
                              "pool_bytes": None}


def test_programs_free_their_weights_with_the_owner(monkeypatch):
    """A program holds the tree its graphs read; it lets go of it when it
    is evicted or its owner is dropped, and ``generate`` keeps nothing of
    a tree it was given without an owner."""
    import gc
    import weakref
    monkeypatch.setattr(TGR, "MAX_PROGRAMS", 1)

    def program(tree):
        return TG._Program(tree, {}, None, None, {}, None, None)

    owner = TGR.GraphOwner("test")
    trees = [{"w": torch.zeros(4)} for _ in range(3)]
    refs = [weakref.ref(t["w"]) for t in trees]
    owner.entry("a", lambda: program(trees[0]))
    owner.entry("b", lambda: program(trees[1]))       # evicts "a"
    owner2 = TGR.GraphOwner("test2")
    owner2.entry("c", lambda: program(trees[2]))
    del trees, owner2
    gc.collect()
    assert [r() is None for r in refs] == [True, False, True]
    del owner
    gc.collect()
    assert refs[1]() is None

    cfg = WhisperConfig(**ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    ref = weakref.ref(params["decoder"]["tok_emb"])
    enc = torch.zeros(1, cfg.max_source_positions, cfg.d_model)
    TG.generate(params["decoder"], cfg, enc, torch.tensor([PROMPT[0]]),
                GenerationOptions.from_config(cfg, max_new_tokens=2))
    del params
    gc.collect()
    assert ref() is None


def test_replays_count_the_captured_launches():
    """A capture counts its thread's kernel launches for the graph, not as
    launches (another thread's still count); each replay adds them."""
    import threading

    class Wrapper:
        launches = 0
    w = Wrapper()
    _build.count_launch(w)
    with _build.recording_launches() as recorded:
        for _ in range(2):                     # what a capture records
            _build.count_launch(w)
        other = threading.Thread(target=_build.count_launch, args=(w,))
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert recorded == {id(w): 2} and w.launches == 2

    class FakeGraph:
        def replay(self):
            pass
    graph = TGR.Graph(FakeGraph(), recorded)
    replays = TGR.read_stats()["replays"]
    for _ in range(3):
        graph.replay()
    assert w.launches == 2 + 3 * 2
    assert TGR.read_stats()["replays"] - replays == 3


def test_params_key_follows_the_tensors():
    t = {"a": torch.zeros(2), "b": {"c": torch.ones(3)}}
    same = {"b": {"c": t["b"]["c"]}, "a": t["a"]}
    assert TGR.params_key(t) == TGR.params_key(same)
    assert TGR.params_key(t) != TGR.params_key(
        {"a": torch.zeros(2), "b": t["b"]})


def test_int8_tree_quantized_by_the_port_decodes_alike(setup):
    """The int8 case's tree is JAX's quantization converted; the port's own
    quantization of the same weights is the same tree, so the blocked loop
    on it equals the blocked loop on JAX's."""
    tq = TQ.maybe_quantize_encoder(setup["tp"], QCFG)
    kw = dict(CASES["int8"], no_speech_token_id=350)
    fn = build_generate(QCFG, GenerationOptions.from_config(QCFG, **kw),
                        device="cpu")
    _assert_equal(fn(tq, setup["mel8"], PROMPT * 4),
                  fn(setup["tq"], setup["mel8"], PROMPT * 4))


def test_pseudo_labelling_pads_a_short_batch(tmp_path, monkeypatch):
    """The teacher decodes a short last batch at the full batch's rows
    (copies of its last row), as JAX pads it, so that every batch is one
    program; the labels of its rows equal a run's at batch 1."""
    import json
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli import run_pseudo_labelling as PL
    ck = make_tiny_checkpoint(tmp_path / "ck")
    rows = []
    for i in range(5):
        write_wav(str(tmp_path / f"{i}.wav"), tone(3 + i, 200 + 50 * i, i),
                  16000)
        rows.append({"audio": str(tmp_path / f"{i}.wav"), "text": "a b"})
    (tmp_path / "m.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    shapes = []
    real = PL.build_generate

    def spy(*a, **k):
        fn = real(*a, **k)

        def call(params, mel, prompts):
            shapes.append((mel.shape[0], len(prompts)))
            return fn(params, mel, prompts)
        return call

    monkeypatch.setattr(PL, "build_generate", spy)

    def labels(bsz):
        path = PL.main([
            "--model_checkpoint", str(ck),
            "--dataset_path", str(tmp_path / "m.jsonl"),
            "--output_dir", str(tmp_path / f"out{bsz}"), "--language", "en",
            "--per_device_batch_size", str(bsz), "--max_new_tokens", "6",
            "--dtype", "float32", "--device", "cpu",
            "--no_concatenate_audio"])
        return [json.loads(line)["whisper_transcript"]
                for line in Path(path).read_text().splitlines()]

    padded = labels(2)
    assert shapes == [(2, 2)] * 3
    assert len(padded) == 5 and padded == labels(1)
