"""Speculative decoding as compiled rounds (CPU, fp32, tiny widths).

On the card the draft and n-gram loops replay their prefill and blocks of
rounds as CUDA graphs, and the continuous engine's speculative blocks do
too; on the CPU the same bodies run eagerly, which is what these tests
hold:

* the blocked loops against the plain loop (``speculate_eager``) bit for
  bit on every output field: draft and n-gram, with timestamps, with a
  left-padded prompt, with synthetic acceptance and a synthetic period,
  for blocks of rounds that do and do not divide the rounds needed, when
  every lane ends at its first token, and when the last verify window
  overhangs a budget that ends at the model's last position;
* tokens and ``seq_len`` against JAX's ``speculative_generate_batched``
  and ``ngram_speculative_generate_batched`` (the n-gram counters too),
  ``sum_logprobs`` at 1e-5;
* one host read a block;
* that the round bodies of the loop and of the engine read nothing from
  the device (a capture would fail on the card);
* the engine's speculative state updated in place (every buffer keeps its
  storage) with packed vectors equal to the rebinding round it had
  before, for the draft and the n-gram lookup at two draft lengths;
* the program keys: another draft length, draft tree, method or block is
  another program; and the callers hand their owners and encoder states
  to the loops.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (threads, TF32 off)
from helpers import make_tiny_checkpoint
from test_torch_compiled_decode import _buffers, no_host_reads  # noqa: F401
from torch_port_helpers import jax_init_params, tone, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import speculative as JS
from distil_whisper_tpu.models import whisper as JW
from distil_whisper_tpu.training import init_student_from_teacher
from distil_whisper_tpu_torch.audio import compute_mel
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import GenerationOptions
from distil_whisper_tpu_torch.generation import graphs as TGR
from distil_whisper_tpu_torch.generation import logits as TL
from distil_whisper_tpu_torch.generation import speculative as S
from distil_whisper_tpu_torch.models import init_params, load_params
from distil_whisper_tpu_torch.models import whisper as TW
from distil_whisper_tpu_torch.pipeline import WhisperPipeline
from distil_whisper_tpu_torch.serving_engine import ContinuousBatchingEngine

# tests/test_torch_compiled_decode.py's widths and vocabulary tail
ARCH = dict(vocab_size=1902, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, bos_token_id=1, eos_token_id=300,
            decoder_start_token_id=3, begin_suppress_tokens=(220, 300))
CFG, JCFG = WhisperConfig(**ARCH), JConfig(**ARCH)
PROMPT = [[3, 17], [3, 55], [3, 121]]
# condition-on-prev layout: [pad | context | SOT], SOT at slot 5
PADDED = [[0, 0, 17, 55, 21, 3], [0, 0, 0, 0, 9, 3], [5, 6, 7, 8, 9, 3]]
PAD_LEN = [2, 4, 0]
TS = dict(return_timestamps=True, max_initial_timestamp_index=50,
          no_speech_token_id=398)


@pytest.fixture(scope="module")
def setup():
    """The tiny teacher and its 1-layer draft in both packages, their
    encoder states, and JAX's batched loops on plain and padded prompts
    (one jitted program each)."""
    jp = jax_init_params(JCFG, 2)
    jd, jd_cfg = init_student_from_teacher(jp, JCFG, decoder_layers=1)
    mel = np.random.default_rng(5).standard_normal(
        (3, 80, 3000)).astype(np.float32)
    opts = JOpts.from_config(JCFG, max_new_tokens=20, **TS)

    @jax.jit
    def golden(jp, jd, mel, prompts, pad_len):
        enc = JW.encode(jp["encoder"], JCFG, mel)
        tc = JW.cross_kv(jp["decoder"], JCFG, enc)
        dc = JW.cross_kv(jd["decoder"], jd_cfg, enc)
        kw = {} if pad_len is None else dict(pad_len=pad_len, sot_slot=5)
        return (JS.speculative_generate_batched(
                    jp["decoder"], JCFG, jd["decoder"], jd_cfg, tc, dc,
                    prompts, opts, gamma=3, **kw),
                JS.ngram_speculative_generate_batched(
                    jp["decoder"], JCFG, tc, prompts, opts, gamma=3,
                    max_ngram=2, **kw))

    goldens = {}
    for name, prompts, pad_len in (("plain", PROMPT, None),
                                   ("padded", PADDED, PAD_LEN)):
        out = golden(jp, jd, jnp.asarray(mel), jnp.asarray(prompts),
                     None if pad_len is None else jnp.asarray(pad_len))
        goldens[name] = dict(zip(("draft", "ngram"),
                                 jax.tree.map(np.asarray, out)))
    teacher, draft = torch_params(jp), torch_params(jd)
    d_cfg = CFG.replace(decoder_layers=1)
    enc = TW.encode(teacher["encoder"], CFG, torch.from_numpy(mel))
    return dict(t=teacher["decoder"], d=draft["decoder"], d_cfg=d_cfg,
                enc=enc, golden=goldens)


@pytest.fixture
def rounds(monkeypatch):
    """Sets the rounds a block for one test."""
    def set_rounds(r):
        monkeypatch.setattr(S, "ROUNDS_PER_BLOCK", r)
    return set_rounds


def _opts(**kw):
    return GenerationOptions.from_config(CFG, **dict(dict(TS,
                                                          max_new_tokens=20),
                                                     **kw))


# every case: (method, its keyword arguments, options, prompts, pad_len)
CASES = {
    "draft_timestamps": ("draft", {}, {}, PROMPT, None),
    "ngram_timestamps": ("ngram", {}, {}, PROMPT, None),
    "draft_padded": ("draft", {}, {}, PADDED, PAD_LEN),
    "ngram_padded": ("ngram", {}, {}, PADDED, PAD_LEN),
    "synthetic_acceptance": ("draft", dict(synthetic_acceptance=0.7),
                             dict(return_timestamps=False), PROMPT, None),
    "synthetic_period": ("ngram", dict(synthetic_period=4,
                                       synthetic_repeat_prob=0.8),
                         dict(return_timestamps=False), PROMPT, None),
    # every lane emits EOS as its first token: no round is active
    "all_end_at_first_token": ("draft", {}, dict(
        return_timestamps=False, begin_suppress_tokens=(),
        forced_decoder_ids=((2, 300),)), PROMPT, None),
}


def _run(setup, fn, method, kw, opts, prompts, pad_len, gamma=3,
         cfg=CFG, teacher=None, enc=None):
    teacher = setup["t"] if teacher is None else teacher
    enc = setup["enc"] if enc is None else enc
    prompts = torch.tensor(prompts)
    extra = {} if pad_len is None else dict(pad_len=torch.tensor(pad_len),
                                            sot_slot=5)
    if fn == "eager":
        draft = ((setup["d"], setup["d_cfg"], enc) if method == "draft"
                 else None)
        return S.speculate_eager(teacher, cfg, enc, prompts, opts,
                                 gamma=gamma, draft=draft, max_ngram=2,
                                 **kw, **extra)
    if method == "draft":
        return S.speculative_generate_batched(
            teacher, cfg, setup["d"], setup["d_cfg"], enc, enc, prompts,
            opts, gamma=gamma, **kw, **extra)
    return S.ngram_speculative_generate_batched(
        teacher, cfg, enc, prompts, opts, gamma=gamma, max_ngram=2, **kw,
        **extra)


def _assert_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("r", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_equals_eager(setup, rounds, case, r):
    """Bit for bit on every field, for blocks of 1 round (which divide
    the rounds needed), 3 and 16 (more than any lane needs)."""
    method, kw, okw, prompts, pad_len = CASES[case]
    opts = _opts(**okw)
    eager = _run(setup, "eager", method, kw, opts, prompts, pad_len)
    rounds(r)
    blocked = _run(setup, "blocked", method, kw, opts, prompts, pad_len)
    _assert_equal(blocked, eager)
    if case == "all_end_at_first_token":
        assert (eager.seq_len == 3).all() and not eager.rounds.any()
    else:
        assert (eager.rounds > 0).all()
    if case.startswith("synthetic"):
        assert eager.accepted.sum() > 0


def test_last_window_overhangs_the_models_last_position(rounds):
    """A budget that ends at ``max_target_positions`` with every proposal
    accepted: the last verify window reaches past the budget, and a lane's
    frozen window stays inside the cache through the masked rounds after
    every lane has finished (a write past it would raise)."""
    cfg = CFG.replace(max_target_positions=16)
    params = init_params(cfg, seed=3, device="cpu")
    enc = torch.randn(3, cfg.max_source_positions, cfg.d_model,
                      generator=torch.Generator().manual_seed(0))
    m = dict(t=params["decoder"], d=params["decoder"], d_cfg=cfg, enc=enc)
    opts = GenerationOptions.from_config(cfg, max_new_tokens=14)
    kw = dict(synthetic_acceptance=1.0)
    eager = _run(m, "eager", "draft", kw, opts, PROMPT, None, cfg=cfg)
    assert (eager.seq_len == 16).all()
    # the prefill's token, then rounds of 4: the fourth round's window,
    # slots 15-18, overhangs the budget of 16 by 3
    assert (eager.accepted == 3 * eager.rounds).all()
    rounds(3)
    _assert_equal(_run(m, "blocked", "draft", kw, opts, PROMPT, None,
                       cfg=cfg), eager)


@pytest.mark.parametrize("layout", ["plain", "padded"])
@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_matches_jax(setup, method, layout):
    """Tokens and lengths equal JAX's batched loops (the n-gram method's
    rounds, drafted and accepted too: its proposals depend on the tokens
    alone), and ``sum_logprobs`` and ``no_speech_prob`` at 1e-5."""
    golden = setup["golden"][layout][method]
    prompts, pad_len = ((PROMPT, None) if layout == "plain"
                        else (PADDED, PAD_LEN))
    out = _run(setup, "blocked", method, {}, _opts(), prompts, pad_len)
    np.testing.assert_array_equal(out.sequences.numpy(), golden.sequences)
    keys = ("seq_len",) + (("rounds", "drafted", "accepted")
                           if method == "ngram" else ())
    for key in keys:
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      getattr(golden, key), err_msg=key)
    for key in ("sum_logprobs", "no_speech_prob"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   getattr(golden, key), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("r", [2, 4])
def test_host_syncs_once_a_block(setup, rounds, r):
    rounds(r)
    before = TGR.read_stats()["host_syncs"]
    out = _run(setup, "blocked", "draft", {}, _opts(), PROMPT, None)
    syncs = TGR.read_stats()["host_syncs"] - before
    assert syncs == math.ceil(int(out.rounds.max()) / r)


def _loop(setup, method, opts, prompts, pad_len, kw):
    """A loop's pieces as the blocked call builds them."""
    b, p = prompts.shape
    m = S._Method(3, setup["d_cfg"] if method == "draft" else None, 2, **kw)
    coins, repeat = S._coins(m, b, p + opts.max_new_tokens + 4, "cpu")
    return S._Loop(setup["t"], CFG, setup["d"], m, opts, p, pad_len, 5,
                   coins, repeat, torch.float32)


@pytest.mark.parametrize("method,kw", [
    ("draft", dict(synthetic_acceptance=0.7)),
    ("ngram", dict(synthetic_period=4, synthetic_repeat_prob=0.8))])
def test_round_body_reads_nothing_from_the_device(setup, no_host_reads,
                                                  method, kw):
    opts = _opts(forced_decoder_ids=((7, 42),), min_new_tokens=2)
    prompts, pad_len = torch.tensor(PADDED), torch.tensor(PAD_LEN)
    loop = _loop(setup, method, opts, prompts, pad_len, kw)
    enc = setup["enc"]
    # the warm-up a capture starts with: host tables built once
    state = loop.prefill(enc, enc, prompts)
    loop.block(state, 1)
    no_host_reads()
    state = loop.prefill(enc, enc, prompts)
    flag = loop.block(state, 2)
    assert flag.shape == () and flag.dtype == torch.bool


def test_program_keys(setup):
    """Another draft length, draft tree, method or block length is another
    program; the same call is the same one."""
    prompts, opts, enc = torch.tensor(PROMPT), _opts(), setup["enc"]
    other = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in setup["d"].items()}

    def key(gamma=3, draft=setup["d"], method="draft", rounds=2):
        m = S._Method(gamma, setup["d_cfg"] if method == "draft" else None)
        return S._program_key(setup["t"], CFG, None if method == "ngram"
                              else draft, m, enc, enc, prompts, opts, None,
                              None, torch.float32, rounds)

    base = key()
    assert key() == base
    others = [key(gamma=4), key(draft=other), key(method="ngram"),
              key(rounds=3)]
    assert len({base, *others}) == 5


# ----------------------------------------------------------------------
# the callers
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec_graphs")
    ck = make_tiny_checkpoint(root / "ck")
    draft_ck = make_tiny_checkpoint(root / "draft", decoder_layers=1, seed=7)
    params, cfg = load_params(ck, dtype=torch.float32, device="cpu")
    pipe = WhisperPipeline(ck, dtype=torch.float32, batch_size=3,
                           max_new_tokens=10, params=params, cfg=cfg,
                           device="cpu")
    return dict(ck=ck, pipe=pipe,
                draft=load_params(draft_ck, dtype=torch.float32,
                                  device="cpu"))


@pytest.fixture
def spy(monkeypatch):
    """Records the cross-attention inputs and the owner of every loop."""
    calls = []
    real = S._speculate

    def record(teacher_dec, cfg, draft_dec, m, t_cross, d_cross, *a,
               **k):
        calls.append((t_cross, d_cross, a[-1] if len(a) == 6
                      else k.get("graphs")))
        return real(teacher_dec, cfg, draft_dec, m, t_cross, d_cross, *a,
                    **k)

    monkeypatch.setattr(S, "_speculate", record)
    return calls


@pytest.mark.parametrize("caller", ["pipeline", "sequential", "micro_batch"])
def test_callers_pass_encoder_states_and_their_owner(ckpts, spy, caller):
    from distil_whisper_tpu_torch.generation import (SequentialOptions,
                                                      SequentialTranscriber)
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    pipe = ckpts["pipe"]
    kw = dict(speculative_method="draft", assistant=ckpts["draft"], gamma=2)
    wav = tone(2.0, 300.0, seed=1)
    if caller == "pipeline":
        spec = WhisperPipeline(ckpts["ck"], dtype=torch.float32,
                               batch_size=3, max_new_tokens=6,
                               params=pipe.params, cfg=pipe.cfg,
                               device="cpu", **kw)
        spec(wav, language="en")
        owner = spec.graphs
    elif caller == "sequential":
        tr = SequentialTranscriber(
            pipe.params, pipe.cfg, pipe.tokenizer,
            SequentialOptions(temperatures=(0.0,), max_new_tokens=6),
            language="en", batch_size=2, dtype=torch.float32, device="cpu",
            **kw)
        tr.transcribe([compute_mel(wav, pipe.cfg, pad_to_chunk=False,
                                   device="cpu")[0]])
        owner = tr.graphs
    else:
        tr = BatchingTranscriber(pipe, assistant=ckpts["draft"], gamma=2,
                                 max_new_tokens=6).start()
        try:
            tr.submit(wav, language="en")
        finally:
            tr.stop()
        owner = pipe.graphs
    assert spy
    for t_cross, d_cross, graphs in spy:
        assert isinstance(t_cross, torch.Tensor)
        assert isinstance(d_cross, torch.Tensor)
        assert graphs is owner


# ----------------------------------------------------------------------
# the continuous engine's speculative blocks
# ----------------------------------------------------------------------


def _rebinding_spec_round(self, s, gamma):
    """The engine's round as it was before its blocks were captured: every
    update bound to a new tensor (the reference of the in-place round)."""
    cfg, b, dev = self.cfg, self.local, self.device
    pad, eos = cfg.pad_token_id, cfg.eos_token_id
    frozen, pos, plen = s["finished"], s["pos"], s["prompt_len"]
    last_tok = s["tokens"].gather(1, (pos - 1)[:, None])[:, 0]
    if self.ngram:
        drafts, found = S._propose_ngram(s["tokens"], pos, gamma,
                                         self.max_ngram, pad)
    else:
        drafts, found = self._draft(s, gamma), None
    t_logits, _ = TW.decode(self.pipe.params["decoder"], cfg,
                            torch.cat([last_tok[:, None], drafts], dim=1),
                            cross=s["cross"], cache=s["cache"],
                            pos_offset=pos - 1, dtype=self.dtype)
    bias_fn = None
    if self.synthetic_acceptance is not None:
        def bias_fn(scores, p):
            return S._bias_to(scores, S._oracle(p))
    elif self.synthetic_period is not None:
        from distil_whisper_tpu_torch.serving_engine import periodic_oracle
        lane = (torch.arange(b, device=dev) + self.lane0
                ).repeat_interleave(gamma + 1)

        def bias_fn(scores, p):
            return S._bias_to(scores, periodic_oracle(
                p, lane, self.synthetic_period))
    t_choice, t_logp = S._teacher_choices(
        t_logits, pos, plen, gamma, cfg, self.opts, bias_fn,
        ts_state=s["ts"], drafts=drafts, use_ts=s["use_ts"])
    window, n_eff, done = S._verify_accept(t_choice, drafts, pos,
                                           plen + s["budget"], eos, gamma)
    gen_idx = pos - plen
    emit = torch.minimum(n_eff + 1, (s["budget"] - gen_idx).clamp(min=1))
    emit = torch.where(frozen, 0, emit)
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    emitted = idx < emit[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    s["tokens"][rows, pos[:, None] + idx] = torch.where(emitted, window, pad)
    s["sum_logprobs"] = s["sum_logprobs"] + torch.where(
        emitted, t_logp, 0.0).sum(dim=1)
    new_ts = S._ts_advance(s["ts"], window, (emit - 1).clamp(min=0),
                           cfg.timestamp_begin)
    s["ts"] = TL.TimestampState(*(torch.where(emit > 0, n, o)
                                  for n, o in zip(new_ts, s["ts"])))
    s["finished"] = frozen | done
    dead = frozen if found is None else frozen | ~found
    s["drafted"] = s["drafted"] + torch.where(dead, 0, gamma)
    s["accepted"] = s["accepted"] + torch.where(
        dead, 0, (emit - 1).clamp(min=0))
    s["pos"] = pos + emit


ENGINES = {"draft": lambda d: dict(assistant=d),
           "draft_synthetic": lambda d: dict(assistant=d,
                                             synthetic_acceptance=0.7),
           "ngram_period": lambda d: dict(ngram_speculative=True,
                                          synthetic_period=4)}


@pytest.mark.parametrize("variant", sorted(ENGINES))
def test_engine_spec_state_in_place_equals_the_rebinding_engine(ckpts,
                                                               variant):
    """One admission sequence (re-admission of finished lanes, timestamps
    on one lane) through the in-place engine and through the rebinding
    round, blocks alternating draft lengths 2 and 4: equal packed vectors
    after every block, and every buffer of the in-place engine keeps its
    storage."""
    pipe = ckpts["pipe"]
    tok = pipe.tokenizer
    mels = torch.cat([compute_mel(tone(1.0, 200.0 + 60 * i, seed=i)[None],
                                  pipe.cfg, device="cpu") for i in range(4)])
    prompt = tok.prompt_ids(language="en", task="transcribe",
                            no_timestamps=True)
    ts_prompt = tok.prompt_ids(language="en", task="transcribe",
                               no_timestamps=False)
    admissions = {
        0: dict(idx=[0, 1, 2], prompts=[prompt, ts_prompt, prompt],
                budgets=[3, 9, 10], use_ts=[False, True, False],
                lanes=[0, 1, 2]),
        2: dict(idx=[3], prompts=[prompt], budgets=[8], use_ts=[False],
                lanes=[0]),
    }
    engines = []
    for rebinding in (False, True):
        eng = ContinuousBatchingEngine(pipe, lanes=3, block_steps=6,
                                       max_new_tokens=10, gamma=2,
                                       **ENGINES[variant](ckpts["draft"]))
        if rebinding:
            eng._spec_round = _rebinding_spec_round.__get__(eng)
        eng.init_state()
        engines.append(eng)
    assert engines[0].gamma_levels == (1, 2, 4)
    ptrs = _buffers(engines[0]._state)
    packed = [[], []]
    for block in range(8):
        for j, eng in enumerate(engines):
            a = admissions.get(block)
            if a is not None:
                eng.admit(mels[a["idx"]], a["prompts"], a["budgets"],
                          a["use_ts"], a["lanes"])
            packed[j].append(eng.step(gamma=2 if block % 2 else 4))
        assert _buffers(engines[0]._state) == ptrs
    for a, b in zip(*packed):
        assert torch.equal(a, b)
    finished, pos, _, (drafted, accepted) = engines[0].unpack(packed[0][-1])
    assert finished.all() and (pos > len(prompt)).all()
    assert drafted.sum() > 0


@pytest.mark.parametrize("variant", ["draft_synthetic", "ngram_period"])
def test_engine_spec_block_reads_nothing_from_the_device(ckpts,
                                                         no_host_reads,
                                                         variant):
    pipe = ckpts["pipe"]
    eng = ContinuousBatchingEngine(pipe, lanes=2, block_steps=6,
                                   max_new_tokens=10, gamma=2,
                                   **ENGINES[variant](ckpts["draft"]))
    eng.init_state()
    mels = torch.cat([compute_mel(tone(1.0, f, seed=0)[None], pipe.cfg,
                                  device="cpu") for f in (250.0, 330.0)])
    prompt = pipe.tokenizer.prompt_ids(language="en", task="transcribe",
                                       no_timestamps=False)
    eng.admit(mels, [prompt] * 2, [8, 8], [True, False], [0, 1])
    for g in eng.gamma_levels:      # the warm-ups a capture starts with
        eng._block(g)
    no_host_reads()
    for g in eng.gamma_levels:
        packed = eng._block(g)
    assert packed.shape == (4 * 2 + 2 * eng.t_buf,)
