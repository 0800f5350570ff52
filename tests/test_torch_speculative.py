"""Port speculative decoding (CPU, fp32), in the form of
``tests/test_speculative.py``: the draft-model and n-gram methods emit the
teacher's greedy tokens (with timestamps, on padded prompts, batched and at
batch 1), a draft equal to the teacher accepts every proposal, the
benchmark oracles follow their laws, and the port's batched loops equal
JAX's ``speculative_generate_batched`` and
``ngram_speculative_generate_batched`` on one seed: the same tokens, and for
the n-gram method the same ``rounds``, ``drafted`` and ``accepted`` per
lane.  The draft method's counters part from JAX's on purpose: the
reference's draft reads two cache slots it never wrote
(``test_reference_draft_reads_stale_slots``).

Parameters come from the JAX init (the draft from JAX's
``init_student_from_teacher``), converted leaf for leaf; the greedy
reference is the port's ``generate``, which ``tests/test_torch_generate.py``
holds token-identical to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import jax_init_params, torch_params
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.generation import GenerationOptions as JOpts
from distil_whisper_tpu.generation import speculative as JS
from distil_whisper_tpu.models import whisper as JW
from distil_whisper_tpu.training import init_student_from_teacher
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.generation import GenerationOptions, generate
from distil_whisper_tpu_torch.generation import speculative as S
from distil_whisper_tpu_torch.models.whisper import cross_kv, encode

ARCH = dict(vocab_size=512, num_mel_bins=80, d_model=64, encoder_layers=2,
            decoder_layers=4, encoder_attention_heads=4,
            decoder_attention_heads=4, encoder_ffn_dim=96, decoder_ffn_dim=96,
            pad_token_id=0, eos_token_id=2, decoder_start_token_id=3,
            begin_suppress_tokens=())
# the real vocabulary tail: timestamp_begin = 1902 - 1501 = 401
TS_ARCH = dict(ARCH, vocab_size=1902, eos_token_id=300)
N_LANES = 3


def _models(arch, seed, mel_seed):
    jcfg = JConfig(**arch)
    jp = jax_init_params(jcfg, seed)
    jdraft, jd_cfg = init_student_from_teacher(jp, jcfg, decoder_layers=2)
    cfg = WhisperConfig(**arch)
    d_cfg = cfg.replace(decoder_layers=2)
    teacher = torch_params(jp)
    draft = torch_params(jdraft)
    mel = np.random.default_rng(mel_seed).standard_normal(
        (N_LANES, 80, 3000)).astype(np.float32)
    enc = encode(teacher["encoder"], cfg, torch.from_numpy(mel))
    return dict(cfg=cfg, d_cfg=d_cfg, t=teacher["decoder"],
                d=draft["decoder"], tc=cross_kv(teacher["decoder"], cfg, enc),
                dc=cross_kv(draft["decoder"], d_cfg, enc), jp=jp,
                jdraft=jdraft, jcfg=jcfg, jd_cfg=jd_cfg, mel=mel)


def _lane(tree, i):
    return {k: v[:, i:i + 1] for k, v in tree.items()}


@pytest.fixture(scope="module")
def plain():
    return _models(ARCH, 0, 3)


@pytest.fixture(scope="module")
def ts():
    """The timestamp vocabulary, and JAX's batched loops on it (one jitted
    program): the 2-layer draft, the n-gram lookup and a draft equal to the
    teacher; the lanes' prompts differ so that they accept differently."""
    m = _models(TS_ARCH, 2, 5)
    prompts = np.array([[3, 17], [3, 55], [3, 121]], np.int32)
    kw = dict(max_new_tokens=24, return_timestamps=True,
              max_initial_timestamp_index=50, no_speech_token_id=398)

    @jax.jit
    def golden(jp, jd, mel, prompts):
        enc = JW.encode(jp["encoder"], m["jcfg"], mel)
        tc = JW.cross_kv(jp["decoder"], m["jcfg"], enc)
        dc = JW.cross_kv(jd["decoder"], m["jd_cfg"], enc)
        opts = JOpts(**kw)
        draft = JS.speculative_generate_batched(
            jp["decoder"], m["jcfg"], jd["decoder"], m["jd_cfg"], tc, dc,
            prompts, opts, gamma=3)
        ngram = JS.ngram_speculative_generate_batched(
            jp["decoder"], m["jcfg"], tc, prompts, opts, gamma=3,
            max_ngram=2)
        self_draft = JS.speculative_generate_batched(
            jp["decoder"], m["jcfg"], jp["decoder"], m["jcfg"], tc, tc,
            prompts, opts, gamma=3)
        return draft, ngram, self_draft

    m["golden"] = jax.tree.map(np.asarray, golden(
        m["jp"], m["jdraft"], jnp.asarray(m["mel"]), jnp.asarray(prompts)))
    m["prompts"] = torch.from_numpy(prompts).long()
    m["opts_kw"] = kw
    return m


def _same_tokens(out, golden, i=0, j=0):
    a = out.sequences[i, :int(out.seq_len[i])]
    b = golden.sequences[j, :int(golden.seq_len[j])]
    assert torch.equal(a, b), (a, b)


def _same_output(out, golden, check_logprobs=True):
    for i in range(out.sequences.shape[0]):
        _same_tokens(out, golden, i, i)
    if check_logprobs:
        np.testing.assert_allclose(out.sum_logprobs.numpy(),
                                   golden.sum_logprobs.numpy(), atol=2e-3,
                                   rtol=1e-4)
        np.testing.assert_allclose(out.no_speech_prob.numpy(),
                                   golden.no_speech_prob.numpy(), atol=1e-5)


def test_batched_matches_jax(ts):
    """The port's batched loops against JAX's vmapped ones: tokens, lengths
    and log-probabilities, and the n-gram method's rounds, drafted and
    accepted per lane (its proposals depend on the tokens alone)."""
    cfg, prompts = ts["cfg"], ts["prompts"]
    opts = GenerationOptions(**ts["opts_kw"])
    ours = {"draft": S.speculative_generate_batched(
                ts["t"], cfg, ts["d"], ts["d_cfg"], ts["tc"], ts["dc"],
                prompts, opts, gamma=3),
            "ngram": S.ngram_speculative_generate_batched(
                ts["t"], cfg, ts["tc"], prompts, opts, gamma=3, max_ngram=2)}
    for (name, out), golden in zip(ours.items(), ts["golden"][:2]):
        np.testing.assert_array_equal(out.sequences.numpy(),
                                      golden.sequences, err_msg=name)
        counters = ("rounds", "drafted", "accepted") if name == "ngram" else ()
        for key in ("seq_len",) + counters:
            np.testing.assert_array_equal(getattr(out, key).numpy(),
                                          getattr(golden, key),
                                          err_msg=f"{name} {key}")
        np.testing.assert_allclose(out.sum_logprobs.numpy(),
                                   golden.sum_logprobs, atol=2e-3, rtol=1e-4)
    draft = ours["draft"]
    assert torch.equal(draft.drafted, 3 * draft.rounds)
    # the lanes took different accept patterns
    assert len(set(ours["draft"].accepted.tolist())) > 1


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_identical_to_teacher_greedy(plain, gamma):
    m = plain
    opts = GenerationOptions(max_new_tokens=32, suppress_tokens=(7, 8))
    prompt = torch.tensor([[3]])
    golden = generate(m["t"], m["cfg"], _lane(m["tc"], 0), prompt, opts)
    out = S.speculative_generate_batched(
        m["t"], m["cfg"], m["d"], m["d_cfg"], _lane(m["tc"], 0),
        _lane(m["dc"], 0), prompt, opts, gamma=gamma)
    _same_tokens(out, golden)
    assert out.rounds.shape == (1,)


def _self_draft(m, opts, gamma=3):
    return S.speculative_generate_batched(m["t"], m["cfg"], m["t"], m["cfg"],
                                          m["tc"], m["tc"], m["prompts"],
                                          opts, gamma=gamma)


def test_draft_equals_teacher_accepts_everything(ts):
    """A draft equal to the teacher accepts every proposal: each round but
    a lane's last emits gamma + 1 tokens, so the rounds are the fewest the
    tokens allow, and only an EOS inside the last window leaves proposals
    unaccepted.  The tokens stay the teacher's greedy tokens."""
    m, gamma = ts, 3
    opts = GenerationOptions(**m["opts_kw"])
    out = _self_draft(m, opts, gamma)
    _same_output(out, generate(m["t"], m["cfg"], m["tc"], m["prompts"], opts))
    emitted = out.seq_len - m["prompts"].shape[1] - 1
    assert torch.equal(out.rounds, (emitted + gamma) // (gamma + 1))
    assert torch.equal(out.drafted, gamma * out.rounds)
    assert bool((out.drafted - out.accepted <= gamma).all())
    assert int(out.accepted.sum()) > 0


def test_reference_draft_reads_stale_slots(ts):
    """JAX parity of the draft method on a draft equal to the teacher: the
    same tokens and lengths as JAX's loop, and more accepted proposals.
    The reference's draft never writes the K/V of the last prompt token
    (its prefill stops one short and its first step feeds the first
    generated token) nor of its own last proposal of a fully accepted
    round, and attends to those slots unwritten; the port's first step of a
    round feeds both."""
    m = ts
    out = _self_draft(m, GenerationOptions(**m["opts_kw"]))
    golden = m["golden"][2]
    for key in ("sequences", "seq_len"):
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      getattr(golden, key), err_msg=key)
    assert int(golden.accepted.sum()) < int(out.accepted.sum())
    assert int(golden.rounds.sum()) > int(out.rounds.sum())


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_batched_matches_per_sample_bs1(plain, method):
    """Every lane of the batched loop equals the batch-1 loop on that
    sample alone, and the teacher's greedy tokens."""
    m, n = plain, N_LANES
    opts = GenerationOptions(max_new_tokens=24)
    prompts = torch.tensor([[3, 9], [3, 40], [3, 77]])

    def run(tc, dc, prompt):
        if method == "draft":
            return S.speculative_generate_batched(
                m["t"], m["cfg"], m["d"], m["d_cfg"], tc, dc, prompt, opts,
                gamma=3)
        return S.ngram_speculative_generate_batched(
            m["t"], m["cfg"], tc, prompt, opts, gamma=3)

    out = run(m["tc"], m["dc"], prompts)
    assert out.sequences.shape == (n, 2 + 24) and out.rounds.shape == (n,)
    golden = generate(m["t"], m["cfg"], m["tc"], prompts, opts)
    for i in range(n):
        single = run(_lane(m["tc"], i), _lane(m["dc"], i), prompts[i:i + 1])
        _same_tokens(out, single, i, 0)
        for key in ("rounds", "drafted", "accepted"):
            assert int(getattr(out, key)[i]) == int(getattr(single, key)[0])
        _same_tokens(out, golden, i, i)


def test_synthetic_acceptance_follows_prefix_law(plain):
    """``synthetic_acceptance`` = k drives the accept/verify loop at a
    per-token accept probability k: its counters equal a host simulation
    of the same position-keyed coins round for round, the accepted share
    follows the prefix law sum_i k^i / gamma, and rounds fall as k grows."""
    m = plain
    opts = GenerationOptions(max_new_tokens=96)
    prompt = torch.tensor([[3]])
    gamma, stats = 5, {}
    for k in (0.6, 0.8, 0.95):
        out = S.speculative_generate_batched(
            m["t"], m["cfg"], m["d"], m["d_cfg"], _lane(m["tc"], 0),
            _lane(m["dc"], 0), prompt, opts, gamma=gamma,
            synthetic_acceptance=k)
        assert int(out.seq_len[0]) == 1 + 96      # the oracle never ends
        stats[k] = (int(out.drafted), int(out.accepted), int(out.rounds))
        coins = S.synthetic_coins(0, 1 + 96 + gamma + 1, k)
        p, total = 1, 97
        cur, drafted, accepted, rounds = p + 1, 0, 0, 0
        while cur < total:
            n = 0
            for i in range(gamma):
                if not coins[cur + i]:
                    break
                n += 1
            drafted, accepted, rounds = drafted + gamma, accepted + n, rounds + 1
            if cur + n + 1 >= total:
                break
            cur += n + 1
        assert stats[k] == (drafted, accepted, rounds), k
        expected = sum(k ** i for i in range(1, gamma + 1)) / gamma
        assert abs(accepted / drafted - expected) < 0.15
    assert stats[0.6][2] > stats[0.8][2] > stats[0.95][2], stats


def test_ngram_propose_unit():
    """Longest match wins, its continuation is copied, and neither the gram
    itself nor the junk at or past ``cur`` is a match source; lanes look up
    at their own cursors; the port equals JAX's lookup."""
    toks = torch.tensor([[5, 6, 7, 9, 5, 6, 7, 1, 1, 1, 1, 1]])
    d, found = S._propose_ngram(toks, 7, gamma=3, max_ngram=3, pad_id=0)
    assert bool(found[0]) and d[0].tolist() == [9, 5, 6]
    toks2 = torch.tensor([[3, 4, 5, 6, 7, 8, 0, 0, 0, 0, 0, 0]])
    d2, found2 = S._propose_ngram(toks2, 6, gamma=3, max_ngram=3, pad_id=0)
    assert not bool(found2[0]) and d2[0].tolist() == [0, 0, 0]
    toks3 = torch.tensor([[3, 4, 5, 6, 7, 8, 6, 7, 8, 9, 9, 9]])
    _, found3 = S._propose_ngram(toks3, 6, gamma=3, max_ngram=3, pad_id=0)
    assert not bool(found3[0])
    # batched: lane cursors and pad starts of their own, against JAX lane
    # by lane
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 5, (4, 20))
    toks[3] = np.arange(10, 30)              # no repeat: nothing found
    cur = np.array([7, 12, 15, 4])
    starts = np.array([0, 3, 6, 0])
    d, found = S._propose_ngram(torch.from_numpy(toks), torch.from_numpy(cur),
                                gamma=4, max_ngram=3, pad_id=0,
                                min_start=torch.from_numpy(starts))
    jfn = jax.jit(JS._propose_ngram, static_argnums=(2, 3, 4))
    for b in range(4):
        jd, jfound = jfn(jnp.asarray(toks[b:b + 1], jnp.int32),
                         jnp.asarray(cur[b], jnp.int32), 4, 3, 0,
                         jnp.asarray(starts[b], jnp.int32))
        assert bool(found[b]) == bool(jfound)
        assert d[b].tolist() == np.asarray(jd).tolist()
    assert found.any() and not found.all()


@pytest.mark.parametrize("gamma,max_ngram", [(3, 2), (5, 3)])
def test_ngram_identical_to_teacher_greedy(plain, gamma, max_ngram):
    m = plain
    opts = GenerationOptions(max_new_tokens=32, suppress_tokens=(7, 8))
    prompt = torch.tensor([[3]])
    tc = _lane(m["tc"], 0)
    out = S.ngram_speculative_generate_batched(
        m["t"], m["cfg"], tc, prompt, opts, gamma=gamma, max_ngram=max_ngram)
    _same_tokens(out, generate(m["t"], m["cfg"], tc, prompt, opts))


@pytest.mark.parametrize("method,gamma", [("draft", 2), ("draft", 4),
                                          ("ngram", 3)])
def test_timestamped_identical_to_greedy(ts, method, gamma):
    m = ts
    opts = GenerationOptions(**m["opts_kw"])
    prompt = torch.tensor([[3]])
    golden = generate(m["t"], m["cfg"], _lane(m["tc"], 0), prompt, opts)
    if method == "draft":
        out = S.speculative_generate_batched(
            m["t"], m["cfg"], m["d"], m["d_cfg"], _lane(m["tc"], 0),
            _lane(m["dc"], 0), prompt, opts, gamma=gamma)
    else:
        out = S.ngram_speculative_generate_batched(
            m["t"], m["cfg"], _lane(m["tc"], 0), prompt, opts, gamma=gamma)
    _same_output(out, golden)
    seq = out.sequences[0, 1:int(out.seq_len[0])].tolist()
    ts_begin = m["cfg"].timestamp_begin
    assert ts_begin <= seq[0] <= ts_begin + 50
    stamps = [t for t in seq if t >= ts_begin]
    assert stamps == sorted(stamps)


def test_sum_logprobs_match_generate(plain):
    m = plain
    opts = GenerationOptions(max_new_tokens=24, no_speech_token_id=101)
    prompts = torch.tensor([[3]] * N_LANES)
    golden = generate(m["t"], m["cfg"], m["tc"], prompts, opts)
    out = S.speculative_generate_batched(m["t"], m["cfg"], m["d"],
                                         m["d_cfg"], m["tc"], m["dc"],
                                         prompts, opts, gamma=3)
    _same_output(out, golden)
    outn = S.ngram_speculative_generate_batched(m["t"], m["cfg"], m["tc"],
                                                prompts, opts, gamma=3)
    _same_output(outn, golden)


@pytest.mark.parametrize("method", ["draft", "ngram"])
def test_padded_prompt_drop_in(ts, method):
    """Left-padded condition-on-prev prompts (``pad_len`` with a static
    ``sot_slot``), lanes padded differently in one batch, decode as
    ``generate`` does under speculation, timestamps on."""
    m = ts
    opts = GenerationOptions(**dict(m["opts_kw"], max_new_tokens=24))
    # [pad.. | <|startofprev|>-like context | sot]; pad_len 2, 4 and 0
    prompts = torch.tensor([[0, 0, 17, 55, 21, 3], [0, 0, 0, 0, 9, 3],
                            [5, 6, 7, 8, 9, 3]])
    pad_len = torch.tensor([2, 4, 0])
    golden = generate(m["t"], m["cfg"], m["tc"], prompts, opts,
                      pad_len=pad_len, sot_slot=5)
    if method == "draft":
        out = S.speculative_generate_batched(
            m["t"], m["cfg"], m["d"], m["d_cfg"], m["tc"], m["dc"], prompts,
            opts, gamma=3, pad_len=pad_len, sot_slot=5)
    else:
        out = S.ngram_speculative_generate_batched(
            m["t"], m["cfg"], m["tc"], prompts, opts, gamma=3,
            pad_len=pad_len, sot_slot=5)
    _same_output(out, golden)


def test_ngram_periodic_oracle_accepts_all_lookups(plain):
    m = plain
    opts = GenerationOptions(max_new_tokens=64)
    out = S.ngram_speculative_generate_batched(
        m["t"], m["cfg"], _lane(m["tc"], 0), torch.tensor([[3]]), opts,
        gamma=4, max_ngram=3, synthetic_period=8)
    drafted, accepted = int(out.drafted), int(out.accepted)
    assert drafted > 0 and accepted == drafted
    assert (int(out.seq_len[0]) - 1) / int(out.rounds) > 2.0


def _simulate_ngram_oracle(oracle, p, total, gamma, max_ngram, pad=0):
    """Host replay of the n-gram loop against a teacher that always picks
    ``oracle(pos)``: the same token buffer (rejected proposals stay past the
    cursor), the same lookup rule, the same counters."""
    buf = [pad] * (total + gamma + 1)
    buf[0] = 3
    buf[p] = oracle(p)
    cur, rounds, drafted, accepted = p + 1, 0, 0, 0
    while cur < total:
        start = None
        for k in range(max_ngram, 0, -1):
            if cur < k + 1:
                continue
            gram = buf[cur - k:cur]
            hits = [j for j in range(0, cur - k) if buf[j:j + k] == gram]
            if hits:
                start = max(hits) + k
                break
        drafts = buf[start:start + gamma] if start is not None else [pad] * gamma
        n = 0
        while n < gamma and drafts[n] == oracle(cur + n):
            n += 1
        window = drafts + [oracle(cur + gamma)]
        window[n] = oracle(cur + n)
        buf[cur:cur + gamma + 1] = window
        g = gamma if start is not None else 0
        rounds, drafted, accepted = rounds + 1, drafted + g, accepted + min(n, g)
        if cur + n + 1 >= total:
            break
        cur += n + 1
    return rounds, drafted, accepted


def test_ngram_repeat_prob_calibrates_acceptance(plain):
    """``synthetic_repeat_prob`` q dilutes the period oracle into q-repeating
    text.  The loop's counters equal a host replay of the same oracle
    stream (the repeat coins from seed 9) for each q; acceptance is total at
    q = 1, near zero at q = 0 (only chance repeats of the filler tokens,
    which take 101 values in this vocabulary, give lookups), and higher at
    q = 0.75 than at q = 0 and 0.5.  (JAX's test asks q = 0 <= q = 0.5 on
    its own coin draws; at 72 tokens the two rates lie within the noise of
    chance repeats, so on the port's draws the ordering of 0 and 0.5 says
    nothing.)"""
    m = plain
    opts = GenerationOptions(max_new_tokens=72)
    rates = {}
    for q in (0.0, 0.5, 0.75, 1.0):
        out = S.ngram_speculative_generate_batched(
            m["t"], m["cfg"], _lane(m["tc"], 0), torch.tensor([[3]]), opts,
            gamma=4, max_ngram=3, synthetic_period=8, synthetic_repeat_prob=q)
        assert int(out.seq_len[0]) == 1 + 72, q
        repeat = (S.synthetic_coins(9, 1 + 72 + 5, q) if q < 1.0 else None)

        def oracle(pos):
            return int(S._periodic_oracle(torch.tensor([pos]), 8, 512,
                                          repeat)[0])
        counts = (int(out.rounds), int(out.drafted), int(out.accepted))
        assert counts == _simulate_ngram_oracle(oracle, 1, 73, 4, 3), q
        rates[q] = counts[2] / counts[1] if counts[1] else 0.0
    assert rates[1.0] == 1.0, rates
    assert rates[0.0] <= 0.2, rates
    assert rates[0.75] > max(rates[0.0], rates[0.5]), rates
