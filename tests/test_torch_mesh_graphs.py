"""Meshed decodes through the blocked loops, on the CPU, against the plain
loops and the JAX package.

One job of two gloo ranks (tests/torch_mp_worker.py, mode ``graphs``) runs
on a (1, 2) tensor-parallel mesh and a (2, 1) 2-D mesh (``RULES_2D``):

- the plain device collective (``parallel/device_comm.py``: torch's
  all_gather, then the rank-ordered combine) in each mode: the same bits
  on both ranks, equal to the fp32 sum added in rank order, the exact
  (wrapping) int32 sum, the max with NaN kept and the rank-ordered gather;
- ``generate`` (greedy with timestamps; sampling from one generator seed),
  ``beam_search`` (2 beams) and draft speculation, each through the blocked
  loop (its body, run eagerly here; CUDA graphs on the card) against its
  plain loop (``generate_eager``, ``beam_search_eager``,
  ``speculate_eager``), bit for bit on every field, on both meshes;
- greedy tokens equal to JAX's unsharded ``encode_and_generate`` and beam
  tokens to JAX's ``beam_search`` on the same converted weights and mels,
  ``sum_logprobs`` within 1e-4 (tests/test_torch_tensor_parallel.py's
  tolerance: a row-parallel product sums its partials in another order);
- a 2-D decode whose data ranks' rows end at different steps (data rank
  0's encoder states drive the tiny decoder to EOS at once, rank 1's run
  to the budget): every loop finishes on both ranks, blocked equal to
  plain, and greedy and beam equal to one process's on the rank's rows
  bit for bit (a 2-D gather is exact);
- the continuous engine's blocks on both meshes: its lanes' tokens equal
  the meshed plain greedy loop's on the same rows.

- the comms' reservations (``mesh.shard_params``, ``WhisperPipeline``)
  against the largest collective the ranks then issue.

The ranks give up on a collective after 60 s and the job is killed after
:data:`JOB_TIMEOUT` s, so a hang fails this file, not the suite.  The JAX
references are computed once, while the ranks run.  Unit tests hold what
runs only on the card otherwise: a call larger than a slot split into
slots, each launched at its offsets; a comm made at its group's first
collective with the reserved slot, and never under a capture; the
program key's comm identity; a read of the card past the bound raising.
"""

import importlib
import json
import sys
from contextlib import nullcontext
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from torch_port_helpers import jax_init_params, to_numpy_tree, tone
from distil_whisper_tpu import training as J
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu_torch.audio import compute_mel
from distil_whisper_tpu_torch.config import WhisperConfig
from distil_whisper_tpu_torch.parallel import device_comm, groups

# the module (the package exports its function under the same name)
TG = importlib.import_module("distil_whisper_tpu_torch.generation.generate")

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE))
from test_torch_tensor_parallel import finish, start  # noqa: E402

WORLD = 2
JOB_TIMEOUT = 240
# tests/test_sharded_inference.py's config (as the tensor-parallel test's)
DIMS = dict(vocab_size=1902, num_mel_bins=80, d_model=64,
            encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=128, decoder_ffn_dim=128, pad_token_id=0,
            eos_token_id=300, decoder_start_token_id=3,
            begin_suppress_tokens=())
# the serving tests' engine config (the dry run's)
SERVE_DIMS = dict(vocab_size=51865, num_mel_bins=80, d_model=64,
                  encoder_layers=2, decoder_layers=2,
                  encoder_attention_heads=4, decoder_attention_heads=4,
                  encoder_ffn_dim=96, decoder_ffn_dim=96)
JCFG = JConfig(**DIMS)
LOOPS = ("ts", "sampled", "beam", "draft")
COLL_N = 1000


def _collective_inputs():
    """Each rank's input of each mode, from seeded numpy arrays: fp32 over
    six decades (the sum's order shows), int32 over its whole range (the
    sum wraps), fp32 with NaNs on rank 1 (the max keeps them), an odd
    count of int16 (the gather's padded rows)."""
    rng = np.random.default_rng(11)
    f = (rng.standard_normal((WORLD, COLL_N))
         * 10.0 ** rng.uniform(-3, 3, (WORLD, COLL_N))).astype(np.float32)
    i = rng.integers(-2 ** 31, 2 ** 31, (WORLD, COLL_N)).astype(np.int32)
    m = rng.standard_normal((WORLD, COLL_N)).astype(np.float32)
    m[1, ::97] = np.nan
    g = rng.integers(-2 ** 15, 2 ** 15, (WORLD, 333)).astype(np.int16)
    return {"coll_sum": f, "coll_sum_int": i, "coll_max": m,
            "coll_gather": g}


def _jax_references(m):
    """JAX's unsharded greedy generation with timestamps and beam search
    (2 beams) on the four mels."""
    from distil_whisper_tpu.generation import GenerationOptions as JOpts
    from distil_whisper_tpu.generation import encode_and_generate as j_gen
    from distil_whisper_tpu.generation.beam import beam_search as j_beam
    from distil_whisper_tpu.models.whisper import cross_kv, encode
    prompt = jnp.full((4, 1), 3, jnp.int32)
    mel = jnp.asarray(m["mel"])
    out = j_gen(m["inf"], JCFG, mel, prompt,
                JOpts(max_new_tokens=12, return_timestamps=True,
                      max_initial_timestamp_index=50))
    ref = {"ts_sequences": np.asarray(out.sequences),
           "ts_sum_logprobs": np.asarray(out.sum_logprobs)}
    dec = m["inf"]["decoder"]
    cross = cross_kv(dec, JCFG, encode(m["inf"]["encoder"], JCFG, mel))
    out = j_beam(dec, JCFG, cross, prompt, JOpts(max_new_tokens=12),
                 num_beams=2)
    ref.update(beam_sequences=np.asarray(out.sequences),
               beam_sum_logprobs=np.asarray(out.sum_logprobs))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_graphs")
    m = {"inf": jax_init_params(JCFG, 0)}
    draft, _ = J.init_student_from_teacher(m["inf"], JCFG, decoder_layers=1)
    m["mel"] = np.random.default_rng(0).standard_normal(
        (4, 80, 3000)).astype(np.float32)
    arrays = {"dims": json.dumps(DIMS), "serve_dims": json.dumps(SERVE_DIMS),
              "mel": m["mel"], "eos_scale": 3000.0, **_collective_inputs()}
    for prefix, tree in (("inf", m["inf"]), ("draft", draft)):
        arrays.update({f"{prefix}/{p}": np.asarray(x) for p, x in
                       j_tree_paths(to_numpy_tree(tree)).items()})
    scfg = WhisperConfig(**SERVE_DIMS)
    arrays["serve_mel"] = torch.cat([compute_mel(
        tone(1.0, 200.0 + 60 * i, seed=i)[None], scfg, device="cpu")
        for i in range(2)]).numpy()
    np.savez(tmp / "inputs.npz", **arrays)
    out = tmp / "out"
    out.mkdir()
    procs, logs = start("graphs", tmp / "inputs.npz", out, world=WORLD)
    try:
        m["ref"] = _jax_references(m)
    finally:
        finish(procs, logs, timeout=JOB_TIMEOUT)
    m["ranks"] = [dict(np.load(out / f"graphs-rank{r}.npz"))
                  for r in range(WORLD)]
    m["inputs"] = arrays
    return m


def _fields(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def test_plain_collective_modes(run):
    """Identical bits on both ranks, equal to the rank-ordered combine."""
    x = run["inputs"]
    with np.errstate(over="ignore"):
        want = {"sum": x["coll_sum"][0] + x["coll_sum"][1],
                "sum_int": (x["coll_sum_int"][0].astype(np.int64)
                            + x["coll_sum_int"][1]).astype(np.int32)}
    a, b = x["coll_max"]
    want["max"] = np.where((b > a) | np.isnan(b), b, a)
    want["gather"] = x["coll_gather"]
    for mode, w in want.items():
        got = [r[f"coll/{mode}"] for r in run["ranks"]]
        assert got[0].tobytes() == got[1].tobytes(), mode
        assert got[0].dtype == w.dtype and got[0].shape == w.shape, mode
        assert got[0].tobytes() == w.tobytes(), mode
    assert np.isnan(want["max"]).sum() == len(range(0, COLL_N, 97))


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("mesh", ["tp", "dd", "eos"])
def test_blocked_equals_eager(run, mesh, loop):
    """Every field bit for bit, on each rank: the blocked loop's body
    (CUDA graphs on the card) against the plain loop on the same ranks."""
    for r, arrays in enumerate(run["ranks"]):
        blocked = _fields(arrays, f"{mesh}/{loop}")
        plain = _fields(arrays, f"{mesh}/eager_{loop}")
        assert blocked and sorted(blocked) == sorted(plain)
        for f in blocked:
            assert blocked[f].dtype == plain[f].dtype, (r, f)
            np.testing.assert_array_equal(blocked[f], plain[f],
                                          err_msg=f"rank {r} {f}")


def test_tensor_parallel_ranks_agree_bit_for_bit(run):
    """The ranks of a model group hold the same rows and, the combine in
    rank order, return the same bits."""
    a, b = run["ranks"]
    for k in a:
        if k.startswith("tp/"):
            assert a[k].tobytes() == b[k].tobytes(), k


def _data_rows(run, key):
    return np.concatenate([r[key] for r in run["ranks"]])


@pytest.mark.parametrize("mesh", ["tp", "dd"])
def test_greedy_and_beam_match_jax(run, mesh):
    """Tokens equal JAX's unsharded runs; ``sum_logprobs`` within 1e-4."""
    ref = run["ref"]
    got = (run["ranks"][0] if mesh == "tp"
           else {k: _data_rows(run, k) for k in run["ranks"][0]
                 if k.startswith("dd/")})
    for loop in ("ts", "beam"):
        np.testing.assert_array_equal(got[f"{mesh}/{loop}/sequences"],
                                      ref[f"{loop}_sequences"])
        np.testing.assert_allclose(got[f"{mesh}/{loop}/sum_logprobs"],
                                   ref[f"{loop}_sum_logprobs"], rtol=1e-4,
                                   atol=1e-4)


def test_data_ranks_that_end_apart_agree_to_stop(run):
    """Data rank 0's rows end at once, rank 1's run to the budget: both
    ranks finish (the stop is agreed over the data group), and greedy and
    beam equal one process's on the rank's rows bit for bit."""
    r0, r1 = run["ranks"]
    assert r0["eos/ts/seq_len"].max() + 5 <= r1["eos/ts/seq_len"].min()
    for arrays in (r0, r1):
        for loop, one in (("ts", "one_process"),
                          ("beam", "one_process_beam")):
            mine, ref = (_fields(arrays, f"eos/{k}") for k in (loop, one))
            for f in ref:
                np.testing.assert_array_equal(mine[f], ref[f], err_msg=f)


@pytest.mark.parametrize("mesh", ["tp", "dd"])
def test_engine_blocks_under_a_mesh(run, mesh):
    """The engine's lanes (split over 'data' on the 2-D mesh, each rank's
    packed vector gathered) end with the plain greedy loop's tokens on the
    same rows."""
    for arrays in run["ranks"]:
        assert arrays[f"engine_{mesh}/finished"].all()
        plain = _data_rows(run, f"engine_{mesh}/plain") if mesh == "dd" \
            else arrays[f"engine_{mesh}/plain"]
        tokens = arrays[f"engine_{mesh}/tokens"]
        for lane in range(2):
            n = int(arrays[f"engine_{mesh}/pos"][lane])
            np.testing.assert_array_equal(tokens[lane, :n],
                                          plain[lane, :n])


@pytest.mark.parametrize("where", ["tp", "dd", "engine_tp", "engine_dd"])
def test_comms_are_reserved_for_the_largest_collective_issued(run, where):
    """What ``shard_params`` and ``WhisperPipeline`` reserve for a group's
    comm is the largest collective a rank then issues over it: the 2-D
    tree's largest flat gather (``dd``: its decodes; ``engine_dd``: the
    engine's), the encoder's fp32 row-parallel partial of the pipeline's
    batch (``engine_tp``); a tensor-parallel tree sharded alone reserves
    one window's partial, and an encode of four runs past it, a slot at a
    time (``tp``)."""
    for arrays in run["ranks"]:
        if where == "tp":
            assert int(arrays["issued/tp"]) == 4 * int(arrays["reserved/tp"])
        else:
            assert int(arrays[f"issued/{where}"]) == int(
                arrays[f"reserved/{where}"])


@pytest.mark.parametrize("nbytes,slot,want", [
    (0, 1024, []),
    (1000, 1024, [(0, 1000)]),
    (2048, 1024, [(0, 1024), (1024, 1024)]),
    (2500, 1024, [(0, 1024), (1024, 1024), (2048, 452)]),
])
def test_a_call_larger_than_a_slot_runs_a_slot_at_a_time(nbytes, slot, want):
    assert device_comm.pieces(nbytes, slot) == want


class _Lib:
    """The kernel library's collective, recorded (no card)."""

    def __init__(self):
        self.calls = []

    def dw_mc_collective(self, bases, n, me, slot, mode, x, out, count,
                         stride, stream):
        self.calls.append((slot, mode, x, out, count, stride))
        return 0


def _fake_comm(slot=1024):
    """A DeviceComm's host side without a card: its ranks and slot."""
    comm = object.__new__(device_comm.DeviceComm)
    comm.ranks, comm.me, comm.n = [0, 1], 0, 2
    comm.slot, comm.bases = slot, None
    comm.device = torch.device("cpu")
    comm.key = ((0, 1), 0x1000)
    return comm


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("mode", ["sum", "gather"])
def test_pieces_launch_at_their_offsets(monkeypatch, mode):
    """A reduction of 700 fp32 (2800 bytes) or a gather of 2800 bytes
    through slots of 1024: three launches, each at its byte offset of the
    input and the output (a gather's rows keep their stride), each
    counted."""
    lib = _Lib()
    monkeypatch.setattr(device_comm, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    comm = _fake_comm(slot=1024)
    x = torch.zeros(700)
    out = torch.zeros(2 * 2800 if mode == "gather" else 700)
    stride = 2800 if mode == "gather" else 0
    counter = device_comm.COUNTERS[mode]
    before = counter.launches
    comm._launch(mode, x, out, 2800, stride)
    unit = 1 if mode == "gather" else 4
    assert lib.calls == [
        (1024, device_comm.MODES[mode], x.data_ptr() + o,
         out.data_ptr() + o, n // unit, stride)
        for o, n in ((0, 1024), (1024, 1024), (2048, 752))]
    assert counter.launches == before + 3


def test_a_comm_is_made_at_its_first_call_with_the_reserved_slot(
        monkeypatch):
    """No comm until a collective over the group's ranks; then one, its
    slot the largest of the reservations and that call, kept (a larger
    call later makes no other); a capture makes none."""
    made = []
    other = object()      # another mesh's group of the same ranks

    class Made:
        def __init__(self, group, slot):
            made.append((group, slot))

    group = object()
    monkeypatch.setattr(device_comm, "DeviceComm", Made)
    monkeypatch.setattr(device_comm, "_ranks", lambda g: (0, 1))
    monkeypatch.setattr(device_comm, "_COMMS", {})
    monkeypatch.setattr(device_comm, "_RESERVED", {})
    device_comm.reserve(group, 8 << 20)      # no job: nothing reserved
    assert device_comm.reserved((0, 1)) == 0
    monkeypatch.setattr(device_comm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before its device comm"):
        device_comm.comm_of(group, 100)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    device_comm.reserve(other, 3 << 20)
    device_comm.reserve(group, 2 << 20)
    comm = device_comm.comm_of(group, 5 << 20)
    assert made == [(group, 5 << 20)]
    assert device_comm.comm_of(group, 9 << 20) is comm
    assert device_comm.comms() == [comm] and len(made) == 1
    monkeypatch.setattr(device_comm, "_COMMS", {})
    device_comm.comm_of(group, 100)
    assert made[-1] == (group, 3 << 20)
    monkeypatch.setattr(device_comm, "_COMMS", {})
    monkeypatch.setattr(device_comm, "_RESERVED", {})
    device_comm.comm_of(group, 100)
    assert made[-1] == (group, device_comm.MIN_SLOT)


def test_program_key_holds_the_comm(monkeypatch):
    """A sharded tree's program key holds its comm's ranks and, on the
    card, its workspace (a captured program holds the workspace's
    address)."""
    cfg = WhisperConfig(**DIMS)
    group = object()
    comm = _fake_comm()
    monkeypatch.setattr(groups, "_GROUPS", {("model", 2): group})
    monkeypatch.setattr(device_comm, "_ranks", lambda g: (0, 1))
    monkeypatch.setattr(device_comm, "_COMMS", {(0, 1): comm})
    q = {"kernel": torch.zeros(2, 64, 32), "bias": torch.zeros(2, 32)}
    dec = {"layers": {"self_attn": {"q": q}}}
    assert TG._comm_key(dec, cfg) == (((0, 1),),)
    assert device_comm.key_of((group, None), True) == (((0, 1), 0x1000),)
    whole = {"layers": {"self_attn": {"q": {"kernel": torch.zeros(2, 64,
                                                                   64)}}}}
    assert TG._comm_key(whole, cfg) == ()
    assert TG._mesh_groups(dec, cfg) == (group, None)


def test_a_read_past_the_bound_raises(monkeypatch):
    """A decode loop's read of the card waits for the stream at most
    ``TIMEOUT_S`` while a comm exists (a collective waiting for a peer
    that does not come), then raises with the comm's ranks."""

    class Event:
        def record(self, stream):
            pass

        def query(self):
            return False

    comm = _fake_comm()
    monkeypatch.setattr(device_comm, "_COMMS", {(0, 1): comm})
    monkeypatch.setattr(device_comm, "TIMEOUT_S", 0.05)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    with pytest.raises(device_comm.CommError,
                       match=r"within 0.05 s.*ranks \[0, 1\]"):
        device_comm.wait_device(torch.device("cpu"))
    monkeypatch.setattr(device_comm, "_COMMS", {})
    device_comm.wait_device(torch.device("cpu"))      # no comm: no wait
