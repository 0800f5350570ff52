"""Tensor parallelism over the mesh's 'model' axis on the CPU, against the
JAX package.

One job of four gloo ranks (tests/torch_mp_worker.py, mode ``tp``) runs,
on a (2, 2) and a (1, 4) mesh:

- greedy generation with timestamps on the (2, 2) mesh, each data rank
  its rows: tokens equal JAX's unsharded ``encode_and_generate`` and
  ``sum_logprobs`` within 1e-4 (tests/test_sharded_inference.py's tiny
  config: 4 heads, ffn 128); int8 generation equal to JAX's unsharded int8
  run; draft speculation on the (1, 4) mesh equal to JAX's;
- the shard/gather round trip, and quantizing the shards equal to sharding
  the quantized tree;
- the distillation step, plain, QAT w8a8, with the int8 teacher and with
  clipped gradients, two steps: the parameters after each (gathered) equal
  JAX's step on its (4, 2) mesh over the same global batch at 1e-5, every
  rank the same;
- a checkpoint written at tp 2 restores into a one-process state and
  continues as the tp run did;
- ``WhisperPipeline(..., mesh=)`` texts (and word timestamps) on every
  rank equal the one-process pipeline's;
- ``run_distillation --distributed --model_parallel 2``: its losses equal
  a one-process replay of the data ranks' batches.

The JAX references are computed while the ranks run, and the CLI's
checkpoints and manifests beside them (the ranks wait for those only
where the CLI runs).  Plain unit tests
hold the shard rules, the degree checks and the int8 MLP's partial mode.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from helpers import make_tiny_checkpoint
from torch_port_helpers import jax_init_params, to_numpy_tree, tone
from distil_whisper_tpu import training as J
from distil_whisper_tpu.config import WhisperConfig as JConfig
from distil_whisper_tpu.models import param_axes as j_param_axes
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu.parallel import make_mesh as j_make_mesh
from distil_whisper_tpu.parallel import replicated as j_replicated
from distil_whisper_tpu.parallel import shard_batch as j_shard_batch
from distil_whisper_tpu.parallel import shard_params as j_shard_params
from distil_whisper_tpu.parallel import shardings_for_tree as j_shardings

HERE = Path(__file__).parent
WORKER = HERE / "torch_mp_worker.py"
sys.path.insert(0, str(HERE))
from torch_mp_worker import BASE_OPT, TP_STEP_CASES, TP_STEPS  # noqa: E402

WORLD = 4
# tests/test_sharded_inference.py's config
INF_DIMS = dict(vocab_size=1902, num_mel_bins=80, d_model=64,
                encoder_layers=2, decoder_layers=2,
                encoder_attention_heads=4, decoder_attention_heads=4,
                encoder_ffn_dim=128, decoder_ffn_dim=128, pad_token_id=0,
                eos_token_id=300, decoder_start_token_id=3,
                begin_suppress_tokens=())
# the step's, as tests/test_torch_multiprocess.py's
DIMS = dict(vocab_size=512, num_mel_bins=8, d_model=32, encoder_layers=2,
            decoder_layers=4, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=64,
            decoder_ffn_dim=64, max_source_positions=16,
            max_target_positions=32)
JINF, JCFG = JConfig(**INF_DIMS), JConfig(**DIMS)
TEXTS = ["the cat sat", "a dog ran fast", "hello world now", "we are here",
         "it is late", "go home soon", "stars shine bright", "rain falls"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(mode, *args, world=WORLD):
    """The ranks of ``mode``, started; :func:`finish` waits for them."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent), str(HERE), os.environ.get("PYTHONPATH", "")])}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    logs = [tempfile.NamedTemporaryFile("w+", suffix=f"-rank{r}.log",
                                        delete=False) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(world), str(port),
         *map(str, args)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, logs


def finish(procs, logs, timeout=300):
    """Wait for the ranks; fails with the logs when a rank fails or
    outlives ``timeout``.  Every rank is killed on the way out."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.flush()
        outs.append(Path(f.name).read_text())
        f.close()
        os.unlink(f.name)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


def step_batch(seed):
    """4 rows, 10 tokens; data rank 0's half holds far fewer label tokens
    than data rank 1's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 512, (4, 10))
    labels[:, :3] = -100
    labels[0, 4:] = -100
    labels[1, -3:] = -100
    return {"input_features":
            rng.standard_normal((4, 8, 32)).astype(np.float32),
            "decoder_input_ids":
            rng.integers(0, 512, (4, 10)).astype(np.int32),
            "labels": labels.astype(np.int32)}


def cli_paths(root):
    """Where :func:`_cli_data` puts the teacher and student checkpoints and
    the manifests."""
    return str(root / "teacher"), str(root / "student"), root / "data"


def _cli_data(root):
    """A teacher and student checkpoint and the manifests of the CLI run
    (as tests/test_torch_multiprocess.py makes them), then the ``ready``
    marker that the ranks wait for (``failed`` if making them raised): the
    fixtures make them beside the JAX references while the ranks run."""
    from distil_whisper_tpu_torch.audio.io import write_wav
    from distil_whisper_tpu_torch.cli import create_student_model
    teacher, student, data = cli_paths(root)
    data.mkdir()
    try:
        make_tiny_checkpoint(teacher, encoder_layers=2, decoder_layers=4)
        create_student_model.main(["--teacher_checkpoint", teacher,
                                   "--save_dir", student,
                                   "--decoder_layers", "2", "--device", "cpu"])
        rows = []
        for i, text in enumerate(TEXTS):
            secs = 1.5 + 0.5 * (i % 4)
            write_wav(str(data / f"{i}.wav"), tone(secs, 200 + 40 * i, i),
                      16000)
            rows.append({"audio": str(data / f"{i}.wav"), "text": text,
                         "whisper_transcript": "<|startoftranscript|><|en|>"
                         f"<|transcribe|><|notimestamps|> {text}"
                         "<|endoftext|>"})
        for name, sel in (("train", rows), ("eval", rows[:4])):
            (data / f"{name}.jsonl").write_text(
                "".join(json.dumps(r) + "\n" for r in sel))
    except BaseException:
        (data / "failed").touch()
        raise
    (data / "ready").touch()
    return teacher, student, data


def refs_beside_cli_data(root, references, *beside):
    """``references()`` (the JAX references, computed while the ranks run,
    a dict) updated with the dicts of ``beside`` (more references, each in
    a thread), with :func:`_cli_data` made in a thread beside them."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1 + len(beside)) as pool:
        cli = pool.submit(_cli_data, root)
        more = [pool.submit(fn) for fn in beside]
        ref = references()
        for f in more:
            ref.update(f.result())
        cli.result()
    return ref


def _jax_generations(m):
    """JAX's unsharded generations (greedy with timestamps, int8, draft
    speculation)."""
    from distil_whisper_tpu.generation import GenerationOptions as JOpts
    from distil_whisper_tpu.generation import encode_and_generate as j_gen
    from distil_whisper_tpu.generation.speculative import \
        speculative_generate
    from distil_whisper_tpu.models.whisper import cross_kv, encode
    from distil_whisper_tpu.ops.quant import maybe_quantize_encoder
    ref = {}
    prompt4 = jnp.full((4, 1), 3, jnp.int32)
    out = j_gen(m["inf"], JINF, jnp.asarray(m["mel_ts"]), prompt4,
                JOpts(max_new_tokens=12, return_timestamps=True,
                      max_initial_timestamp_index=50))
    ref["ts_sequences"] = np.asarray(out.sequences)
    ref["ts_sum_logprobs"] = np.asarray(out.sum_logprobs)
    qcfg = JINF.replace(quantize_encoder=True, quantize_decoder=True)
    out = j_gen(maybe_quantize_encoder(m["int8"], qcfg), qcfg,
                jnp.asarray(m["mel_int8"]), prompt4,
                JOpts(max_new_tokens=10))
    ref["int8_sequences"] = np.asarray(out.sequences)
    t, dr = m["spec_t"], m["spec_d"]
    dcfg = JINF.replace(decoder_layers=1)
    enc = encode(t["encoder"], JINF, jnp.asarray(m["mel_spec"]))
    out = speculative_generate(
        t["decoder"], JINF, dr["decoder"], dcfg,
        cross_kv(t["decoder"], JINF, enc), cross_kv(dr["decoder"], dcfg, enc),
        jnp.asarray([[3]], jnp.int32), JOpts(max_new_tokens=16), gamma=3)
    ref["spec_sequences"] = np.asarray(out.sequences)
    return ref


def _jax_steps(m):
    """JAX's (4, 2)-mesh steps, every case."""
    from distil_whisper_tpu.ops.quant import (quantize_decoder_params,
                                              quantize_encoder_params)
    ref = {}
    mesh = j_make_mesh((4, 2))
    s_axes = j_param_axes(m["scfg"])
    for name, (opt_kw, dcfg_kw, int8) in TP_STEP_CASES.items():
        teacher = m["teacher"]
        if int8:   # eager, as the port's
            teacher = {**teacher,
                       "encoder": quantize_encoder_params(teacher["encoder"]),
                       "decoder": quantize_decoder_params(teacher["decoder"])}
        teacher = jax.tree.map(
            lambda x: jax.device_put(x, j_replicated(mesh)), teacher)
        student = j_shard_params(m["student"], s_axes, mesh)
        opt = J.OptimizerConfig(**{**BASE_OPT, **opt_kw})
        tx = J.make_optimizer(opt, student)
        state, tx = J.TrainState.create(student, opt, tx)
        state = J.place_state(state, tx, mesh, j_shardings(s_axes, mesh))
        step, _ = J.build_train_step(m["scfg"], JCFG,
                                     J.DistillConfig(**dcfg_kw), opt, tx)
        step = jax.jit(step)
        trees, metrics = [], []
        for b in m["batches"]:
            state, mt = step(state, teacher,
                             j_shard_batch(jax.tree.map(jnp.asarray, b), mesh))
            metrics.append({k: float(v) for k, v in mt.items()})
            trees.append(j_tree_paths(to_numpy_tree(state.params)))
        ref[name] = (trees, metrics)
    return ref


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    m = {"inf": jax_init_params(JINF, 0), "int8": jax_init_params(JINF, 2),
         "spec_t": jax_init_params(JINF, 1)}
    m["spec_d"], _ = J.init_student_from_teacher(m["spec_t"], JINF,
                                                 decoder_layers=1)
    for name, seed, n in (("mel_ts", 0, 4), ("mel_int8", 2, 4),
                          ("mel_spec", 1, 1)):
        m[name] = np.random.default_rng(seed).standard_normal(
            (n, 80, 3000)).astype(np.float32)
    m["teacher"] = jax_init_params(JCFG, 0)
    student, m["scfg"] = J.init_student_from_teacher(m["teacher"], JCFG,
                                                     decoder_layers=2)
    m["student"] = jax.tree.map(jnp.asarray, to_numpy_tree(student))
    m["batches"] = [step_batch(s) for s in range(TP_STEPS)]
    arrays = {"inf_dims": json.dumps(INF_DIMS), "dims": json.dumps(DIMS),
              "student_layers": 2}
    for prefix in ("inf", "int8", "spec_t", "spec_d", "teacher", "student"):
        arrays.update({f"{prefix}/{p}": np.asarray(x) for p, x in
                       j_tree_paths(to_numpy_tree(m[prefix])).items()})
    for name in ("mel_ts", "mel_int8", "mel_spec"):
        arrays[name] = m[name]
    for i, b in enumerate(m["batches"]):
        arrays[f"split{i}"] = np.asarray([0, 2, 4])
        arrays.update({f"batch{i}/{k}": v for k, v in b.items()})
    m["audios"] = [tone(2.0 + j, 220.0 + 60 * j, 10 + j) for j in range(3)]
    arrays.update({f"audio{j}": a for j, a in enumerate(m["audios"])})
    np.savez(tmp / "inputs.npz", **arrays)
    teacher_ck, student_ck, data = cli_paths(tmp)
    ckpt, out = tmp / "ckpt", tmp / "out"
    out.mkdir()
    procs, logs = start("tp", tmp / "inputs.npz", ckpt, teacher_ck,
                        student_ck, data, out)
    try:
        m["ref"] = refs_beside_cli_data(tmp, lambda: _jax_steps(m),
                                        lambda: _jax_generations(m))
    finally:
        finish(procs, logs)
    m.update(out=out, ckpt=ckpt, teacher_ck=teacher_ck,
             student_ck=student_ck,
             res=[json.loads((out / f"tp-rank{r}.json").read_text())
                  for r in range(WORLD)],
             arrays=[np.load(out / f"tp-rank{r}.npz") for r in range(WORLD)])
    return m


def _data_rank_rows(tp_run, key):
    """The (2, 2) mesh's rows in data order: data rank d is ranks 2d and
    2d + 1, which must agree."""
    a = tp_run["arrays"]
    for d in range(2):
        np.testing.assert_array_equal(a[2 * d][key], a[2 * d + 1][key])
    return np.concatenate([a[0][key], a[2][key]])


def test_tp_generate_matches_jax_unsharded(tp_run):
    ref = tp_run["ref"]
    np.testing.assert_array_equal(_data_rank_rows(tp_run, "ts_sequences"),
                                  ref["ts_sequences"])
    np.testing.assert_allclose(_data_rank_rows(tp_run, "ts_sum_logprobs"),
                               ref["ts_sum_logprobs"], rtol=1e-4)


def test_tp_int8_generate_matches_jax_unsharded_int8(tp_run):
    np.testing.assert_array_equal(_data_rank_rows(tp_run, "int8_sequences"),
                                  tp_run["ref"]["int8_sequences"])
    assert all(r["int8_quantize_shards_equal"] for r in tp_run["res"])


def test_tp_speculative_matches_jax(tp_run):
    for a in tp_run["arrays"]:
        np.testing.assert_array_equal(a["spec_sequences"],
                                      tp_run["ref"]["spec_sequences"])


def test_tp_shard_gather_round_trip(tp_run):
    assert all(r["roundtrip_equal"] for r in tp_run["res"])


@pytest.mark.parametrize("name", list(TP_STEP_CASES))
def test_tp_step_matches_jax_sharded_step(tp_run, name):
    j_trees, j_metrics = tp_run["ref"][name]
    ranks = [np.load(tp_run["out"] / f"tp-{name}-rank{r}.npz")
             for r in range(WORLD)]
    init = {p: np.asarray(x, np.float32) for p, x in
            j_tree_paths(to_numpy_tree(tp_run["student"])).items()}
    for step in range(1, TP_STEPS + 1):
        for p in init:
            ours = ranks[0][f"step{step}/{p}"]
            for r in range(1, WORLD):
                np.testing.assert_array_equal(
                    ranks[r][f"step{step}/{p}"], ours,
                    err_msg=f"rank {r} differs at {p}")
            np.testing.assert_allclose(
                ours - init[p], np.asarray(j_trees[step - 1][p], np.float32)
                - init[p], atol=1e-5, rtol=0, err_msg=f"step {step}: {p}")
    metrics = [json.loads((tp_run["out"] / f"tp-{name}-rank{r}.json")
                          .read_text()) for r in range(WORLD)]
    assert all(m == metrics[0] for m in metrics)
    rtol, atol = ((1e-4, 1e-5) if TP_STEP_CASES[name][2]
                  else (1e-5, 1e-6))
    for jm, tm in zip(j_metrics, metrics[0]):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=atol,
                                       err_msg=k)
    if name == "clipped":
        assert metrics[0][0]["grad_norm"] > 1e-3   # the clip bites


def test_tp_dropout_step_equals_tp1(tp_run):
    """A step with the student's dropout on (encoder unfrozen) at (1, 4)
    equals the unsharded step under the same seed, on every rank; the
    masks change the step; the (2, 2) mesh's dropout generators are one
    a data rank."""
    for r in tp_run["res"]:
        assert r["dropout_tp4_vs_tp1"] < 1e-6
        assert r["dropout_effect"] > 1e-4
    draws = [r["generator_draws"] for r in tp_run["res"]]
    assert draws[0] == draws[1] and draws[2] == draws[3]
    assert draws[0] != draws[2]


def test_tp_checkpoint_resumes_at_tp1(tp_run):
    """checkpoint-1 of the tp 2 run, restored into a one-process state,
    takes step 2 to the tp run's parameters."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.training import (
        CheckpointManager, DistillConfig, OptimizerConfig, TrainState,
        build_train_step)
    from torch_port_helpers import torch_params
    cfg = WhisperConfig(**DIMS)
    scfg = cfg.replace(decoder_layers=2)
    opt = OptimizerConfig(**{**BASE_OPT, **TP_STEP_CASES["plain"][0]})
    state = TrainState.create(torch_params(tp_run["student"]), opt)
    state = CheckpointManager(str(tp_run["ckpt"])).restore(
        str(tp_run["ckpt"] / "checkpoint-1"), state)
    tp_steps = np.load(tp_run["out"] / "tp-plain-rank0.npz")
    for p, x in tree_paths(state.params).items():
        np.testing.assert_array_equal(x.detach().numpy(),
                                      tp_steps[f"step1/{p}"], err_msg=p)
    step, _ = build_train_step(scfg, cfg, DistillConfig(), opt)
    batch = {k: torch.from_numpy(v) for k, v in tp_run["batches"][1].items()}
    state, _ = step(state, torch_params(tp_run["teacher"]), batch)
    for p, x in tree_paths(state.params).items():
        np.testing.assert_allclose(x.detach().numpy(), tp_steps[f"step2/{p}"],
                                   atol=1e-6, rtol=0, err_msg=p)


def test_tp_pipeline_texts_equal_one_process(tp_run):
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    pipe = WhisperPipeline(tp_run["teacher_ck"], dtype=torch.float32,
                           device="cpu")
    texts = [r["text"] for r in pipe(tp_run["audios"], language="en",
                                     max_new_tokens=8)]
    words = pipe(tp_run["audios"][0], language="en", max_new_tokens=8,
                 return_timestamps="word")
    words = [[c["text"], list(c["timestamp"])] for c in words["chunks"]]
    for r in tp_run["res"]:
        assert r["pipeline"] == texts
        assert r["pipeline_words"] == words


def _pad_cat(parts):
    """The data ranks' batches, the label axis padded to the longest."""
    s = max(p["labels"].shape[1] for p in parts)
    fill = {"labels": -100, "decoder_input_ids": 50257,
            "decoder_attention_mask": 0}
    out = {}
    for k in parts[0]:
        if k == "input_features":
            out[k] = np.concatenate([p[k] for p in parts])
            continue
        out[k] = np.concatenate([np.pad(
            p[k], ((0, 0), (0, s - p[k].shape[1])),
            constant_values=fill[k]) for p in parts])
    return out


def test_tp_run_distillation_equals_replay(tp_run):
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step)
    out = tp_run["out"]
    metrics = [json.loads(line) for line in (out / "tp-distill"
                                             / "metrics.jsonl")
               .read_text().splitlines()]
    train = [m for m in metrics if "train/loss" in m]
    assert [m["step"] for m in train] == [1, 2]
    assert [m for m in metrics if "eval/wer" in m]
    teacher, tcfg = load_params(tp_run["teacher_ck"], device="cpu")
    student, scfg = load_params(tp_run["student_ck"], device="cpu")
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2,
                          schedule="constant_with_warmup", precision="full",
                          frozen_prefixes=("encoder",))
    state = TrainState.create(student, opt)
    step, _ = build_train_step(scfg, tcfg, DistillConfig(), opt)
    for i, m in enumerate(train):
        parts = [dict(np.load(out / f"tp-batch-rank{r}-step{i}.npz"))
                 for r in range(WORLD)]
        for d in range(2):   # the model ranks of a data group: one batch
            for k in parts[2 * d]:
                np.testing.assert_array_equal(parts[2 * d][k],
                                              parts[2 * d + 1][k])
        batch = {k: torch.from_numpy(v)
                 for k, v in _pad_cat(parts[::2]).items()}
        assert m["train/label_tokens"] == int((batch["labels"] != -100).sum())
        state, ref = step(state, teacher, batch)
        for k, v in ref.items():
            np.testing.assert_allclose(m[f"train/{k}"], float(v), rtol=1e-4,
                                       err_msg=f"step {i + 1}: {k}")
    assert Path(tp_run["res"][0]["cli_ckpt"]).name == "checkpoint-2"


def test_dryrun_multigpu_tensor_parallel():
    from distil_whisper_tpu_torch.parallel.dryrun import (PARAM_TOL,
                                                          dryrun_multigpu)
    report = dryrun_multigpu(4, model_parallel=2, device="cpu", timeout=240)
    assert report["world"] == 4 and report["model_parallel"] == 2
    for k in ("grad_err", "param_err", "loss_rel_err"):
        assert report[k] <= PARAM_TOL, (k, report[k])
    assert report["generate_tokens_equal"]
    labels = [r["label_tokens"] for r in report["ranks"]]
    assert labels[0] == labels[1] != labels[2] == labels[3]


# -- plain unit tests: no process group ----------------------------------

class FakeMesh:
    """Rank (0, index) of a (1, tp) mesh: enough for the slicing rules,
    which issue no collective."""
    mesh_dim_names = ("data", "model")

    def __init__(self, tp, index):
        self.tp, self.index = tp, index

    def size(self, dim):
        return (1, self.tp)[dim]

    def get_coordinate(self):
        return [0, self.index]

    def get_group(self, name):
        return object()


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_shards_concatenate_to_the_tree(int8):
    """The model ranks' shards of every leaf, concatenated along its
    model dimension, give the tree back (a replicated leaf is the tree's
    own); int8 kernels are output-major in every shard, and a row-parallel
    shard keeps its whole kernel_scale."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.ops.quant import (maybe_quantize_encoder,
                                                    output_major)
    from distil_whisper_tpu_torch.parallel.mesh import (model_dim,
                                                        shard_params)
    cfg = WhisperConfig(**INF_DIMS)
    full = init_params(cfg, seed=0, device="cpu")
    if int8:
        cfg = cfg.replace(quantize_encoder=True, quantize_decoder=True,
                          quantize_lm_head=True)
        full = maybe_quantize_encoder(full, cfg)
    shards = [tree_paths(shard_params(full, FakeMesh(4, i), cfg=cfg))
              for i in range(4)]
    for p, x in tree_paths(full).items():
        dim = model_dim(p)
        if dim is None:
            assert all(s[p] is x for s in shards), p
            continue
        assert torch.equal(torch.cat([s[p] for s in shards], dim), x), p
        if p.endswith("kernel_q"):
            for s in shards:
                assert s[p].stride() == output_major(s[p]).stride(), p
    if int8:
        out = "decoder.layers.self_attn.out.kernel_scale"
        assert model_dim(out) is None and shards[1][out] is \
            tree_paths(full)[out]


def test_degree_errors():
    """A model axis that divides no head count, or splits an int8 MLP
    chunk, raises ValueError naming the shape."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.ops.quant import maybe_quantize_encoder
    from distil_whisper_tpu_torch.parallel.mesh import shard_params
    cfg = WhisperConfig(**INF_DIMS)
    full = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder_attention_heads = 4"):
        shard_params(full, FakeMesh(8, 0), cfg=cfg)
    with pytest.raises(ValueError, match=r"shape \(2, 64, 64\)"):
        shard_params(full, FakeMesh(3, 0))
    wide = cfg.replace(encoder_ffn_dim=1024, decoder_ffn_dim=1024,
                       quantize_encoder=True)
    q = maybe_quantize_encoder(init_params(wide, seed=0, device="cpu"), wide)
    shard_params(q, FakeMesh(2, 0), cfg=wide)   # 512-column shards: whole
    with pytest.raises(ValueError, match="splits the int8 MLP"):
        shard_params(q, FakeMesh(4, 0), cfg=wide)


def test_save_pretrained_refuses_a_sharded_tree(tmp_path):
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import init_params, save_pretrained
    from distil_whisper_tpu_torch.parallel.mesh import shard_params
    cfg = WhisperConfig(**INF_DIMS)
    shard = shard_params(init_params(cfg, seed=0, device="cpu"),
                         FakeMesh(2, 0), cfg=cfg)
    with pytest.raises(ValueError, match="gather_params"):
        save_pretrained(shard, cfg, str(tmp_path / "out"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_parallel_partial_product(dtype):
    """The fp32 partial of a row-parallel product is the product before
    its one rounding, and its gradients are torch.matmul's in the
    operands' dtype."""
    from distil_whisper_tpu_torch.parallel.tensor_parallel import \
        _Fp32Product
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(2, 5, 16, generator=g).to(dtype)
    w0 = torch.randn(16, 8, generator=g).to(dtype)
    up = torch.randn(2, 5, 8, generator=g).to(dtype)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = _Fp32Product.apply(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x0.double() @ w0.double(),
                               check_dtype=False, rtol=1e-6, atol=1e-6)
    y.backward(up.float())
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    torch.matmul(xr, wr).backward(up)
    assert x.grad.dtype == w.grad.dtype == dtype
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=0)
    torch.testing.assert_close(w.grad, wr.grad, rtol=0, atol=0)


def test_fused_int8_mlp_plain_partial_sums_to_unsharded():
    """The partial mode over the ffn shards, summed in fp32 plus the bias
    once, equals the unsharded plain version (1e-5: only the order of the
    chunk sums differs)."""
    from distil_whisper_tpu_torch.ops.int8_mlp import fused_int8_mlp_plain
    from distil_whisper_tpu_torch.ops.quant import quantize_dense
    from distil_whisper_tpu_torch.parallel.mesh import shard_leaf
    g = torch.Generator().manual_seed(0)
    d, f = 128, 1024

    def rand(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std
    fc1 = quantize_dense({"kernel": rand(d, f, std=0.03),
                          "bias": rand(f, std=0.01)})
    fc2 = quantize_dense({"kernel": rand(f, d, std=0.03),
                          "bias": rand(d, std=0.01)})
    x = rand(300, d)
    full = fused_int8_mlp_plain(fc1, fc2, x)
    acc = 0.0
    for i in range(2):
        mesh = FakeMesh(2, i)

        def part(name, p):
            # the leaves of one layer of a stacked [L, ...] tree
            return {k: shard_leaf(f"decoder.layers.{name}.{k}", v[None],
                                  mesh)[0] for k, v in p.items()}
        y = fused_int8_mlp_plain(part("fc1", fc1), part("fc2", fc2), x,
                                 partial=True)
        assert y.dtype == torch.float32
        acc = acc + y
    torch.testing.assert_close(acc + fc2["bias"], full, rtol=1e-5, atol=1e-5)


def test_near_tie_report_finds_the_first_parting():
    """The report names the first differing generated position of each
    parting row and the reference's top-two logit gap there, from a
    teacher-forced pass; equal rows are not reported."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                     generate)
    from chip_smoke import (cached_step_logits, near_tie_report,
                            teacher_forced_logits)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.models.whisper import cross_kv, decode, encode
    cfg = WhisperConfig(**INF_DIMS)
    params = init_params(cfg, seed=0, device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 80, 3000)).astype(np.float32))
    cross = cross_kv(params["decoder"], cfg, encode(params["encoder"], cfg,
                                                    mel))
    out = generate(params["decoder"], cfg, cross, torch.full((2, 1), 3),
                   GenerationOptions(max_new_tokens=6))
    ref = [out.sequences[b, :int(out.seq_len[b])].tolist() for b in range(2)]
    test = [list(ref[0]), list(ref[1])]
    test[1][4] = (test[1][4] + 1) % cfg.vocab_size
    rep = near_tie_report(params["decoder"], cfg, cross, ref, test, 1)
    assert rep["parting"] == 1 and rep["rows"] == 2
    (row,) = rep["partings"]
    assert (row["row"], row["position"], row["ref_token"]) == (1, 4, ref[1][4])
    logits, _ = decode(params["decoder"], cfg, torch.tensor([ref[1][:4]]),
                       cross={k: v[:, 1:] for k, v in cross.items()})
    top = torch.topk(logits[0, 3], 2).values
    assert row["top2_gap"] == pytest.approx(float(top[0] - top[1]))
    assert row["near_tie"] == (row["top2_gap"] < 5e-3)
    # the yardstick beside it: the reference's cached single-token step
    # lies within fp32 rounding of its teacher-forced pass; the decode under
    # test (here the same model) lies at no distance and reproduces the
    # reference's choice there
    rep = near_tie_report(
        params["decoder"], cfg, cross, ref, test, 1,
        drift_logits=cached_step_logits(params["decoder"], cfg, cross),
        test_logits=teacher_forced_logits(params["decoder"], cfg, cross))
    (row,) = rep["partings"]
    assert row["logit_drift"] < 1e-4
    assert row["test_drift"] < 1e-5 and row["test_top2_gap"] > 0
    assert rep["all_within_drift"] == (row["top2_gap"] <= row["logit_drift"])
