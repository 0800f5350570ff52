"""2-D (FSDP-style) parameter sharding over the mesh's 'data' axis on the
CPU, against the JAX package.

One job of four gloo ranks (tests/torch_mp_worker.py, mode ``fsdp``) runs
on a (2, 2) mesh under ``RULES_2D``:

- the placement: each rank's shards of the parameters, the AdamW moments
  and the accumulated gradient after one micro-step equal the slices of
  JAX's ``RULES_2D`` placement on a (2, 2) mesh of four virtual devices
  (the accumulated gradient within 1e-5 of JAX's); gather after shard
  gives the tree bit for bit, int8 trees included; the model reads the
  tensor-parallel degree 2 where the q kernel's shape ratio reads 1;
- the steps: a distillation step with the encoder unfrozen and a
  fine-tuning step, both with gradient accumulation 2 and clipping, four
  micro-steps: the gathered parameters and moments and the loss and grad
  norm equal JAX's step under ``RULES_2D`` at 1e-5 (fp32) and the port's
  1-D step on the same mesh at 1e-6; an int8-teacher step and a QAT step
  are finite and equal the 1-D step at 1e-5;
- checkpoints: one written under 2-D resumes at 1-D and in one process,
  one written at 1-D resumes under 2-D, each continuing as the
  uninterrupted run;
- ``run_distillation`` and ``run_finetuning --distributed --model_parallel
  2 --param_sharding 2d``: their losses equal a one-process replay of the
  data ranks' batches.

The JAX references are computed while the ranks run, and the CLIs'
checkpoints and manifests beside them.  The dry run's 2-D parts run in a
job of their own.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from torch_port_helpers import to_numpy_tree, torch_params
from distil_whisper_tpu import training as J
from distil_whisper_tpu.models import param_axes as j_param_axes
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu.parallel import RULES_2D as J_RULES_2D
from distil_whisper_tpu.parallel import make_mesh as j_make_mesh
from distil_whisper_tpu.parallel import replicated as j_replicated
from distil_whisper_tpu.parallel import shard_batch as j_shard_batch
from distil_whisper_tpu.parallel import shard_params as j_shard_params
from distil_whisper_tpu.parallel import shardings_for_tree as j_shardings

HERE = Path(__file__).parent
sys.path.insert(0, str(HERE))
from test_torch_tensor_parallel import (DIMS, JCFG,  # noqa: E402
                                        _pad_cat, cli_paths, finish,
                                        refs_beside_cli_data, start,
                                        step_batch)
from torch_mp_worker import (BASE_OPT, FSDP_CASES, FSDP_MICRO,  # noqa: E402
                             FSDP_TRAIN)

WORLD = 4
# the cases held against JAX (the others against the 1-D step)
JAX_CASES = ("distill", "finetune")


def _adam(opt_state):
    """The ScaleByAdamState inside an optax state (any wrapper nesting)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for x in opt_state:
            found = _adam(x)
            if found is not None:
                return found
    return None


def _jax_references(m, mesh):
    """JAX's RULES_2D steps on the (2, 2) mesh: parameters and moments
    after every micro-step, the metrics, and the state after the first
    micro-step of the distillation case (the placement reference)."""
    s_axes = j_param_axes(m["scfg"])
    ref = {}
    for name in JAX_CASES:
        opt_kw, dcfg_kw, _, finetune = FSDP_CASES[name]
        teacher = jax.tree.map(
            lambda x: jax.device_put(x, j_replicated(mesh)), m["teacher"])
        student = j_shard_params(m["student"], s_axes, mesh, J_RULES_2D)
        opt = J.OptimizerConfig(**{**BASE_OPT, **opt_kw})
        tx = J.make_optimizer(opt, student)
        state, tx = J.TrainState.create(student, opt, tx)
        state = J.place_state(state, tx, mesh,
                              j_shardings(s_axes, mesh, J_RULES_2D))
        if finetune:
            step, _ = J.build_finetune_step(m["scfg"], opt, tx)
            step = jax.jit(step)
        else:
            raw, _ = J.build_train_step(m["scfg"], JCFG,
                                        J.DistillConfig(**dcfg_kw), opt, tx)
            step = jax.jit(lambda s, b, raw=raw: raw(s, teacher, b))
        trees, metrics = [], []
        for i in range(FSDP_MICRO[name]):
            b = j_shard_batch(jax.tree.map(jnp.asarray, m["batches"][i]),
                              mesh)
            state, mt = step(state, b)
            metrics.append({k: float(v) for k, v in mt.items()})
            adam = _adam(state.opt_state)
            trees.append({part: j_tree_paths(to_numpy_tree(tree))
                          for part, tree in (("params", state.params),
                                             ("mu", adam.mu),
                                             ("nu", adam.nu))})
            if name == "distill" and i == 0:
                ref["placed"] = state
        ref[name] = (trees, metrics)
    return ref


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    from torch_port_helpers import jax_init_params
    m = {"teacher": jax_init_params(JCFG, 0)}
    student, m["scfg"] = J.init_student_from_teacher(m["teacher"], JCFG,
                                                     decoder_layers=2)
    m["student"] = jax.tree.map(jnp.asarray, to_numpy_tree(student))
    m["batches"] = [step_batch(10 + s) for s in range(max(FSDP_MICRO.values()))]
    arrays = {"dims": json.dumps(DIMS), "student_layers": 2}
    for prefix in ("teacher", "student"):
        arrays.update({f"{prefix}/{p}": np.asarray(x) for p, x in
                       j_tree_paths(to_numpy_tree(m[prefix])).items()})
    for i, b in enumerate(m["batches"]):
        arrays[f"split{i}"] = np.asarray([0, 2, 4])
        arrays.update({f"batch{i}/{k}": v for k, v in b.items()})
    np.savez(tmp / "inputs.npz", **arrays)
    teacher_ck, student_ck, data = cli_paths(tmp)
    ckpt, out = tmp / "ckpt", tmp / "out"
    out.mkdir()
    procs, logs = start("fsdp", tmp / "inputs.npz", ckpt, teacher_ck,
                        student_ck, data, out)
    try:
        m["mesh"] = j_make_mesh((2, 2), devices=jax.devices()[:4])
        m["ref"] = refs_beside_cli_data(
            tmp, lambda: _jax_references(m, m["mesh"]))
    finally:
        finish(procs, logs)
    m.update(out=out, ckpt=ckpt, teacher_ck=teacher_ck,
             student_ck=student_ck,
             res=[json.loads((out / f"fsdp-rank{r}.json").read_text())
                  for r in range(WORLD)],
             arrays=[np.load(out / f"fsdp-rank{r}.npz") for r in range(WORLD)])
    return m


def _load(fsdp_run, stem):
    return [np.load(fsdp_run["out"] / f"{stem}-rank{r}.npz")
            for r in range(WORLD)]


def _metrics(fsdp_run, stem):
    return [json.loads((fsdp_run["out"] / f"{stem}-rank{r}.json").read_text())
            for r in range(WORLD)]


def _same_on_every_rank(ranks):
    for r in range(1, WORLD):
        for k in ranks[0].files:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=f"rank {r}: {k}")
    return ranks[0]


def test_2d_placement_matches_jax(fsdp_run):
    """Rank (d, m) of the (2, 2) mesh holds, of every parameter, AdamW
    moment and accumulated-gradient leaf, the slice JAX's RULES_2D
    placement gives device (d, m) (fc1's moments are (None, data, model)
    in JAX); the parameters and moments (zeros after one micro-step of two)
    bit for bit, the accumulated gradient within 1e-5 of JAX's."""
    from jax.sharding import PartitionSpec as P
    placed = fsdp_run["ref"]["placed"]
    mesh = fsdp_run["mesh"]
    adam = _adam(placed.opt_state)
    assert adam.mu["decoder"]["layers"]["fc1"]["kernel"].sharding.spec == \
        P(None, "data", "model")
    trees = {"params": placed.params, "mu": adam.mu, "nu": adam.nu,
             "acc": placed.opt_state.acc_grads}
    for r in range(WORLD):
        d, mm = divmod(r, 2)
        device = mesh.devices[d, mm]
        ours = fsdp_run["arrays"][r]
        for part, tree in trees.items():
            flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
            for path, leaf in flat.items():
                p = ".".join(k.key for k in path)
                idx = leaf.sharding.devices_indices_map(leaf.shape)[device]
                want = np.asarray(leaf)[idx]
                if f"place/{part}/{p}" not in ours:
                    # a leaf the loss does not reach has no running mean
                    assert part == "acc" and not want.any(), (part, p)
                    continue
                got = ours[f"place/{part}/{p}"]
                assert got.shape == want.shape, (r, part, p)
                if part == "acc":
                    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                               err_msg=f"rank {r}: {p}")
                else:
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"rank {r}: {p}")


def test_2d_shard_gather_round_trip(fsdp_run):
    """Gather after shard gives the tree back bit for bit, float and int8
    (int8 kernels output-major again, strides included)."""
    for r in fsdp_run["res"]:
        assert r["roundtrip_equal"] and r["int8_roundtrip_equal"]


def test_2d_model_reads_the_tp_degree(fsdp_run):
    """At (2, 2) under 2-D a q kernel is [L, d/2, d/2]: its shape ratio
    reads 1, the model reads tp 2 (and dp 2) from d_model."""
    for r in fsdp_run["res"]:
        assert r["degrees"] == [2, 2, 1]


@pytest.mark.parametrize("name", JAX_CASES)
def test_2d_step_matches_jax_2d_step(fsdp_run, name):
    """The gathered parameters and moments after every micro-step equal
    JAX's RULES_2D step at 1e-5 (parameters as deltas from the start), and
    the metrics at 1e-5 relative."""
    j_trees, j_metrics = fsdp_run["ref"][name]
    ours = _same_on_every_rank(_load(fsdp_run, f"fsdp-{name}-2d"))
    init = {p: np.asarray(x, np.float32) for p, x in
            j_tree_paths(to_numpy_tree(fsdp_run["student"])).items()}
    for i in range(FSDP_MICRO[name]):
        for part in ("params", "mu", "nu"):
            for p, want in j_trees[i][part].items():
                got = ours[f"step{i + 1}/{part}/{p}"]
                base = init[p] if part == "params" else 0.0
                np.testing.assert_allclose(
                    got - base, np.asarray(want, np.float32) - base,
                    atol=1e-5, rtol=0, err_msg=f"micro-step {i + 1}: {part} {p}")
    metrics = _metrics(fsdp_run, f"fsdp-{name}-2d")
    assert all(mt == metrics[0] for mt in metrics)
    for jm, tm in zip(j_metrics, metrics[0]):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    if "grad_norm" in metrics[0][0]:
        assert max(mt["grad_norm"] for mt in metrics[0]) > \
            FSDP_TRAIN["max_grad_norm"]          # the clip bites


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_2d_step_equals_1d_step(fsdp_run, name):
    """The 2-D step equals the port's 1-D step on the same mesh: 1e-6 for
    the float cases, 1e-5 for the int8-teacher and QAT steps, whose
    losses are finite."""
    tol = 1e-5 if name in ("int8_teacher", "qat") else 1e-6
    two = _same_on_every_rank(_load(fsdp_run, f"fsdp-{name}-2d"))
    one = _same_on_every_rank(_load(fsdp_run, f"fsdp-{name}-1d"))
    assert sorted(two.files) == sorted(one.files)
    for k in one.files:
        np.testing.assert_allclose(two[k], one[k], atol=tol, rtol=0,
                                   err_msg=k)
    m2 = _metrics(fsdp_run, f"fsdp-{name}-2d")[0]
    m1 = _metrics(fsdp_run, f"fsdp-{name}-1d")[0]
    for a, b in zip(m2, m1):
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.isfinite(a[k]), k
            np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                       err_msg=k)


def test_2d_checkpoint_resumes_at_1d_and_back(fsdp_run):
    """checkpoint-2 of the 2-D distillation run, resumed under the 1-D
    rules, and of the 1-D run, resumed under 2-D, each take micro-steps 3
    and 4 to the uninterrupted run's state (1e-6)."""
    for tag, src in (("2d_at_1d", "2d"), ("1d_at_2d", "1d")):
        resumed = _same_on_every_rank(_load(fsdp_run, f"fsdp-resume-{tag}"))
        whole = _same_on_every_rank(_load(fsdp_run, f"fsdp-distill-{src}"))
        for k in resumed.files:
            np.testing.assert_allclose(resumed[k], whole[k], atol=1e-6,
                                       rtol=0, err_msg=f"{tag}: {k}")


def test_2d_checkpoint_resumes_in_one_process(fsdp_run):
    """checkpoint-2 of the 2-D run, restored into a one-process state,
    takes micro-steps 3 and 4 on the global batches to the 2-D run's
    parameters."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models.params import tree_paths
    from distil_whisper_tpu_torch.training import (
        CheckpointManager, DistillConfig, OptimizerConfig, TrainState,
        build_train_step)
    cfg = WhisperConfig(**DIMS)
    scfg = cfg.replace(decoder_layers=2)
    opt_kw, dcfg_kw, _, _ = FSDP_CASES["distill"]
    opt = OptimizerConfig(**{**BASE_OPT, **opt_kw})
    state = TrainState.create(torch_params(fsdp_run["student"]), opt)
    ck = fsdp_run["ckpt"] / "2d"
    state = CheckpointManager(str(ck)).restore(str(ck / "checkpoint-2"),
                                               state)
    whole = np.load(fsdp_run["out"] / "fsdp-distill-2d-rank0.npz")
    for p, x in tree_paths(state.params).items():
        np.testing.assert_array_equal(x.detach().numpy(),
                                      whole[f"step2/params/{p}"], err_msg=p)
    step, _ = build_train_step(scfg, cfg, DistillConfig(**dcfg_kw), opt)
    teacher = torch_params(fsdp_run["teacher"])
    for i in (2, 3):
        batch = {k: torch.from_numpy(v)
                 for k, v in fsdp_run["batches"][i].items()}
        state, _ = step(state, teacher, batch)
    for p, x in tree_paths(state.params).items():
        np.testing.assert_allclose(x.detach().numpy(),
                                   whole[f"step4/params/{p}"], atol=1e-6,
                                   rtol=0, err_msg=p)


def _train_lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if "train/loss" in json.loads(line)]


def _replayed_batches(out, stem, step):
    parts = [dict(np.load(out / f"{stem}-rank{r}-step{step}.npz"))
             for r in range(WORLD)]
    for d in range(2):   # the model ranks of a data group: one batch
        for k in parts[2 * d]:
            np.testing.assert_array_equal(parts[2 * d][k],
                                          parts[2 * d + 1][k])
    return {k: torch.from_numpy(v) for k, v in _pad_cat(parts[::2]).items()}


def test_2d_run_distillation_equals_replay(fsdp_run):
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        DistillConfig, OptimizerConfig, TrainState, build_train_step)
    out = fsdp_run["out"]
    train = _train_lines(out / "fsdp-distill" / "metrics.jsonl")
    assert [m["step"] for m in train] == [1, 2]
    teacher, tcfg = load_params(fsdp_run["teacher_ck"], device="cpu")
    student, scfg = load_params(fsdp_run["student_ck"], device="cpu")
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2,
                          schedule="constant_with_warmup", precision="full",
                          frozen_prefixes=("encoder",))
    state = TrainState.create(student, opt)
    step, _ = build_train_step(scfg, tcfg, DistillConfig(), opt)
    for i, m in enumerate(train):
        batch = _replayed_batches(out, "fsdp-batch", i)
        state, ref = step(state, teacher, batch)
        for k, v in ref.items():
            np.testing.assert_allclose(m[f"train/{k}"], float(v), rtol=1e-4,
                                       err_msg=f"step {i + 1}: {k}")
    assert Path(fsdp_run["res"][0]["cli_ckpt"]).name == "checkpoint-2"


def test_2d_run_finetuning_equals_replay(fsdp_run):
    from distil_whisper_tpu_torch.models import load_params
    from distil_whisper_tpu_torch.training import (
        OptimizerConfig, TrainState, build_finetune_step)
    out = fsdp_run["out"]
    train = _train_lines(out / "fsdp-finetune" / "metrics.jsonl")
    assert [m["step"] for m in train] == [1, 2]
    params, cfg = load_params(fsdp_run["student_ck"], device="cpu")
    opt = OptimizerConfig(learning_rate=1e-4, warmup_steps=0, total_steps=2,
                          precision="full")
    state = TrainState.create(params, opt)
    step, _ = build_finetune_step(cfg, opt)
    for i, m in enumerate(train):
        state, ref = step(state, _replayed_batches(out, "fsdp-ft-batch", i))
        np.testing.assert_allclose(m["train/loss"], float(ref["loss"]),
                                   rtol=1e-4, err_msg=f"step {i + 1}")
    assert Path(fsdp_run["res"][0]["ft_ckpt"]).name == "checkpoint-2"


def test_dryrun_multigpu_2d():
    """The dry run's 2-D parts on four gloo ranks: the RULES_2D step, the
    int8-teacher and QAT steps against one process, generation on 2-D
    parameters, and the continuous engine with a draft and a timestamped
    request (no timestamp fallback) equal to one process's texts."""
    from distil_whisper_tpu_torch.parallel.dryrun import (PARAM_TOL,
                                                          dryrun_multigpu)
    report = dryrun_multigpu(4, model_parallel=2, param_sharding="2d",
                             device="cpu", timeout=300)
    assert report["param_sharding"] == "2d"
    for k in ("grad_err", "param_err", "loss_rel_err", "int8_teacher_err",
              "qat_err"):
        assert report[k] <= PARAM_TOL, (k, report[k])
    assert report["generate_tokens_equal"]
    assert report["engine_texts_equal"] and report["engine_ts_fallback"] == 0


def test_shard_params_2d_checks_the_data_axis():
    """A data axis that divides no d_model raises ValueError naming it
    (the slicing rules alone, on a fake (3, 1) mesh)."""
    from distil_whisper_tpu_torch.config import WhisperConfig
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.parallel import mesh as t_mesh

    class Fake:
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return (3, 1)[dim]

        def get_coordinate(self):
            return [1, 0]

        def get_group(self, name):
            return object()

    cfg = WhisperConfig(**DIMS)
    tree = init_params(cfg, seed=0, device="cpu")
    orig = t_mesh.replicate_over_data
    t_mesh.replicate_over_data = lambda tree, mesh=None, rules=None: tree
    try:
        with pytest.raises(ValueError, match="d_model = 32"):
            t_mesh.shard_params(tree, Fake(), t_mesh.RULES_2D, cfg=cfg)
    finally:
        t_mesh.replicate_over_data = orig
