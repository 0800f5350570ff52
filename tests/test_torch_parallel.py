"""The port's ``parallel`` package in one process against the JAX package's:
the rule tables, the logical axes and their specs, the per-rank slice and
shard rules, ``--distributed`` failing fast without a job, the helpers'
single-process identities, the per-rank manifests' reading order, the
placements the next slice brings raising, and the kernel wrappers' device
guard."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (two torch threads, TF32 off)
from distil_whisper_tpu.config import PRESETS as J_PRESETS
from distil_whisper_tpu.models import param_axes as j_param_axes
from distil_whisper_tpu.models.params import tree_paths as j_tree_paths
from distil_whisper_tpu.parallel import mesh as j_mesh
from distil_whisper_tpu.parallel import multihost as j_multihost
from distil_whisper_tpu_torch.cli.common import (load_dataset_any,
                                                 pl_manifests, shard_rows)
from distil_whisper_tpu_torch.config import PRESETS
from distil_whisper_tpu_torch.models import param_axes
from distil_whisper_tpu_torch.models.params import tree_paths
from distil_whisper_tpu_torch.parallel import mesh as t_mesh
from distil_whisper_tpu_torch.parallel import multihost as t_multihost

ROOT = Path(__file__).resolve().parents[1]


def test_rule_tables_equal_jax():
    assert t_mesh.DEFAULT_RULES == j_mesh.DEFAULT_RULES
    assert t_mesh.RULES_2D == j_mesh.RULES_2D


@pytest.mark.parametrize("preset", ["test-tiny", "distil-large-v3"])
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "RULES_2D"])
def test_specs_equal_jax_for_every_leaf(preset, rules):
    """The port's logical axes are JAX's, leaf for leaf, and each leaf's
    spec equals JAX's PartitionSpec entries under both rule tables."""
    ours = tree_paths(param_axes(PRESETS[preset]))
    theirs = j_tree_paths(j_param_axes(J_PRESETS[preset]))
    assert ours == theirs
    t_rules, j_rules = getattr(t_mesh, rules), getattr(j_mesh, rules)
    for path, axes in ours.items():
        assert t_mesh.spec_for_axes(axes, t_rules) == tuple(
            j_mesh.spec_for_axes(axes, j_rules)), path
    specs = tree_paths(t_mesh.shardings_for_tree(
        param_axes(PRESETS[preset]), None, t_rules))
    assert specs == {p: t_mesh.spec_for_axes(a, t_rules)
                     for p, a in ours.items()}


def test_param_axes_cover_init_params():
    from distil_whisper_tpu_torch.models import init_params
    cfg = PRESETS["test-tiny"]
    params = tree_paths(init_params(cfg, seed=0, device="cpu"))
    axes = tree_paths(param_axes(cfg))
    assert sorted(params) == sorted(axes)
    for p, x in params.items():
        assert x.ndim == len(axes[p]), p


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_slices_and_shards_follow_jax(world, monkeypatch):
    """``process_local_slice`` equals JAX's for 0-13 items on every rank;
    ``shard_rows`` of a row list equals ``datasets.Dataset.shard(
    contiguous=True)``, the rule JAX's drivers shard by."""
    import datasets
    for rank in range(world):
        monkeypatch.setattr(t_multihost, "world_size", lambda: world)
        monkeypatch.setattr(t_multihost, "rank", lambda: rank)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        for n in range(14):
            assert (t_multihost.process_local_slice(n)
                    == j_multihost.process_local_slice(n)), (n, rank)
            rows = [{"i": i} for i in range(n)]
            ours = [r["i"] for r in shard_rows(rows, world, rank)]
            try:
                theirs = list(datasets.Dataset.from_list(rows).shard(
                    num_shards=world, index=rank, contiguous=True)["i"]
                    ) if n else []
            except IndexError:
                # datasets refuses an empty shard of a non-empty set; the
                # port hands back no rows
                theirs = []
            assert ours == theirs, (n, rank)


def test_distributed_flag_fails_fast_without_a_job():
    """``--distributed`` (force) with no torchrun environment RAISES, as
    JAX's ``maybe_initialize_distributed(force=True)``; without force it
    stays a single process."""
    code = (
        "from distil_whisper_tpu_torch.parallel.multihost import "
        "maybe_initialize_distributed as init\n"
        "assert init() is False\n"
        "try:\n"
        "    init(force=True, device='cpu')\n"
        "    print('NO_ERROR')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED_AS_EXPECTED', e)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert "RAISED_AS_EXPECTED" in out.stdout, (out.stdout, out.stderr[-2000:])
    assert "torchrun" in out.stdout
    # a world size of 1 is no job either
    env.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT="29999")
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert "world size 1" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_single_process_helpers_are_identities():
    x = np.arange(6).reshape(3, 2)
    assert t_multihost.world_size() == 1 and t_multihost.rank() == 0
    np.testing.assert_array_equal(t_multihost.gather_rows(x), x)
    np.testing.assert_array_equal(t_multihost.sum_over_ranks(x), x)
    assert t_multihost.any_over_ranks(True) is True
    assert t_multihost.any_over_ranks(False) is False
    batch = {"labels": x}
    assert t_multihost.host_local_batch_to_global(batch) is batch
    np.testing.assert_array_equal(t_multihost.global_row_positions(None, 3),
                                  [0, 1, 2])
    assert t_multihost.process_local_slice(5) == slice(0, 5)
    # no mesh: the placements leave the tree as it is
    tree = {"a": torch.ones(2)}
    assert t_mesh.shard_params(tree, None) is tree
    assert t_mesh.data_group(None) is None
    assert t_mesh.data_sharding(None, 3) == ("data", None, None)
    assert t_mesh.replicated() == ()
    # one rank's dropout draws: seeded with (seed, rank)
    a = torch.rand(4, generator=t_multihost.rank_generator(5))
    b = torch.rand(4, generator=torch.Generator().manual_seed(5 * 1_000_003))
    assert torch.equal(a, b)


class _FakeMesh:
    """Rank (0, 1) of a (1, 2) mesh, for the placements that need no
    collective (the model axis's slicing)."""
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 2)[dim]

    def get_coordinate(self):
        return [0, 1]

    def get_group(self, name):
        return object()


def test_next_slice_placements_raise():
    """Parameters sharded over 'data' (RULES_2D) still raise, naming the
    ROADMAP.md item of the next slice; a 'model' axis now shards the tree:
    the second model rank holds the second half of the column-parallel
    q kernel and bias and of the row-parallel out kernel's rows, and the
    out bias and the layer norms whole."""
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        t_mesh.shard_params({"a": torch.ones(2)}, None,
                            t_mesh.RULES_2D)
    from distil_whisper_tpu_torch.models import init_params
    cfg = PRESETS["test-tiny"]
    full = init_params(cfg, seed=0, device="cpu")
    ours = tree_paths(t_mesh.shard_params(full, _FakeMesh(), cfg=cfg))
    full = tree_paths(full)
    d = cfg.d_model
    attn = "decoder.layers.self_attn"
    assert torch.equal(ours[f"{attn}.q.kernel"],
                       full[f"{attn}.q.kernel"][..., d // 2:])
    assert torch.equal(ours[f"{attn}.q.bias"], full[f"{attn}.q.bias"][:, d // 2:])
    assert torch.equal(ours[f"{attn}.out.kernel"],
                       full[f"{attn}.out.kernel"][:, d // 2:])
    for p in (f"{attn}.out.bias", "decoder.layers.final_ln.scale",
              "decoder.tok_emb", "encoder.conv1.kernel"):
        assert ours[p] is full[p], p


def test_all_reduce_buckets_split_by_size(monkeypatch):
    """The buckets hold at most BUCKET_BYTES (a larger tensor alone), in
    order; the broadcast's also split where the dtype changes."""
    monkeypatch.setattr(t_multihost, "BUCKET_BYTES", 64)
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(40),
          torch.zeros(3, dtype=torch.int8), torch.zeros(2)]
    fp32 = [[t.numel() for t in b] for b in
            t_multihost._buckets(ts, same_dtype=False)]
    assert fp32 == [[10], [10], [40], [3, 2]]
    same = [[(t.numel(), t.dtype) for t in b] for b in
            t_multihost._buckets(ts, same_dtype=True)]
    assert same == [[(10, torch.float32)], [(10, torch.float32)],
                    [(40, torch.float32)], [(3, torch.int8)],
                    [(2, torch.float32)]]


def test_per_rank_manifests_read_in_rank_order(tmp_path):
    """A pseudo-labelling output directory reads as its manifests in rank
    order (rank 10 after rank 2), or as its single ``dataset.jsonl``."""
    for r in (0, 2, 10, 1):
        (tmp_path / f"dataset-{r}.jsonl").write_text(
            json.dumps({"text": f"r{r}a"}) + "\n"
            + json.dumps({"text": f"r{r}b"}) + "\n")
    (tmp_path / "dataset-x.jsonl").write_text("")
    assert [p.name for p in pl_manifests(tmp_path)] == [
        "dataset-0.jsonl", "dataset-1.jsonl", "dataset-2.jsonl",
        "dataset-10.jsonl"]
    assert [r["text"] for r in load_dataset_any(str(tmp_path))] == [
        f"r{r}{s}" for r in (0, 1, 2, 10) for s in "ab"]
    single = tmp_path / "one"
    single.mkdir()
    (single / "dataset.jsonl").write_text(json.dumps({"text": "x"}) + "\n")
    assert load_dataset_any(str(single)) == [{"text": "x"}]


KERNEL_WRAPPERS = {
    "distil_whisper_tpu_torch/audio/mel_kernel.py": "dw_log_mel",
    "distil_whisper_tpu_torch/ops/encoder_attention.py": "dw_encoder_attention",
    "distil_whisper_tpu_torch/ops/int8_mlp.py": "dw_int8_mlp",
    "distil_whisper_tpu_torch/ops/int8_decode_attention.py":
        "dw_int8_decode_attention",
}


@pytest.mark.parametrize("source", sorted(KERNEL_WRAPPERS))
def test_kernel_launch_runs_under_its_tensors_device(source):
    """The kernels launch on the CUDA runtime's current device, so each
    wrapper calls its library inside ``with torch.cuda.device(t.device)``
    for the tensor ``t`` whose stream it passes: a rank on ``cuda:1``
    whose producer thread never set the device would otherwise launch on
    card 0 with card 1's stream."""
    tree = ast.parse((ROOT / source).read_text())
    launches = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        ctx = node.items[0].context_expr
        if not (isinstance(ctx, ast.Call)
                and ast.unparse(ctx.func) == "torch.cuda.device"):
            continue
        guarded = ast.unparse(ctx.args[0])
        for call in ast.walk(node):
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == KERNEL_WRAPPERS[source]):
                stream = ast.unparse(call.args[-1])
                launches.append((guarded, stream))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == KERNEL_WRAPPERS[source]]
    assert len(launches) == len(calls) == 1, (launches, len(calls))
    guarded, stream = launches[0]
    assert guarded.endswith(".device")
    assert stream == f"torch.cuda.current_stream({guarded}).cuda_stream"
