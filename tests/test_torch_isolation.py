"""The port stands alone: no JAX, nothing of the JAX package, and no silent
move to the CPU when the card is missing."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distil_whisper_tpu_torch

PKG = Path(distil_whisper_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
# the JAX package's name as a whole word: ``distil_whisper_tpu_torch`` starts
# with it and must not match
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|distil_whisper_tpu)\b(?!_)",
    re.MULTILINE)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_pattern_tells_the_packages_apart():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from distil_whisper_tpu.config import X")
    assert FORBIDDEN.search("    import distil_whisper_tpu")
    assert not FORBIDDEN.search("from distil_whisper_tpu_torch import config")
    assert not FORBIDDEN.search("import jaxtyping_like_name")


@pytest.mark.parametrize("script", ["chip_smoke.py", None])
def test_no_source_imports_jax_or_the_jax_package(script):
    paths = [ROOT / script] if script else [p for p, _ in _modules()]
    for path in paths:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


# beam, sampling, sequential long-form, word timestamps and the eval CLI
LONG_FORM_MODULES = (
    "distil_whisper_tpu_torch.generation.beam",
    "distil_whisper_tpu_torch.generation.sequential",
    "distil_whisper_tpu_torch.generation.word_timestamps",
    "distil_whisper_tpu_torch.tokenizer.normalizers",
    "distil_whisper_tpu_torch.metrics",
    "distil_whisper_tpu_torch.metrics.wer",
    "distil_whisper_tpu_torch.cli",
    "distil_whisper_tpu_torch.cli.common",
    "distil_whisper_tpu_torch.cli.run_eval",
    "distil_whisper_tpu_torch.cli.run_long_form_transcription",
)
# the package as a module name: a file path (the kernels line's "replaces")
# is not an import
JAX_PACKAGE_WORD = re.compile(r"\bdistil_whisper_tpu\b(?![_/])")


def test_long_form_modules_are_checked():
    assert set(LONG_FORM_MODULES) <= {name for _, name in _modules()}


# speculative decoding and the modules it changed (per-lane cursors, the
# per-lane logits processors, the wired entry points)
SPECULATIVE_MODULES = (
    "distil_whisper_tpu_torch.generation.speculative",
    "distil_whisper_tpu_torch.generation.logits",
    "distil_whisper_tpu_torch.models.whisper",
    "distil_whisper_tpu_torch.ops.attention",
    "distil_whisper_tpu_torch.pipeline",
    "distil_whisper_tpu_torch.tokenizer.bpe",
)


def test_speculative_modules_are_checked():
    assert set(SPECULATIVE_MODULES) <= {name for _, name in _modules()}


# serving: both schedulers, the HTTP front end and the server CLI
SERVING_MODULES = (
    "distil_whisper_tpu_torch.serving",
    "distil_whisper_tpu_torch.serving_engine",
    "distil_whisper_tpu_torch.cli.run_server",
)


def test_serving_modules_are_checked():
    assert set(SERVING_MODULES) <= {name for _, name in _modules()}


# training: losses, the optimizer, the steps, student init, data,
# checkpoints, the profiling utilities and the training CLIs
TRAINING_MODULES = (
    "distil_whisper_tpu_torch.training",
    "distil_whisper_tpu_torch.training.losses",
    "distil_whisper_tpu_torch.training.state",
    "distil_whisper_tpu_torch.training.distill",
    "distil_whisper_tpu_torch.training.student",
    "distil_whisper_tpu_torch.training.data",
    "distil_whisper_tpu_torch.training.checkpoint",
    "distil_whisper_tpu_torch.utils.profiling",
    "distil_whisper_tpu_torch.cli.create_student_model",
    "distil_whisper_tpu_torch.cli.run_distillation",
    "distil_whisper_tpu_torch.cli.run_finetuning",
)


def test_training_modules_are_checked(tmp_path):
    """The training modules are among those the import checks above scan,
    and the training CLIs default to the card and raise without it (the
    checkpoints are never read)."""
    assert set(TRAINING_MODULES) <= {name for _, name in _modules()}
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA default is valid here")
    from distil_whisper_tpu_torch.cli import (create_student_model,
                                              run_distillation, run_finetuning)
    ck = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_student_model.main(["--teacher_checkpoint", ck,
                                   "--save_dir", ck])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_distillation.main(["--teacher_checkpoint", ck,
                               "--student_checkpoint", ck,
                               "--train_dataset_path", ck,
                               "--output_dir", ck])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_finetuning.main(["--model_checkpoint", ck,
                             "--train_dataset_path", ck, "--output_dir", ck])


# the rest of the recipe: QAT, pseudo-labelling with streaming data and
# its publisher, the checkpoint converter and the sweep runner
RECIPE_MODULES = (
    "distil_whisper_tpu_torch.ops.qat",
    "distil_whisper_tpu_torch.training.data_stream",
    "distil_whisper_tpu_torch.training.pl_workers",
    "distil_whisper_tpu_torch.utils.publish",
    "distil_whisper_tpu_torch.cli.run_pseudo_labelling",
    "distil_whisper_tpu_torch.cli.convert_checkpoint_to_hf",
    "distil_whisper_tpu_torch.cli.run_sweep",
)


def test_recipe_modules_are_checked(tmp_path):
    """The recipe's remaining modules are among those the import checks
    scan, and its new CLIs default to the card and raise without it."""
    assert set(RECIPE_MODULES) <= {name for _, name in _modules()}
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA default is valid here")
    from distil_whisper_tpu_torch.cli import (convert_checkpoint_to_hf,
                                              run_pseudo_labelling)
    ck = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_pseudo_labelling.main(["--model_checkpoint", ck,
                                   "--dataset_path", ck, "--output_dir", ck])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_checkpoint_to_hf.main(["--checkpoint_dir", ck,
                                       "--base_checkpoint", ck,
                                       "--save_dir", ck])


# data-parallel multi-GPU: process groups, the mesh and its rules, the
# dry run
PARALLEL_MODULES = (
    "distil_whisper_tpu_torch.parallel",
    "distil_whisper_tpu_torch.parallel.mesh",
    "distil_whisper_tpu_torch.parallel.multihost",
    "distil_whisper_tpu_torch.parallel.dryrun",
)


def test_parallel_modules_are_checked():
    """The parallel package is among the modules the import checks scan
    (no jax, nothing of the JAX package), and importing it loads neither
    the model nor a kernel module."""
    assert set(PARALLEL_MODULES) <= {name for _, name in _modules()}
    code = ("import sys\n"
            "import distil_whisper_tpu_torch.parallel.dryrun\n"
            "heavy = [m for m in sys.modules if m.startswith("
            "('distil_whisper_tpu_torch.models', "
            "'distil_whisper_tpu_torch.ops', 'jax'))]\n"
            "print('HEAVY', heavy)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "HEAVY []", (out.stdout, out.stderr[-2000:])


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docstrings.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings]


@pytest.mark.parametrize("script", ["chip_smoke.py", None])
def test_no_code_names_the_jax_package(script):
    """No identifier or string in code (a dynamic import, a ``-m`` command)
    names the JAX package as a whole word; docstrings and comments may."""
    paths = [ROOT / script] if script else [p for p, _ in _modules()]
    for path in paths:
        tree = ast.parse(path.read_text())
        names = [n.id for n in ast.walk(tree) if isinstance(n, ast.Name)]
        names += [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)]
        hits = [t for t in _code_strings(tree) + names
                if JAX_PACKAGE_WORD.search(t)]
        assert not hits, f"{path.relative_to(ROOT)} names {hits}"


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["distil_whisper_tpu"] = None
import importlib
for name in {modules!r}:
    importlib.import_module(name)
import numpy as np, torch
torch.set_num_threads(2)
from distil_whisper_tpu_torch.config import PRESETS
from distil_whisper_tpu_torch.models import init_params
from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                  encode_and_generate)
cfg = PRESETS["test-tiny"].replace(use_flash_encoder=True)
params = init_params(cfg, seed=0, device="cpu")
mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype("float32")
opts = GenerationOptions.from_config(cfg, max_new_tokens=4)
out = encode_and_generate(params, cfg, mel, [[50258, 50259, 50359, 50363]],
                          opts, device="cpu")
assert out.sequences.shape == (1, 8), out.sequences.shape
assert not any(m == "jax" or m.startswith(("jax.", "distil_whisper_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", len({modules!r}))
"""


def test_imports_and_runs_with_jax_blocked():
    modules = [name for _, name in _modules()]
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(modules=modules)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == f"OK {len(modules)}"


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA default is valid here")
    from distil_whisper_tpu_torch.audio import compute_mel
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.generation import (GenerationOptions,
                                                      encode_and_generate)
    from distil_whisper_tpu_torch.models import init_params
    from distil_whisper_tpu_torch.pipeline import WhisperPipeline
    cfg = PRESETS["test-tiny"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WhisperPipeline(None, dtype=torch.float32, cfg=cfg, params={},
                        tokenizer=object())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_mel(np.zeros(16000, np.float32), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_and_generate(params, cfg, np.zeros((1, 80, 3000), np.float32),
                            [[50258]], GenerationOptions())
    # the server CLI defaults to the card too (the checkpoint is never read)
    from distil_whisper_tpu_torch.cli.run_server import build_server
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(["--model_checkpoint", str(tmp_path), "--port", "0"])


def test_transcribers_over_a_cuda_less_pipeline_raise():
    """A transcriber runs on its pipeline's device: over a pipeline that
    names the card where there is none, both schedulers refuse to be built
    (nothing moves to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA device is valid here")
    from types import SimpleNamespace
    from distil_whisper_tpu_torch.config import PRESETS
    from distil_whisper_tpu_torch.serving import BatchingTranscriber
    from distil_whisper_tpu_torch.serving_engine import ContinuousTranscriber
    pipe = SimpleNamespace(cfg=PRESETS["test-tiny"], tokenizer=None,
                           dtype=torch.float32, device=torch.device("cuda"),
                           batch_size=2, max_new_tokens=4, params={})
    for cls in (BatchingTranscriber, ContinuousTranscriber):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(pipe)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA never reaches a plain
    version."""
    from distil_whisper_tpu_torch.audio.mel_kernel import log10_mel_fused
    from distil_whisper_tpu_torch.ops.encoder_attention import encoder_attention
    meta = torch.empty((1, 4, 128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_attention(meta, meta, meta, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        log10_mel_fused(torch.empty((1, 16000), device="meta"), 80)
    from distil_whisper_tpu_torch.ops.int8_decode_attention import (
        int8_decode_attention)
    from distil_whisper_tpu_torch.ops.int8_mlp import fused_int8_mlp
    fc = {"kernel_q": torch.empty((128, 512), dtype=torch.int8, device="meta"),
          "kernel_scale": torch.empty((1, 512), device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_int8_mlp(fc, fc, torch.empty((300, 128), device="meta"))
    kv = torch.empty((1, 64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        int8_decode_attention(torch.empty((1, 128), device="meta"), kv,
                              torch.empty((1, 2), device="meta"), kv,
                              torch.empty((1, 2), device="meta"), 2)
