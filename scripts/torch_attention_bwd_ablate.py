#!/usr/bin/env python3
"""Ablations of the encoder-attention backward kernel on the GPU: what bounds
``csrc/encoder_attention_bwd.cu``.

    python3 scripts/torch_attention_bwd_ablate.py [--source FILE.cu] [--batch 2]
    python3 scripts/torch_attention_bwd_ablate.py --fused_route

Builds the kernel source (default: this checkout's) and diagnostic variants
of it, made by rewriting the source's text, each into its own library, and
times each variant's whole backward and each pass alone at (B, 20, 1500, 64)
bf16 ([B, H, T, 64] views of [B, T, 1280] projections) in a CUDA graph of
20 calls, median of 5 replays, in the order A, B, ..., B, A.  The variants:

- ``base``: the source as it is;
- ``no_turns``: without the consumers' turns at the tensor cores (named
  barriers removed);
- ``no_exp``: P without ex2 (the special-function units' share);
- ``no_softmax``: P and dS not computed, the products' operands packed as
  they come (the products, loads and synchronisation alone);
- ``no_stream_loads``: the streamed ring tiles never loaded (stale shared
  memory; the L2 -> SM traffic's share);
- ``products_only``: ``no_softmax`` and ``no_stream_loads`` together.

Only ``base`` computes the gradient: its largest difference from
``encoder_attention_bwd_plain`` is printed beside its times.  A variant
whose pattern is absent from the source is reported as such and skipped.
Prints one JSON line with the ptxas report, each kernel's highest SASS
register and local-memory instructions, the times, and the card's name and
power limit.

``--fused_route`` times the dQ route not taken instead:
``scripts/attention_bwd_fused_route.cu``, one pass adding each key tile's
dQ partial with fp32 atomics, against this checkout's kernel, both in CUDA
graphs in the order kernel, fused, fused, kernel at (B, 20, 1500, 64), and
holds it against ``encoder_attention_bwd_plain`` at ``chip_smoke.py``'s
held shapes (the largest difference of dq, dk and dv, and whether it is
within ``GRAD_TOL``).  The timing helpers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import GRAD_TOL, cuda_graph_ms, sass_report  # noqa: E402

NO_SOFTMAX = [
    (r"ds_rows<(true|false)>\(([^,]*), ([^,]*), ([^,]*),[^;]*\);",
     "{\n#pragma unroll\n"
     r"for (int kk_ = 0; kk_ < sizeof(\2) / sizeof(\2[0]); ++kk_) "
     "pack_a(\\2[kk_], \\4, kk_);\n}"),
    (r"p_ds_cols<(true|false)>\(([^,]*), ([^,]*), ([^,]*), ([^,]*),[^;]*\);",
     "{\n#pragma unroll\n"
     r"for (int kk_ = 0; kk_ < sizeof(\2) / sizeof(\2[0]); ++kk_) "
     "{ pack_a(\\2[kk_], \\4, kk_); pack_a(\\3[kk_], \\5, kk_); }\n}")]
NO_STREAM_LOADS = [
    (r"mbar_expect_tx\(&bar->full\[ring\.s\], [^;]*\);\n(.*?)ring\.next\(\);",
     "mbar_arrive(&bar->full[ring.s]);\n          ring.next();")]
VARIANTS = {
    "base": [],
    "no_turns": [(r"\bbar_sync\(1 \+ c\);", ";"),
                 (r"\bbar_arrive\([^;]*\);", ";")],
    "no_exp": [(r"ex2\(fmaf\(([^,]*), scale_log2, ([^)]*)\)\)",
                r"fmaf(\1, scale_log2, \2)")],
    "no_softmax": NO_SOFTMAX,
    "no_stream_loads": NO_STREAM_LOADS,
    "products_only": NO_SOFTMAX + NO_STREAM_LOADS,
}


def rewrite(text: str, pairs):
    """``text`` with every pattern replaced, or None if one is absent."""
    for pattern, repl in pairs:
        if not re.search(pattern, text, flags=re.S):
            return None
        text = re.sub(pattern, repl, text, flags=re.S)
    return text


def build(cu: Path, lib: Path, nvcc: str, _build):
    return subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-o", str(lib),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def built_report(name: str, proc, lib: Path):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed to build:\n{log}")
    return {"ptxas": [ln.strip() for ln in log.splitlines()
                      if any(w in ln for w in ("registers", "spill", "rror"))],
            "sass": sass_report(name, lib), "lib": lib}


def bwd_inputs(b, h, t, d, gen):
    """q, k, v and the cotangent as [B, H, T, 64] views of [B, T, H * 64]
    projections, from ``gen``."""
    import torch
    return [torch.randn(b, t, h * d, generator=gen, device="cuda")
            .to(torch.bfloat16).view(b, t, h, d).transpose(1, 2)
            for _ in range(4)]


def fused_route(args, out_dir: Path, nvcc: str):
    """The fused dQ route's prototype against this checkout's kernel."""
    import torch
    from distil_whisper_tpu_torch.ops import _build
    from distil_whisper_tpu_torch.ops import encoder_attention as ea
    lib_path = out_dir / "lib_fused_route.so"
    report = built_report(
        "fused_route", build(ROOT / "scripts/attention_bwd_fused_route.cu",
                             lib_path, nvcc, _build), lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dw_encoder_attention_bwd_fused.argtypes = [p] * 11 + [i] * 5 + [f, f, p, p]
    lib.dw_encoder_attention_bwd_fused.restype = ctypes.c_int
    _build.build_all(["encoder_attention", "encoder_attention_bwd"])

    def fused(q, k, v, out, lse, g, t_real):
        """dq, dk, dv from the prototype: a call's buffers, then a function
        that launches it into them."""
        b, h, t, d = q.shape
        _, grid, rows = ea.bwd_geometry(b, h, t, ea._sm_count(q.device.index))
        ld = torch.empty(b * h * rows * 2, dtype=torch.float32, device="cuda")
        acc = torch.empty(b * h * rows * d, dtype=torch.float32, device="cuda")
        grads = ea._grad_buffers(q, 3)
        strides = (ctypes.c_longlong * 15)(
            *(s for x in (q, k, v, out, g) for s in ea._tma_geometry(x)[1]))

        def call():
            err = lib.dw_encoder_attention_bwd_fused(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                g.data_ptr(), lse.data_ptr(), ld.data_ptr(), acc.data_ptr(),
                *(x.data_ptr() for x in grads), b, h, t, t_real, grid,
                d ** -0.5 * ea.LOG2E, d ** -0.5, strides,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"fused route launch failed (cudaError {err})")
        return grads, call

    gen = torch.Generator(device="cuda").manual_seed(0)
    held = []
    for shape, t_real in (((2, 20, 1500, 64), 1500), ((3, 5, 200, 64), 77),
                          ((2, 3, 65, 64), 64), ((1, 1, 1, 64), 1),
                          ((2, 20, 1500, 64), 1437)):
        q, k, v, g = bwd_inputs(*shape, gen)
        out, lse = ea._launch(q, k, v, t_real, with_lse=True)
        grads, call = fused(q, k, v, out, lse, g, t_real)
        call()
        ref = ea.encoder_attention_bwd_plain(q, k, v, out, lse, g, t_real)
        torch.cuda.synchronize()
        held.append({"shape": list(shape), "t_real": t_real,
                     "max_abs_err": [(x.float() - y.float()).abs().max().item()
                                     for x, y in zip(grads, ref)],
                     "within_grad_tol": all(
                         torch.allclose(x.float(), y.float(), atol=GRAD_TOL,
                                        rtol=GRAD_TOL)
                         for x, y in zip(grads, ref))})
        print(json.dumps({"held": held[-1]}), flush=True)

    b, h, t, d = args.batch, 20, 1500, 64
    q, k, v, g = bwd_inputs(b, h, t, d, gen)
    out, lse = ea._launch(q, k, v, t, with_lse=True)
    _, call = fused(q, k, v, out, lse, g, t)
    timed = {"kernel": lambda: ea.encoder_attention_grad(q, k, v, out, lse, g, t),
             "fused": call}
    times = {"kernel": [], "fused": []}
    for name in ("kernel", "fused", "fused", "kernel"):
        times[name].append(cuda_graph_ms(timed[name], rounds=5))
        print(json.dumps({name: times[name]}), flush=True)
    return {"shape": [b, h, t, d], "held": held,
            "ms_two_passes": times["kernel"], "ms_fused": times["fused"],
            "ptxas": report["ptxas"], "sass": report["sass"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default=str(
        ROOT / "distil_whisper_tpu_torch/csrc/encoder_attention_bwd.cu"))
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--fused_route", action="store_true",
                        help="time scripts/attention_bwd_fused_route.cu "
                             "against the kernel instead of the variants")
    parser.add_argument("--out_dir", default=None,
                        help="where the variants build (default: a new temporary directory)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_bwd_ablate.py: no CUDA device", file=sys.stderr)
        return 1
    from distil_whisper_tpu_torch.ops import _build
    from distil_whisper_tpu_torch.ops import encoder_attention as ea

    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="attention_bwd_ablate_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    if args.fused_route:
        result = {"fused_route": fused_route(args, out_dir, nvcc)}
    else:
        result = variants(args, out_dir, nvcc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(json.dumps({**result, "card": smi.stdout.strip().splitlines()[0],
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def variants(args, out_dir: Path, nvcc: str):
    """The diagnostic variants of ``--source``, each timed in turns."""
    import torch
    from distil_whisper_tpu_torch.ops import _build
    from distil_whisper_tpu_torch.ops import encoder_attention as ea
    source = Path(args.source).resolve()
    text = source.read_text()
    names = args.only or list(VARIANTS)
    procs, skipped = {}, []
    for name in names:
        body = rewrite(text, VARIANTS[name])
        if body is None:
            skipped.append(name)
            continue
        cu = out_dir / f"{name}.cu"
        cu.write_text(body)
        lib = out_dir / f"lib_{name}.so"
        procs[name] = (build(cu, lib, nvcc, _build), lib)
    built = {name: built_report(name, proc, lib)
             for name, (proc, lib) in procs.items()}

    _build.build_all(["encoder_attention"])
    b, h, t, d = args.batch, 20, 1500, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = bwd_inputs(b, h, t, d, gen)
    out, lse = ea._launch(q, k, v, t, with_lse=True)
    ref = ea.encoder_attention_bwd_plain(q, k, v, out, lse, g, t)
    results = {}
    order = list(built) + list(reversed(list(built)))
    for name in order:
        _build._libs["encoder_attention_bwd"] = ctypes.CDLL(str(built[name]["lib"]))
        ea._bwd_lib.cache_clear()
        r = results.setdefault(name, {"ms": [], "ms_dq_pass": [],
                                      "ms_dkdv_only": []})
        grads = ea.encoder_attention_grad(q, k, v, out, lse, g, t)
        torch.cuda.synchronize()
        if name == "base":
            r["max_abs_err_vs_plain"] = max(
                (x.float() - y.float()).abs().max().item()
                for x, y in zip(grads, ref))
        for key, needs in (("ms", (True, True, True)),
                           ("ms_dq_pass", (True, False, False)),
                           ("ms_dkdv_only", (False, True, True))):
            r[key].append(cuda_graph_ms(lambda: ea.encoder_attention_grad(
                q, k, v, out, lse, g, t, needs), rounds=5))
        print(json.dumps({name: r}), flush=True)
    return {"source": str(source), "shape": [b, h, t, d], "skipped": skipped,
            "variants": {n: {**results[n], "ptxas": built[n]["ptxas"],
                             "sass": built[n]["sass"]} for n in built}}


if __name__ == "__main__":
    sys.exit(main())
