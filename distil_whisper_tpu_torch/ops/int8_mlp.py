"""Fused W8A8 MLP: the CUDA kernels' wrapper and their plain version.

The kernels (``csrc/int8_mlp.cu``) replace the Pallas TPU kernel of
``distil_whisper_tpu/ops/int8_mlp.py`` (``_kernel``), the encoder MLP of the
int8 lane.  The function, per row of x [M, D]:

    xq, xs = per-row int8 of x (absmax, scale floor 1e-12)
    for each ffn chunk c of 512 columns, in order:
        h   = (xq @ w1q[:, c]) [int32] * xs * w1s[c] + b1[c]     (fp32)
        h   = gelu(h), erf by Abramowitz-Stegun 7.1.26            (fp32)
        hq, hs = int8 of h per (row, chunk)
        acc += (hq @ w2q[c, :]) [int32] * hs                      (fp32)
    out = acc * w2s + b2, cast to x.dtype

The per-(row, chunk) scales are finer than the per-row scale over the whole
ffn that the unfused ``dense_int8 -> gelu -> dense_int8`` path uses, so the
two are different functions (``mlp_block`` chooses, as in JAX).

The TPU kernel keeps a [512, 1280] fp32 accumulator in VMEM across the ffn
chunks; a Hopper block cannot hold one of useful height, so the card runs
the function as a kernel chain (see the note in the source): a row
quantizer, fc1 with the gelu and the per-(row, chunk) requantization in its
epilogue (int8 h and its scales go to device memory), and fc2, which
applies the chunk scales inside its K loop and accumulates in fp32 in chunk
order.  Both products are one Hopper GEMM (TMA into an mbarrier ring, int8
``wgmma``, a producer warp and two consumer warpgroups, CTA pairs that
multicast the activation tile, a persistent grid).  What the kernels need
from the host is computed here: the tensor maps' geometry
(:func:`_tma_geometry`) and the persistent tile schedule
(:func:`tile_grid`, :func:`tile_schedule`).  :func:`fused_int8_mlp` launches the chain for
CUDA tensors (bf16 only) and runs :func:`fused_int8_mlp_plain` for CPU
tensors; anything else raises.  ``fused_int8_mlp.launches`` counts launches
of the chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quant import int_mm, quantize_acts, symmetric_int8

CHUNK_F = 512          # ffn columns per requantization chunk (JAX chunk_f)
TILE_M = 128           # rows of an output tile (csrc/int8_mlp.cu TM)
# columns of a CTA pair's output tile: fc1 one ffn chunk, fc2 2 x 128
TILE_N = {"fc1": CHUNK_F, "fc2": 256}


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7), the TPU kernel's,
    in the same order of operations as the CUDA kernel."""
    s = torch.sign(x)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-a * a))


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def mlp_supported(fc1, x: torch.Tensor) -> bool:
    """The JAX shape gate of the fused path: int8 weights, d % 128 == 0,
    ffn % 512 == 0 and at least 256 rows (below that the work is weight-read
    bound and ``dense_int8`` streams the weights as fast)."""
    if "kernel_q" not in fc1:
        return False
    d, f = x.shape[-1], fc1["kernel_q"].shape[-1]
    return x.numel() // d >= 256 and d % 128 == 0 and f % CHUNK_F == 0


def _operands(fc1, fc2):
    d, f = fc1["kernel_q"].shape
    if f % CHUNK_F or tuple(fc2["kernel_q"].shape) != (f, d):
        raise ValueError(f"fused_int8_mlp: fc1 {(d, f)} and fc2 "
                         f"{tuple(fc2['kernel_q'].shape)} must be [D, F] and "
                         f"[F, D] with F % {CHUNK_F} == 0")
    w1s = fc1["kernel_scale"].reshape(f).float()
    w2s = fc2["kernel_scale"].reshape(d).float()
    b1 = fc1["bias"].float() if "bias" in fc1 else w1s.new_zeros(f)
    b2 = fc2["bias"].float() if "bias" in fc2 else w2s.new_zeros(d)
    return fc1["kernel_q"], w1s, b1, fc2["kernel_q"], w2s, b2


def fused_int8_mlp_plain(fc1, fc2, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x [..., D] -> [..., D] in
    x.dtype (int8 products exact, fp32 epilogues in the kernel's order)."""
    w1q, w1s, b1, w2q, w2s, b2 = _operands(fc1, fc2)
    d, f = w1q.shape
    xm = x.reshape(-1, d)
    xq, xs = quantize_acts(xm)
    h = int_mm(xq, w1q).float() * xs * w1s + b1
    h = _gelu_exact(h).view(-1, f // CHUNK_F, CHUNK_F)
    hq, hs = symmetric_int8(h, h.abs().amax(dim=-1, keepdim=True))
    acc = None
    for c in range(f // CHUNK_F):
        y = int_mm(hq[:, c], w2q[c * CHUNK_F:(c + 1) * CHUNK_F]).float()
        y = y * hs[:, c]
        acc = y if acc is None else acc + y
    return (acc * w2s + b2).to(x.dtype).view(x.shape)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("int8_mlp")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_int8_mlp.argtypes = ([p] * 7 + [p] * 4 + [p, i, i, i] + [ll] * 5
                                + [i, i, p])
    lib.dw_int8_mlp.restype = ctypes.c_int
    return lib


def _tma_geometry(operands):
    """``{name: (dims, row_bytes)}`` of the 2-D tensor maps (and x's rows)
    through which the kernels read ``operands``: a dict of the row-major
    matrices x [M, D] bf16, xq [M, D] int8, hq [M, F] int8, and the weights
    as their output-major views w1q [F, D], w2q [D, F] (int8; ``kernel_q.T``).
    dims are (columns, rows), innermost first, in elements.  Raises
    ``ValueError`` on what TMA cannot take: a stride along the columns, a
    base or row stride that is not a multiple of 16 bytes."""
    geometry = {}
    for name, t in operands.items():
        if t.ndim != 2 or t.stride(1) != 1:
            raise ValueError(f"fused_int8_mlp: {name} must be a row-major "
                             f"matrix, got strides {tuple(t.stride())}")
        row_bytes = t.stride(0) * t.element_size()
        if t.data_ptr() % 16 or row_bytes % 16 or \
                row_bytes < t.shape[1] * t.element_size():
            raise ValueError(f"fused_int8_mlp: TMA needs a 16-byte aligned "
                             f"base and row stride for {name}; got base "
                             f"{t.data_ptr():#x}, rows {row_bytes} bytes apart")
        geometry[name] = ((t.shape[1], t.shape[0]), row_bytes)
    return geometry


def tile_grid(m: int, n: int, product: str, n_sm: int):
    """``(n_clusters, row_blocks, col_blocks)`` of one product of the chain
    (``n`` its output width: F for fc1, D for fc2): output tiles of
    ``TILE_M`` rows by ``TILE_N[product]`` columns (fc2's last
    block half empty where D is an odd multiple of 128), and a persistent
    grid of one CTA pair for every two SMs, or one a tile when there are
    fewer tiles."""
    row_blocks = -(-m // TILE_M)
    col_blocks = -(-n // TILE_N[product])
    return max(1, min(row_blocks * col_blocks, n_sm // 2)), row_blocks, col_blocks


def tile_schedule(m: int, n: int, product: str, n_sm: int):
    """The tiles as the kernel walks them: ``tiles[c]`` lists the
    (row block, column block) pairs that CTA pair ``c`` computes, in order.
    Tiles are numbered column block fastest; pair c takes tiles c,
    c + n_clusters, ..."""
    n_clusters, row_blocks, col_blocks = tile_grid(m, n, product, n_sm)
    n_tiles = row_blocks * col_blocks
    return [[divmod(t, col_blocks) for t in range(c, n_tiles, n_clusters)]
            for c in range(n_clusters)]


def fused_int8_mlp(fc1, fc2, x: torch.Tensor) -> torch.Tensor:
    """W8A8 MLP of x [..., D] against int8 dense params ``fc1`` [D, F] and
    ``fc2`` [F, D] -> [..., D] in x.dtype."""
    if x.device.type == "cpu":
        return fused_int8_mlp_plain(fc1, fc2, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_int8_mlp: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_int8_mlp kernel takes bf16 x, got {x.dtype}")
    w1q, w1s, b1, w2q, w2s, b2 = _operands(fc1, fc2)
    d, f = w1q.shape
    if x.shape[-1] != d or d % 128:
        raise ValueError(f"fused_int8_mlp kernel takes x [..., {d}] with "
                         f"d % 128 == 0, got {tuple(x.shape)}")
    xm = x.reshape(-1, d)
    m = xm.shape[0]
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise ValueError("fused_int8_mlp: weights must be int8")
    for name, t in (("fc1.kernel_q", w1q), ("fc2.kernel_q", w2q)):
        if t.device != x.device:
            raise ValueError(f"fused_int8_mlp: {name} on {t.device}")
    w1s, b1, w2s, b2 = (t.contiguous() for t in (w1s, b1, w2s, b2))
    out = torch.empty_like(xm)
    # scratch of the kernel chain: int8 x and its row scales, int8 gelu
    # output and its per-(row, chunk) scales
    xq = torch.empty((m, d), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    hq = torch.empty((m, f), dtype=torch.int8, device=x.device)
    hs = torch.empty((m, f // CHUNK_F), dtype=torch.float32, device=x.device)
    # the kernels read x by rows and each weight by output columns
    # (output-major, ops/quant.py::output_major)
    geo = _tma_geometry({"x": xm, "xq": xq, "hq": hq, "w1q": w1q.T,
                         "w2q": w2q.T})
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    clusters = [tile_grid(m, n, p, n_sm)[0]
                for p, n in (("fc1", f), ("fc2", d))]
    err = _lib().dw_int8_mlp(
        xm.data_ptr(), w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(),
        w2q.data_ptr(), w2s.data_ptr(), b2.data_ptr(),
        xq.data_ptr(), xs.data_ptr(), hq.data_ptr(), hs.data_ptr(),
        out.data_ptr(), m, d, f,
        *(geo[k][1] for k in ("x", "w1q", "w2q", "xq", "hq")), *clusters,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 MLP kernel launch failed (cudaError {err})")
    _build.count_launch(fused_int8_mlp)
    return out.view(x.shape)


fused_int8_mlp.launches = 0
