"""What the int8 kernels' wrappers compute on the host (CPU, no nvcc).

The CUDA kernels of ``csrc/int8_mlp.cu`` and ``csrc/int8_decode_attention.cu``
run only on the card; what they take from the host is held here: the MLP's
tensor-map geometry and persistent tile schedule, the decode attention's
split of T over a thread-block cluster, and the build's hash of the headers
the sources include.
"""

import shutil

import pytest
import torch

from distil_whisper_tpu_torch.ops import _build
from distil_whisper_tpu_torch.ops import int8_decode_attention as tda
from distil_whisper_tpu_torch.ops import int8_mlp as tmlp
from distil_whisper_tpu_torch.ops.quant import output_major


def _operands(m, d, f):
    w1q = output_major(torch.zeros(d, f, dtype=torch.int8))
    w2q = output_major(torch.zeros(f, d, dtype=torch.int8))
    return {"x": torch.empty(m, d, dtype=torch.bfloat16),
            "xq": torch.empty(m, d, dtype=torch.int8),
            "hq": torch.empty(m, f, dtype=torch.int8),
            "w1q": w1q.T, "w2q": w2q.T}


def test_mlp_tma_geometry_of_the_main_path_operands():
    geo = tmlp._tma_geometry(_operands(300, 1280, 5120))
    assert geo == {"x": ((1280, 300), 2560), "xq": ((1280, 300), 1280),
                   "hq": ((5120, 300), 5120), "w1q": ((1280, 5120), 1280),
                   "w2q": ((5120, 1280), 5120)}


def test_mlp_tma_geometry_takes_padded_rows():
    """A row stride wider than the row (a multiple of 16 bytes) is what a
    tensor map takes: dims stay the matrix's, the stride is the buffer's."""
    x = torch.empty(300, 1280 + 64, dtype=torch.bfloat16)[:, :1280]
    assert tmlp._tma_geometry({"x": x})["x"] == ((1280, 300), 2688)


@pytest.mark.parametrize("layout", ["row_major_weight", "base", "row_stride",
                                    "column_stride"])
def test_mlp_tma_geometry_rejects_what_tma_cannot_take(layout):
    if layout == "row_major_weight":    # kernel_q [D, F] as stored by JAX
        t = torch.zeros(128, 512, dtype=torch.int8).T
    elif layout == "base":              # 8 bytes past a 16-byte boundary
        t = torch.empty(300 * 128 + 8, dtype=torch.int8)[8:].view(300, 128)
    elif layout == "row_stride":        # rows 136 bytes apart
        t = torch.empty(300 * 136 + 8, dtype=torch.int8).as_strided(
            (300, 128), (136, 1))
    else:                               # every other column
        t = torch.empty(300, 256, dtype=torch.int8)[:, ::2]
    with pytest.raises(ValueError, match="fused_int8_mlp"):
        tmlp._tma_geometry({"w": t})


@pytest.mark.parametrize("m", [256, 300, 1500, 24000])
@pytest.mark.parametrize("product,n", [("fc1", 5120), ("fc2", 1280),
                                       ("fc2", 128)])
def test_mlp_tile_schedule_covers_every_tile_once(m, product, n):
    n_clusters, row_blocks, col_blocks = tmlp.tile_grid(m, n, product, 132)
    tiles = tmlp.tile_schedule(m, n, product, 132)
    assert len(tiles) == n_clusters <= 66
    flat = [t for pair in tiles for t in pair]
    assert sorted(flat) == [(r, c) for r in range(row_blocks)
                            for c in range(col_blocks)]
    # rows [0, m) and columns [0, n) covered, and no tile wholly past m
    tile_m = tmlp.TILE_M
    assert (row_blocks - 1) * tile_m < m <= row_blocks * tile_m
    assert (col_blocks - 1) * tmlp.TILE_N[product] < n
    assert n <= col_blocks * tmlp.TILE_N[product]
    # the persistent grid is balanced to within one tile a pair
    assert max(map(len, tiles)) - min(map(len, tiles)) <= 1


@pytest.mark.parametrize("t", [32, 448, 1536, 8192, 2080])
def test_decode_attention_cluster_split_covers_t_once(t):
    cl, slice_, box = tda._cluster_split(t)
    assert cl in (2, 4, 8) and box <= 256 and box % 8 == 0
    assert slice_ % box == 0
    rows = []
    for rank in range(cl):
        n = max(0, min(slice_, t - rank * slice_))
        rows += range(rank * slice_, rank * slice_ + n)
        # the TMA boxes of a rank stay inside its slice of shared memory
        assert -(-n // box) * box <= slice_
    assert rows == list(range(t))
    # shared memory of one CTA: the K (then V) slice, fp32 scores,
    # scales and mask, int8 p
    assert slice_ * (64 + 4 * 4 + 1) + 128 <= 232448


def test_decode_attention_cluster_split_uses_every_cta_at_main_shapes():
    for t, cl in ((448, 2), (1536, 4), (8192, 8)):
        got, slice_, _ = tda._cluster_split(t)
        assert got == cl and slice_ * cl == t


def test_build_hash_covers_the_shared_headers(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    assert sorted(p.name for p in src.glob("*.cuh")) == ["hopper.cuh"]
    before = {n: _build._lib_path(n, src) for n in _build.SOURCES}
    assert before == {n: _build._lib_path(n) for n in _build.SOURCES}
    header = src / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._lib_path(n, src) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    # a source's own edit moves only its own library
    mel = src / "mel.cu"
    mel.write_bytes(mel.read_bytes() + b"\n")
    again = {n: _build._lib_path(n, src) for n in _build.SOURCES}
    assert [n for n in _build.SOURCES if again[n] != after[n]] == ["mel"]
