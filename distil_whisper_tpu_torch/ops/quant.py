"""int8 W8A8 quantization (symmetric absmax), the port of
``distil_whisper_tpu.ops.quant``.

* **Weights**: static symmetric per-output-channel absmax, quantized once at
  load time.  Stacked ``[L, i, o]`` kernels get one scale per ``(layer, o)``.
* **Activations**: dynamic symmetric per-row (last-dim) absmax.
* **Product**: int8 x int8 -> int32 through ``torch._int_mm`` (the JAX
  package leaves this product to XLA, outside any Pallas kernel), then the
  fp32 rescale ``y * act_scale * weight_scale`` in that order, the bias
  added in fp32, one cast to the activation dtype.

Rounding is half-to-even in both frameworks (``torch.round``,
``jnp.round``); values clip to +-127; the scale floor is 1e-12.  The tree
is the JAX package's (``kernel_q [.., i, o]`` int8, ``kernel_scale
[.., 1, o]`` fp32), so a tree quantized by either package fits the other.
Only the memory layout of ``kernel_q`` differs: it is stored output-major
(the transpose of a contiguous ``[.., o, i]``, see :func:`output_major`),
because cuBLASLt's int8 product takes that right operand on its fast path
(``chip_smoke.py`` times both layouts) and the int8 MLP kernel reads weight
rows of contiguous K.

``torch._int_mm`` on CUDA (cuBLASLt) takes a left operand of more than 16
rows whose width is a multiple of 8, and a right operand whose width is a
multiple of 8.  :func:`int_mm` pads the rows (zero rows, sliced off after)
and checks the widths; Whisper's widths (64..5120) are multiples of 8.  The
int8 lm head puts the 51866-row vocabulary on the row side so that it needs
no pad (``models/whisper.py``).

Tensor parallelism (``parallel/tensor_parallel.py``): a row-parallel
product (``group`` given: the input is this rank's slice of the
contraction) takes the model group's max of the per-row activation absmax,
so that every rank quantizes its slice as the unsharded row, and sums the
int32 products over the group (exactly) before the rescale and the bias.
Weight scales are per output channel over the whole contraction: quantize
the unsharded tree and then shard it, or quantize a sharded tree, whose
row-parallel kernels then take the group's max of their channel absmax.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel import tensor_parallel as tp

Params = Dict[str, Any]

# torch._int_mm on CUDA refuses a left operand of 16 rows or fewer
_INT_MM_MIN_ROWS = 17


def over_127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` by IEEE division, as JAX computes it.  PyTorch on CUDA
    turns a division by a Python number into a product with its reciprocal,
    which can round otherwise; a 0-dim tensor on the same device keeps the
    true division."""
    return x / torch.full((), 127.0, device=x.device)


def output_major(w: torch.Tensor) -> torch.Tensor:
    """``w [.., i, o]`` with the same shape and values, stored as the
    transpose of a contiguous ``[.., o, i]`` (each output's K contiguous)."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def symmetric_int8(x32: torch.Tensor, amax: torch.Tensor,
                   floor: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of fp32 ``x32`` against its absmax ``amax`` (any shape
    that broadcasts): ``scale = max(amax, floor) / 127``, ``q = clip(round(
    x / scale), -127, 127)``.  Returns (int8 q, fp32 scale)."""
    scale = over_127(torch.clamp(amax, min=floor))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(kernel: torch.Tensor, contract_axis: int = -2,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel absmax int8: ``kernel [..., i, o]``
    (contraction on ``contract_axis``) -> (int8, fp32 scale with the
    contraction axis kept as 1).  ``group``: the contraction is sharded
    over the model group (a row-parallel kernel)."""
    k32 = kernel.float()
    amax = tp.max_over(k32.abs().amax(dim=contract_axis, keepdim=True), group)
    return symmetric_int8(k32, amax)


def quantize_acts(x: torch.Tensor, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row (last-dim) absmax int8: ``[..., K]`` ->
    (int8 ``[..., K]``, fp32 scale ``[..., 1]``).  ``group``: the rows are
    sharded over the model group (a row-parallel input)."""
    x32 = x.float()
    amax = tp.max_over(x32.abs().amax(dim=-1, keepdim=True), group)
    return symmetric_int8(x32, amax)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a [M, K]`` @ int8 ``b [K, N]`` -> int32 ``[M, N]``, exact.

    Rows of ``a`` are padded with zeros to cuBLASLt's minimum of 17 and the
    pad rows dropped; the K and N widths must be multiples of 8 (the same
    rules hold on the CPU so that the CPU tests walk the card's path)."""
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise ValueError(f"int_mm: K {k} and N {b.shape[1]} must be "
                         "multiples of 8 (cuBLASLt int8 rule)")
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, k)])
    return torch._int_mm(a.contiguous(), b)[:m]


def dense_int8(p: Params, x: torch.Tensor, xq: torch.Tensor = None,
               xs: torch.Tensor = None, group=None) -> torch.Tensor:
    """``dense()`` against int8 weights ``{kernel_q [i, o], kernel_scale
    [1, o], bias?}``.  Pass a pre-quantized ``(xq, xs)`` to share one
    activation quantization across several projections.  ``group``: a
    row-parallel product over the model group."""
    if xq is None:
        xq, xs = quantize_acts(x, group)
    lead = xq.shape[:-1]
    y = tp.reduce_int(int_mm(xq.reshape(-1, xq.shape[-1]), p["kernel_q"]),
                      group)
    y = y.reshape(*lead, -1).float() * xs * p["kernel_scale"]
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def quantize_dense(p: Params, group=None) -> Params:
    """{kernel, bias?} -> {kernel_q, kernel_scale, bias?} (stacked [L, i, o]
    kernels quantize per (layer, output channel)); ``group`` for a
    row-parallel shard."""
    q, s = quantize_weight(p["kernel"], group=group)
    out = {"kernel_q": output_major(q), "kernel_scale": s}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


# the dense subtrees whose contraction is sharded under tensor parallelism
ROW_PARALLEL = ("out", "fc2")


def map_encoder_dense(layers: Params, fn, group=None) -> Params:
    """Apply ``fn(p, group)`` to every quantizable dense subtree of an
    encoder layer stack (self-attention q/k/v/out, fc1/fc2): the encoder's
    quantization scope.  ``group`` (the model group of a sharded tree)
    reaches the row-parallel ones only."""
    out = dict(layers)
    out["self_attn"] = {name: fn(layers["self_attn"][name],
                                 group if name in ROW_PARALLEL else None)
                        for name in ("q", "k", "v", "out")}
    for name in ("fc1", "fc2"):
        out[name] = fn(layers[name], group if name in ROW_PARALLEL else None)
    return out


def map_decoder_dense(layers: Params, fn, group=None) -> Params:
    """Apply ``fn(p, group)`` to every quantizable dense subtree of a
    decoder layer stack (self/cross-attention q/k/v/out, fc1/fc2), as
    :func:`map_encoder_dense`."""
    out = dict(layers)
    for attn in ("self_attn", "cross_attn"):
        out[attn] = {name: fn(layers[attn][name],
                              group if name in ROW_PARALLEL else None)
                     for name in ("q", "k", "v", "out")}
    for name in ("fc1", "fc2"):
        out[name] = fn(layers[name], group if name in ROW_PARALLEL else None)
    return out


def layers_group(layers: Params):
    """The model group a layer stack is sharded over (None: unsharded);
    raises where its int8 MLP would split a requantization chunk."""
    group = tp.group_of(layers["self_attn"]["q"])
    if group is not None:
        from .int8_mlp import check_whole_chunks
        fc1 = layers["fc1"]
        f = (fc1["kernel"] if "kernel" in fc1 else fc1["kernel_q"]).shape[-1]
        check_whole_chunks(f * tp.size(group), tp.size(group))
    return group


def quantize_encoder_params(enc: Params) -> Params:
    """Encoder subtree -> int8 projection and MLP weights (the conv stem,
    LayerNorms and positions stay as they are).  Idempotent."""
    if "kernel_q" in enc["layers"]["fc1"]:
        return enc
    out = dict(enc)
    out["layers"] = map_encoder_dense(enc["layers"], quantize_dense,
                                      layers_group(enc["layers"]))
    return out


def quantize_decoder_params(dec: Params) -> Params:
    """Decoder subtree -> int8 projection and MLP weights (embeddings and
    LayerNorms stay as they are).  Idempotent."""
    if "kernel_q" in dec["layers"]["fc1"]:
        return dec
    out = dict(dec)
    out["layers"] = map_decoder_dense(dec["layers"], quantize_dense,
                                      layers_group(dec["layers"]))
    return out


def quantize_lm_head_params(dec: Params) -> Params:
    """Add an int8 copy of the tied token embedding used only for the output
    logits (``tok_emb_q [V, D]``, per-vocab-row scale ``tok_emb_scale
    [V, 1]``); the input lookup keeps the exact table.  Idempotent."""
    if "tok_emb_q" in dec:
        return dec
    q, s = quantize_weight(dec["tok_emb"], contract_axis=-1)
    out = dict(dec)
    out["tok_emb_q"] = q
    out["tok_emb_scale"] = s
    return out


def quantize_teacher_params(teacher: Params) -> Params:
    """Full-tree int8 quantization of a teacher for ``--teacher_precision
    int8``: the encoder and decoder projections and MLPs; the tied
    embedding (the lm head) stays exact, since it gives the KL target
    logits."""
    return {**teacher,
            "encoder": quantize_encoder_params(teacher["encoder"]),
            "decoder": quantize_decoder_params(teacher["decoder"])}


def maybe_quantize_encoder(params: Params, cfg) -> Params:
    """Full param tree -> int8 encoder / decoder / lm head per the cfg flags.
    The forward path picks the int8 weights up by tree structure
    (``kernel_q`` in ``models.whisper.dense`` and ``fused_self_attention``,
    ``tok_emb_q`` in ``decode``)."""
    if getattr(cfg, "quantize_encoder", False):
        params = {**params,
                  "encoder": quantize_encoder_params(params["encoder"])}
    if getattr(cfg, "quantize_decoder", False):
        params = {**params,
                  "decoder": quantize_decoder_params(params["decoder"])}
    if getattr(cfg, "quantize_lm_head", False):
        params = {**params,
                  "decoder": quantize_lm_head_params(params["decoder"])}
    return params
