"""Whisper encoder-decoder in PyTorch.

Counterpart of ``distil_whisper_tpu.models.whisper`` with the same parameter
tree (stacked ``[L, ...]`` layer weights, ``kernel [in, out]``), the same
numerics policy (fp32 LayerNorm statistics and softmax, fp32 accumulation in
every product, bf16 elsewhere in bf16 runs) and the same static-shape
decoder cache ``[L, B, T, H*hd]`` with heads merged.  The layer loop is a
Python loop over views of the stacked weights.  The decoder cache is
updated in place (the JAX function returns a new cache; here the returned
cache is the same dict, written at ``pos_offset``), which saves a copy of
the cache per step.

The int8 lane follows the tree as JAX does: ``kernel_q`` leaves take the
W8A8 product (``ops/quant.py``), the encoder MLP takes the fused int8 kernel
(``ops/int8_mlp.py``) on the card, int8 self-KV caches and cross K/V carry
fp32 scales beside them and are dequantized per layer to the working dtype,
and ``tok_emb_q`` gives int8 logits at batch >= 8.

Tensor parallelism over the mesh's 'model' axis (JAX: GSPMD over the same
tree): on a tree sharded by ``parallel.shard_params`` each rank holds
``heads / tp`` heads and ``ffn / tp`` MLP columns.  Head counts and cache
widths come from the local shapes; the q/k/v and fc1 products are
column-parallel, the out-projections and fc2 row-parallel, their partials
summed over the model group in fp32 before the cast and the bias
(``parallel/tensor_parallel.py``).  The int8 scales whose reduction axis
is sharded (a row-parallel input's row absmax, the self-KV cache's token
absmax) take the group's max, so a sharded run computes the unsharded
function; dropout draws the unsharded masks and keeps the rank's columns.

2-D (FSDP-style) sharding over the mesh's 'data' axis (``RULES_2D``): a
leaf's 'embed' dimension holds ``d_model / dp`` columns, and each layer's
leaves are all-gathered where the layer is taken (inside the remat
boundary, so the recompute gathers again), the other leaves where they are
read (``parallel/fsdp.py``); the products then see the 1-D shards.  The
tensor-parallel degree is read from the q kernel's output width against
``cfg.d_model``, which 'data' never splits.

:func:`cross_attention_probs` yields the fp32 cross-attention
probabilities of a teacher-forced pass layer by layer (DTW word timestamps).

:func:`decode` also takes per-lane cursors: ``pos_offset`` as a [B] tensor,
each lane writing, reading and masking at its own slots (speculative
decoding, whose lanes accept different numbers of tokens a round), together
with ``pad_len`` if its prompts are left-padded.

The training path: :func:`forward` (encoder + teacher-forced decoder),
``output_hidden_states`` ([L+1, B, T, d], the embedding output and every
layer's output, HF's convention), ``freeze`` (the encoder's output takes no
gradient), the decoder's padding ``attention_mask`` combined with
causality, ``skip_logits`` (the chunked loss projects per chunk), inverted
dropout at the config's rates drawn from an explicit ``torch.Generator``,
and remat: ``torch.utils.checkpoint`` around each layer.  Each layer draws
its dropout masks from a generator of its own, seeded from the caller's, so
that a rematerialised layer draws the same masks again.  The encoder's
sinusoidal positions take no gradient, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import WhisperConfig
from ..ops.attention import mha, causal_mask, decode_attention
from ..ops.encoder_attention import fused_self_attention
from ..ops.int8_mlp import fused_int8_mlp, mlp_supported
from ..ops.qat import ACT_FQ_KEY, fake_quant_acts
from ..ops.quant import dense_int8, int_mm, quantize_acts, symmetric_int8
from ..parallel import fsdp
from ..parallel import tensor_parallel as tp
from .params import layer_slice

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# Primitives
# ----------------------------------------------------------------------


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5,
               fp32: bool = True) -> torch.Tensor:
    """LayerNorm with fp32 internals, output in x.dtype.  ``fp32=False``
    keeps the statistics in x.dtype (``fast_approx_activations``).

    PyTorch's layer-norm kernel computes in fp32 for bf16 input (statistics,
    normalisation and affine) and casts once at the end: the JAX package's
    fp32 island in one pass."""
    scale, bias = p["scale"].to(x.dtype), p["bias"].to(x.dtype)
    if fp32:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], group=None) -> torch.Tensor:
    """Inverted dropout; the identity when ``rate`` is 0 or there is no
    generator (inference).  ``group``: ``x`` holds this rank's columns of
    a column-parallel activation, masked as its slice of the unsharded
    draw."""
    if rate == 0.0 or generator is None:
        return x
    u = tp.rand_shard(x.shape, x.dim() - 1, group, generator, x.device)
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _layer_seeds(generator: Optional[torch.Generator], n: int) -> List:
    """One seed a layer, drawn from ``generator`` (None without one)."""
    if generator is None:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def _generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _layer(params: Params, i: int, root: str, d_model: int,
           gathered: bool) -> Params:
    """Layer ``i`` of ``params["layers"]`` (views); ``gathered``: the tree
    is sliced over 'data', and the layer's leaves are all-gathered (a
    decoder layer's but for its cross-attention K/V projections, which
    :func:`cross_kv` applies once an utterance)."""
    lp = layer_slice(params["layers"], i)
    if gathered:
        if "cross_attn" in lp:
            lp = {**lp, "cross_attn": {k: v for k, v in
                                       lp["cross_attn"].items()
                                       if k not in ("k", "v")}}
        lp = fsdp.gather_tree(lp, f"{root}.layers", d_model, sliced=True)
    return lp


def _leaf(params: Params, name: str, root: str, d_model: int) -> Any:
    """``params[name]`` (a leaf or a {kernel, bias} / LayerNorm subtree of
    a top-level module), gathered over 'data' where it is sliced."""
    x = params[name]
    if isinstance(x, dict):
        return fsdp.gather_tree(x, f"{root}.{name}", d_model)
    return fsdp.gather_leaf(x, f"{root}.{name}", d_model)


def _run_layer(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat``: the
    layer's activations are recomputed in the backward (JAX:
    ``jax.checkpoint`` around the scanned layer)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def dense(p: Params, x: torch.Tensor, group=None) -> torch.Tensor:
    """x @ kernel with fp32 accumulation, cast to x.dtype, then the bias added
    in x.dtype.  ``group``: a row-parallel product over the model group
    (``x`` is this rank's slice of the contraction)."""
    if "kernel_q" in p:
        # int8 weights (ops/quant.py): W8A8 product, fp32 rescale epilogue
        return dense_int8(p, x, group=group)
    if ACT_FQ_KEY in p:
        # QAT w8a8 (ops/qat.py): the kernel is fake-quantized by the tree
        # transform; the input is fake-quantized here, so the training
        # forward runs the int8 serving numerics
        x = fake_quant_acts(x, group)
    y = tp.matmul(x, p["kernel"], group)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_heads, d // n_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)


def attention_block(p: Params, x_q: torch.Tensor, x_kv: torch.Tensor,
                    n_heads: int, mask=None, f32_attn: bool = True,
                    attn_dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    group=None) -> torch.Tensor:
    """Full (uncached) MHA: project, attend, output-project.  ``n_heads``
    are this rank's under tensor parallelism over ``group``."""
    same = x_kv is x_q
    x_q = tp.copy_to(x_q, group)
    x_kv = x_q if same else tp.copy_to(x_kv, group)
    q = _split_heads(dense(p["q"], x_q), n_heads)
    k = _split_heads(dense(p["k"], x_kv), n_heads)
    v = _split_heads(dense(p["v"], x_kv), n_heads)
    return dense(p["out"], _merge_heads(
        mha(q, k, v, mask, float32_logits=f32_attn,
            dropout_rate=attn_dropout, generator=generator,
            dropout_group=group)), group)


def mlp_block(fc1: Params, fc2: Params, x: torch.Tensor,
              exact_gelu: bool = True, act_dropout: float = 0.0,
              generator: Optional[torch.Generator] = None,
              group=None) -> torch.Tensor:
    if ("kernel_q" in fc1 and exact_gelu and act_dropout == 0.0 and x.is_cuda
            and x.dtype == torch.bfloat16 and mlp_supported(fc1, x)):
        # the fused int8 MLP kernel (ops/int8_mlp.py), JAX's choice on the
        # TPU; elsewhere (CPU, fp32, decode-sized row counts) the unfused
        # dense_int8 -> gelu -> dense_int8, JAX's choice off the TPU
        if group is None:
            return fused_int8_mlp(fc1, fc2, x)
        # row-parallel fc2: the kernel's fp32 partials, summed, then the
        # bias once, as the kernel's own epilogue adds it
        y = tp.reduce_sum(fused_int8_mlp(fc1, fc2, x, partial=True), group)
        if "bias" in fc2:
            y = y + fc2["bias"].float()
        return y.to(x.dtype)
    x = tp.copy_to(x, group)
    h = F.gelu(dense(fc1, x), approximate="none" if exact_gelu else "tanh")
    return dense(fc2, dropout(h, act_dropout, generator, group), group)


# ----------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------


def _conv1d(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x [B, T, C_in], kernel (3, C_in, C_out), SAME-1 padding like torch.

    The three taps are concatenated along channels and multiplied by the
    kernel reshaped to [3*C_in, C_out]: one product whose fp32 accumulation
    runs over all taps before the single cast, as the JAX 3-tap sum does."""
    k = p["kernel"].to(x.dtype)
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1))
    taps = torch.cat([xp[:, d:d + t:stride] for d in range(3)], dim=-1)
    y = torch.matmul(taps, k.reshape(-1, k.shape[-1]))
    return y + p["bias"].to(x.dtype)


def _encoder_layer(lp: Params, x: torch.Tensor, n_heads: int,
                   policy=(True, False, False),
                   t_real: Optional[int] = None,
                   rates=(0.0, 0.0, 0.0), seed: Optional[int] = None,
                   group=None) -> torch.Tensor:
    f32_attn, fast_act, use_fused = policy
    drop, attn_drop, act_drop = rates
    gen = _generator(seed, x.device)
    r = x
    x = layer_norm(lp["self_attn_ln"], x, fp32=not fast_act)
    if use_fused:
        # Hand-written kernel (ops/encoder_attention.py): never writes the
        # [B,H,T,T] logits; q/k/v are [B,H,T,D] views of the projections.
        x = fused_self_attention(lp["self_attn"], x, n_heads,
                                 t_real or x.shape[1], group)
    else:
        x = attention_block(lp["self_attn"], x, x, n_heads, f32_attn=f32_attn,
                            attn_dropout=attn_drop, generator=gen,
                            group=group)
    x = r + dropout(x, drop, gen)
    r = x
    x = layer_norm(lp["final_ln"], x, fp32=not fast_act)
    x = mlp_block(lp["fc1"], lp["fc2"], x, exact_gelu=not fast_act,
                  act_dropout=act_drop, generator=gen, group=group)
    return r + dropout(x, drop, gen)


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
           dtype: torch.dtype = torch.float32, remat: bool = False,
           output_hidden_states: bool = False, freeze: bool = False,
           generator: Optional[torch.Generator] = None):
    """mel [B, n_mels, 3000] -> encoder states [B, 1500, d].

    With ``cfg.use_flash_encoder`` self-attention goes through the kernel, which
    takes T = 1500 as it is (the JAX package pads to 1536 for its block
    grid and slices back; the output is the same).  The kernel is skipped
    when attention dropout is on, as in JAX.

    ``output_hidden_states`` also returns [L+1, B, 1500, d] (the embedding
    output and every layer's output, the last after ``ln_post``);
    ``freeze`` detaches the output; ``generator`` turns on the config's
    dropout rates (training); ``remat`` recomputes each layer in the
    backward."""
    rates = (cfg.dropout, cfg.attention_dropout, cfg.activation_dropout)
    use_dropout = generator is not None and any(r > 0 for r in rates)
    d = cfg.d_model
    x = mel.to(dtype).transpose(1, 2)                        # [B, 3000, n_mels]
    x = F.gelu(_conv1d(_leaf(params, "conv1", "encoder", d), x, 1))
    x = F.gelu(_conv1d(_leaf(params, "conv2", "encoder", d), x, 2))
    # sinusoidal positions are constants, never trained
    x = x + fsdp.gather_leaf(params["pos_emb"].detach(), "encoder.pos_emb",
                             d).to(dtype)
    use_fused = cfg.use_flash_encoder and not (
        use_dropout and cfg.attention_dropout > 0)
    policy = (not cfg.fast_bf16_attention, cfg.fast_approx_activations,
              use_fused)
    if use_dropout:
        seeds = _layer_seeds(generator, cfg.encoder_layers + 1)
        x = dropout(x, cfg.dropout, _generator(seeds.pop(), x.device))
    else:
        rates, seeds = (0.0, 0.0, 0.0), [None] * cfg.encoder_layers
    q = params["layers"]["self_attn"]["q"]
    group = tp.group_of(q, d)
    gathered = fsdp.is_sharded(q, d)
    n_heads = cfg.encoder_attention_heads // tp.size(group)
    hs = []
    for i in range(cfg.encoder_layers):
        if output_hidden_states:
            hs.append(x)
        x = _run_layer(
            lambda h, i=i, seed=seeds[i]: _encoder_layer(
                _layer(params, i, "encoder", d, gathered), h, n_heads,
                policy, h.shape[1], rates, seed, group),
            remat, x)
    y = layer_norm(_leaf(params, "ln_post", "encoder", d), x)
    if freeze:
        y = y.detach()
    if output_hidden_states:
        return y, torch.stack(hs + [y])
    return y


# ----------------------------------------------------------------------
# Decoder (shared path for training, prefill and cached decode)
# ----------------------------------------------------------------------


def kv_width(dec: Params) -> int:
    """The width of a decoder's self-attention K/V on this rank: d_model,
    or d_model / tp on a tree sharded over the model axis."""
    k = dec["layers"]["self_attn"]["k"]
    return (k["kernel"] if "kernel" in k else k["kernel_q"]).shape[-1]


def init_cache(cfg: WhisperConfig, batch: int,
               dtype: torch.dtype = torch.float32,
               max_len: Optional[int] = None, device="cpu",
               width: Optional[int] = None) -> Params:
    """Static-shape self-attention KV cache: [L, B, max_len, H*hd], heads
    merged (a [.., T, H, hd] view of it is free).  ``width``: this rank's
    H*hd under tensor parallelism (:func:`kv_width` of the decoder),
    d_model by default.

    With ``cfg.quantize_self_kv`` K/V are stored int8 (``k_q``, ``v_q``)
    with an fp32 absmax scale per (layer, batch, token) (``k_scale``,
    ``v_scale`` [L, B, max_len])."""
    max_len = max_len or cfg.max_target_positions
    shape = (cfg.decoder_layers, batch, max_len, width or cfg.d_model)
    if cfg.quantize_self_kv:
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _self_kv_quantize(x: torch.Tensor, group=None):
    """[B, S, d] -> (int8 [B, S, d], fp32 scale [B, S]), per-token absmax
    (over every head: the model group's max of the ranks' heads) with the
    scale floor 1e-8."""
    x32 = x.float()
    amax = tp.max_over(x32.abs().amax(dim=-1, keepdim=True), group)
    q, scale = symmetric_int8(x32, amax, 1e-8)
    return q, scale[..., 0]


def _cache_write(cache: Params, name: str, i: int, pos,
                 kv: torch.Tensor, group=None) -> None:
    """Write new K or V [B, S, d] of layer ``i`` at ``pos``, in place.

    ``pos`` is an int (every row at slots ``pos .. pos+S-1``) or a [B]
    tensor (row ``b`` at ``pos[b] .. pos[b]+S-1``, one indexed write for
    all rows).  A write past the cache's end raises: the int slice no
    longer matches the shape, an index past the end fails the indexed
    write (an error on the CPU, a device-side assert on the card).  It is
    never clamped onto earlier slots."""
    s = kv.shape[1]
    if not isinstance(pos, torch.Tensor):
        rows, slots = slice(None), slice(pos, pos + s)
    else:
        rows = torch.arange(kv.shape[0], device=kv.device)[:, None]
        slots = pos.long()[:, None] + torch.arange(s, device=kv.device)
    if name in cache:
        cache[name][i][rows, slots] = kv.to(cache[name].dtype)
        return
    q, scale = _self_kv_quantize(kv, group)
    cache[f"{name}_q"][i][rows, slots] = q
    cache[f"{name}_scale"][i][rows, slots] = scale


def _cache_read(cache: Params, name: str, i: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Layer ``i``'s whole K or V as merged [B, T, d] in ``dtype``; an int8
    cache is dequantized with the scale cast to ``dtype`` first, as JAX."""
    if name in cache:
        return cache[name][i].to(dtype)
    return (cache[f"{name}_q"][i].to(dtype)
            * cache[f"{name}_scale"][i][..., None].to(dtype))


def cross_kv(params: Params, cfg: WhisperConfig,
             enc: torch.Tensor) -> Params:
    """Cross-attention K/V, computed once per utterance: [L, B, 1500, H*hd].

    With ``cfg.quantize_cross_kv`` K/V are stored int8 with an fp32 absmax
    scale per (layer, batch, head), kept as a [B, 1, d] vector so that the
    dequant is one elementwise multiply; each layer is quantized as it is
    projected.  On a sharded tree: this rank's heads, [L, B, 1500, d/tp]."""
    k = params["layers"]["cross_attn"]["k"]
    group = tp.group_of(k, cfg.d_model)
    gathered = fsdp.is_sharded(k, cfg.d_model)
    h = cfg.decoder_attention_heads // tp.size(group)
    quantize = cfg.quantize_cross_kv
    enc = tp.copy_to(enc, group)

    def q8(x):
        b, t, d = x.shape
        x32 = x.float()
        amax = x32.abs().view(b, t, h, d // h).amax(dim=(1, 3))      # [B, H]
        amax = amax.repeat_interleave(d // h, dim=-1)[:, None]        # [B,1,d]
        return symmetric_int8(x32, amax, 1e-8)

    # each layer's K/V written into the stacked output as it is projected:
    # never every layer's parts and their stack at once (twice the bytes,
    # which a captured prefill would keep in its pool)
    names = ("k_q", "k_scale", "v_q", "v_scale") if quantize else ("k", "v")
    out: Params = {}
    for i in range(cfg.decoder_layers):
        lp = layer_slice(params["layers"], i)["cross_attn"]
        if gathered:    # the K/V projections only
            lp = fsdp.gather_tree({n: lp[n] for n in ("k", "v")},
                                  "decoder.layers.cross_attn", cfg.d_model,
                                  sliced=True)
        k, v = dense(lp["k"], enc), dense(lp["v"], enc)
        part = (*q8(k), *q8(v)) if quantize else (k, v)
        for n, x in zip(names, part):
            if n not in out:
                out[n] = x.new_empty((cfg.decoder_layers, *x.shape))
            out[n][i] = x
    return out


def _cross_read(cross: Params, i: int, dtype: torch.dtype):
    """Layer ``i``'s cross K and V as merged [B, T, d] in ``dtype``."""
    if "k" in cross:
        return cross["k"][i].to(dtype), cross["v"][i].to(dtype)
    return (cross["k_q"][i].to(dtype) * cross["k_scale"][i].to(dtype),
            cross["v_q"][i].to(dtype) * cross["v_scale"][i].to(dtype))


def _int8_logits(params: Params, y: torch.Tensor) -> torch.Tensor:
    """W8A8 logits against the int8 copy of the tied embedding: per-token
    activation scale, per-vocab-row weight scale, fp32 rescale, as JAX.

    The vocabulary is the left (row) operand of the int8 product and the
    b*s tokens the right one: cuBLASLt asks the right operand's width to be
    a multiple of 8, which 51866 is not, so the tokens are padded with zero
    rows to a multiple of 8 instead of padding the vocabulary."""
    b, s, d = y.shape
    m = b * s
    yq, ys = quantize_acts(y.reshape(m, d))
    m8 = -(-m // 8) * 8
    if m8 != m:
        yq = torch.cat([yq, yq.new_zeros(m8 - m, d)])
    lt = int_mm(params["tok_emb_q"], yq.T)[:, :m]                 # [V, m]
    logits = lt.T.float() * ys * params["tok_emb_scale"][:, 0]
    return logits.reshape(b, s, -1)


def _decoder_layer(lp: Params, x: torch.Tensor, self_k, self_v, ck, cv,
                   n_heads: int, self_mask, policy=(True, False),
                   output_cross_probs: bool = False,
                   rates=(0.0, 0.0, 0.0),
                   generator: Optional[torch.Generator] = None, group=None):
    """One decoder layer given head-split K/V for both attentions; with
    ``output_cross_probs`` returns ``(y, fp32 cross-attention probs
    [B, H, S, Tk])`` (this rank's heads under tensor parallelism)."""
    f32_attn, fast_act = policy
    drop, attn_drop, act_drop = rates
    r = x
    h = tp.copy_to(layer_norm(lp["self_attn_ln"], x, fp32=not fast_act),
                   group)
    q = _split_heads(dense(lp["self_attn"]["q"], h), n_heads)
    a = mha(q, self_k, self_v, self_mask, float32_logits=f32_attn,
            dropout_rate=attn_drop, generator=generator, dropout_group=group)
    x = r + dropout(dense(lp["self_attn"]["out"], _merge_heads(a), group),
                    drop, generator)

    r = x
    h = tp.copy_to(layer_norm(lp["cross_attn_ln"], x, fp32=not fast_act),
                   group)
    q = _split_heads(dense(lp["cross_attn"]["q"], h), n_heads)
    a = mha(q, ck, cv, float32_logits=f32_attn,
            return_probs=output_cross_probs, dropout_rate=attn_drop,
            generator=generator, dropout_group=group)
    if output_cross_probs:
        a, cross_probs = a
    x = r + dropout(dense(lp["cross_attn"]["out"], _merge_heads(a), group),
                    drop, generator)

    r = x
    h = layer_norm(lp["final_ln"], x, fp32=not fast_act)
    h = mlp_block(lp["fc1"], lp["fc2"], h, exact_gelu=not fast_act,
                  act_dropout=act_drop, generator=generator, group=group)
    y = r + dropout(h, drop, generator)
    return (y, cross_probs) if output_cross_probs else y


def _cached_layer(lp: Params, x: torch.Tensor, h: torch.Tensor, k_all, v_all,
                  ck, cv, n_heads: int, self_mask, mask2, merged_fast: bool,
                  policy, group=None):
    """One decoder layer against merged-layout K/V [B, T, d]; ``h`` is the
    self-attention LayerNorm of ``x`` (already computed for the new K/V)."""
    f32_attn, fast_act = policy
    r = x
    q = dense(lp["self_attn"]["q"], h)
    if merged_fast:
        a = decode_attention(q[:, 0], k_all, v_all, n_heads, mask2)[:, None]
    else:
        a = _merge_heads(mha(_split_heads(q, n_heads),
                             _split_heads(k_all, n_heads),
                             _split_heads(v_all, n_heads),
                             self_mask, float32_logits=f32_attn))
    x = r + dense(lp["self_attn"]["out"], a, group)

    r = x
    h = layer_norm(lp["cross_attn_ln"], x, fp32=not fast_act)
    q = dense(lp["cross_attn"]["q"], h)
    if merged_fast:
        a = decode_attention(q[:, 0], ck, cv, n_heads)[:, None]
    else:
        a = _merge_heads(mha(_split_heads(q, n_heads), _split_heads(ck, n_heads),
                             _split_heads(cv, n_heads),
                             float32_logits=f32_attn))
    x = r + dense(lp["cross_attn"]["out"], a, group)

    r = x
    h = layer_norm(lp["final_ln"], x, fp32=not fast_act)
    return r + mlp_block(lp["fc1"], lp["fc2"], h, exact_gelu=not fast_act,
                         group=group)


def decode(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
           enc: Optional[torch.Tensor] = None,
           cross: Optional[Params] = None,
           cache: Optional[Params] = None,
           pos_offset=0,
           pad_len: Optional[torch.Tensor] = None,
           dtype: torch.dtype = torch.float32,
           attention_mask: Optional[torch.Tensor] = None,
           remat: bool = False, output_hidden_states: bool = False,
           generator: Optional[torch.Generator] = None,
           skip_logits: bool = False):
    """Decoder forward.

    tokens [B, S] at global cache slots ``pos_offset .. pos_offset+S-1``.
    Exactly one of ``enc`` (encoder states, K/V projected on the fly) or
    ``cross`` (precomputed by :func:`cross_kv`).

    ``pos_offset`` is a Python int, or a [B] integer tensor of per-lane
    cursors: lane ``b``'s tokens then sit at slots ``pos_offset[b] ..
    pos_offset[b]+S-1``, where they are written into the cache, and they
    attend up to their own slot.  Uniform per-lane cursors give the int
    cursor's logits bit for bit.

    Without ``cache``: full causal self-attention over S (scoring path).
    With ``cache``: the new
    keys/values are written into the cache at ``pos_offset`` (in place) and
    attention spans the whole cache under a causal mask.

    ``pad_len`` [B] marks left-padded prompts: the first ``pad_len[b]`` cache
    slots are masked out of self-attention and positions shift so the first
    real token sits at position 0.  It combines with per-lane cursors (the
    JAX package never passes both, since ``jax.vmap`` gives each lane a
    scalar cursor; a batched speculative rung on left-padded prompts needs
    both): lane ``b``'s token ``j`` takes position ``clamp(pos_offset[b] + j
    - pad_len[b], 0, max_target_positions - 1)`` and sees key slots ``k``
    with ``pad_len[b] <= k <= pos_offset[b] + j``.

    Training (uncached) only: ``attention_mask`` [B, S] is a padding mask
    of the keys combined with causality; ``generator`` turns on the
    config's dropout rates; ``remat`` recomputes each layer in the backward.

    Returns ``(logits [B, S, V] fp32, cache)``; ``cache`` is None uncached.
    With ``skip_logits`` the first item is the final-LayerNorm hidden state
    [B, S, d] instead (the chunked loss projects it per chunk); with
    ``output_hidden_states`` a third item, [L+1, B, S, d]: the embedding
    output and every layer's output, the last after the final LayerNorm.
    """
    b, s = tokens.shape
    d = cfg.d_model
    q = params["layers"]["self_attn"]["q"]
    group = tp.group_of(q, d)
    gathered = fsdp.is_sharded(q, d)
    n_heads = cfg.decoder_attention_heads // tp.size(group)
    device = tokens.device
    pos_table = _leaf(params, "pos_emb", "decoder", d).to(dtype)
    tok_emb = _leaf(params, "tok_emb", "decoder", d)
    x = tok_emb.to(dtype)[tokens]
    per_lane = isinstance(pos_offset, torch.Tensor)
    if pad_len is None and not per_lane:
        start = min(max(pos_offset, 0), pos_table.shape[0] - s)
        x = x + pos_table[start:start + s]
    else:
        base = pos_offset.long()[:, None] if per_lane else pos_offset
        slots = base + torch.arange(s, device=device)[None, :]
        if pad_len is not None:
            slots = slots - pad_len[:, None].long()
        positions = torch.clamp(slots, 0, cfg.max_target_positions - 1)
        x = x + pos_table[positions]

    if cache is not None:
        tk = (cache["k"] if "k" in cache else cache["k_q"]).shape[2]
        self_mask = causal_mask(s, tk, pos_offset, device=device)
    else:
        if per_lane:
            raise ValueError("per-lane cursors need a cache")
        tk = s
        self_mask = causal_mask(s, s, 0, device=device)
    if pad_len is not None:
        key_slots = torch.arange(tk, device=device)[None, None, None, :]
        self_mask = self_mask & (key_slots >= pad_len[:, None, None, None])
    if attention_mask is not None:
        self_mask = self_mask & attention_mask[:, None, None, :].bool()

    policy = (not cfg.fast_bf16_attention, cfg.fast_approx_activations)
    f32_attn, fast_act = policy
    if cross is None:
        if enc is None:
            raise ValueError("decode() needs enc or cross")
        cross = cross_kv(params, cfg, enc.to(dtype))
    # bf16 single-token steps use the merged-layout decode_attention; prefill
    # (S>1) and fp32-parity runs take the exact einsum path on head-split
    # views of the same buffers
    merged_fast = cache is not None and s == 1 and not f32_attn
    mask2 = self_mask[:, 0, 0, :] if merged_fast else None

    rates = (cfg.dropout, cfg.attention_dropout, cfg.activation_dropout)
    if cache is None and generator is not None and any(r > 0 for r in rates):
        seeds = _layer_seeds(generator, cfg.decoder_layers + 1)
        x = dropout(x, cfg.dropout, _generator(seeds.pop(), device))
    else:
        rates, seeds = (0.0, 0.0, 0.0), [None] * cfg.decoder_layers

    def uncached_layer(x, i, ck, cv, seed):
        lp = _layer(params, i, "decoder", d, gathered)
        h = tp.copy_to(layer_norm(lp["self_attn_ln"], x, fp32=not fast_act),
                       group)
        k = _split_heads(dense(lp["self_attn"]["k"], h), n_heads)
        v = _split_heads(dense(lp["self_attn"]["v"], h), n_heads)
        return _decoder_layer(lp, x, k, v, _split_heads(ck, n_heads),
                              _split_heads(cv, n_heads), n_heads, self_mask,
                              policy, rates=rates,
                              generator=_generator(seed, device), group=group)

    hs = []
    for i in range(cfg.decoder_layers):
        if output_hidden_states:
            hs.append(x)
        ck, cv = _cross_read(cross, i, dtype)
        if cache is None:
            x = _run_layer(uncached_layer, remat, x, i, ck, cv, seeds[i])
            continue
        lp = _layer(params, i, "decoder", d, gathered)
        h = layer_norm(lp["self_attn_ln"], x, fp32=not fast_act)
        _cache_write(cache, "k", i, pos_offset, dense(lp["self_attn"]["k"], h),
                     group)
        _cache_write(cache, "v", i, pos_offset, dense(lp["self_attn"]["v"], h),
                     group)
        x = _cached_layer(lp, x, h, _cache_read(cache, "k", i, dtype),
                          _cache_read(cache, "v", i, dtype), ck, cv,
                          n_heads, self_mask, mask2, merged_fast, policy,
                          group)

    y = layer_norm(_leaf(params, "ln", "decoder", d), x)
    if skip_logits:
        logits = y
    elif "tok_emb_q" in params and b >= 8:
        # int8 logits (cfg.quantize_lm_head), gated on the batch as in JAX
        # so that prefill and steps of one generation share numerics
        logits = _int8_logits(params, y)
    else:
        # fp32 logits (the tied embedding in the working dtype, fp32
        # accumulation) as in JAX
        logits = torch.matmul(y.float(), tok_emb.to(dtype).float().T)
    if output_hidden_states:
        return logits, cache, torch.stack(hs + [y])
    return logits, cache


def cross_attention_probs(params: Params, cfg: WhisperConfig,
                          tokens: torch.Tensor,
                          enc: Optional[torch.Tensor] = None,
                          cross: Optional[Params] = None,
                          dtype: torch.dtype = torch.float32,
                          ) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(layer, fp32 cross-attention probabilities [B, H, S, Tk])`` of a
    teacher-forced decoder pass over ``tokens`` [B, S], one layer at a time,
    so that a caller can keep a few heads and stop after the last layer it
    needs.

    Cross-attention rows depend only on the decoder state at their own
    position, so this one pass gives the per-step cross-attentions that
    cached generation sees (the input of the DTW word-timestamp alignment).
    Under tensor parallelism every head's, gathered over the model group.
    """
    b, s = tokens.shape
    d = cfg.d_model
    q = params["layers"]["self_attn"]["q"]
    group = tp.group_of(q, d)
    gathered = fsdp.is_sharded(q, d)
    n_heads = cfg.decoder_attention_heads // tp.size(group)
    x = _leaf(params, "tok_emb", "decoder", d).to(dtype)[tokens.long()]
    x = x + _leaf(params, "pos_emb", "decoder", d).to(dtype)[:s]
    if cross is None:
        if enc is None:
            raise ValueError("cross_attention_probs() needs enc or cross")
        cross = cross_kv(params, cfg, enc.to(dtype))
    mask = causal_mask(s, s, 0, device=tokens.device)
    policy = (not cfg.fast_bf16_attention, cfg.fast_approx_activations)
    for i in range(cfg.decoder_layers):
        lp = _layer(params, i, "decoder", d, gathered)
        ck, cv = _cross_read(cross, i, dtype)
        h = layer_norm(lp["self_attn_ln"], x)
        k = _split_heads(dense(lp["self_attn"]["k"], h), n_heads)
        v = _split_heads(dense(lp["self_attn"]["v"], h), n_heads)
        x, probs = _decoder_layer(lp, x, k, v, _split_heads(ck, n_heads),
                                  _split_heads(cv, n_heads), n_heads, mask,
                                  policy, output_cross_probs=True,
                                  group=group)
        yield i, tp.all_gather(probs, 1, group)


def cross_attention_weights(params: Params, cfg: WhisperConfig,
                            tokens: torch.Tensor,
                            enc: Optional[torch.Tensor] = None,
                            cross: Optional[Params] = None,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """fp32 cross-attention probabilities [L, B, H, S, Tk] of a
    teacher-forced decoder pass over ``tokens`` [B, S] (every layer; the
    word-timestamp path keeps only its heads, through
    :func:`cross_attention_probs`)."""
    return torch.stack([p for _, p in cross_attention_probs(
        params, cfg, tokens, enc=enc, cross=cross, dtype=dtype)])


# ----------------------------------------------------------------------
# Full forward (training path)
# ----------------------------------------------------------------------


def forward(params: Params, cfg: WhisperConfig, mel: torch.Tensor,
            decoder_input_ids: torch.Tensor,
            decoder_attention_mask: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.float32, remat: bool = False,
            freeze_encoder: bool = False,
            output_hidden_states: bool = False,
            generator: Optional[torch.Generator] = None):
    """Encoder + teacher-forced decoder: ``(logits [B, S, V] fp32, aux)``.

    ``params`` is the full tree (``{'encoder': ..., 'decoder': ...}``);
    ``aux`` holds ``encoder_last_hidden_state`` and, with
    ``output_hidden_states``, ``encoder_hidden_states`` and
    ``decoder_hidden_states`` ([L+1, B, T, d] each)."""
    enc_out = encode(params["encoder"], cfg, mel, dtype=dtype, remat=remat,
                     output_hidden_states=output_hidden_states,
                     freeze=freeze_encoder, generator=generator)
    enc = enc_out[0] if output_hidden_states else enc_out
    out = decode(params["decoder"], cfg, decoder_input_ids, enc=enc,
                 attention_mask=decoder_attention_mask, dtype=dtype,
                 remat=remat, output_hidden_states=output_hidden_states,
                 generator=generator)
    aux = {"encoder_last_hidden_state": enc}
    if output_hidden_states:
        aux["encoder_hidden_states"] = enc_out[1]
        aux["decoder_hidden_states"] = out[2]
    return out[0], aux
