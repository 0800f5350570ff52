"""HF checkpoint <-> the port's param tree.

Loads ``model.safetensors`` (single or sharded) or ``pytorch_model.bin`` from
a local HF Whisper checkpoint directory into the stacked-layer layout of
:mod:`.whisper`, with the same key maps as ``distil_whisper_tpu.models.load_hf``,
and exports back (:func:`save_pretrained`: ``config.json`` and
``model.safetensors`` with the tied lm head as its own copy).  The
safetensors format is read and written here directly (an 8-byte header
length, a JSON header, raw little-endian buffers), so no ``safetensors``
package is needed.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..config import WhisperConfig
from ..device import resolve_device
from .params import tree_paths, unflatten_paths

Params = Dict[str, Any]

# (hf tail, ours tail, needs transpose) for linear/ln leaves inside a layer
_LAYER_MAP = [
    ("self_attn.q_proj.weight", "self_attn.q.kernel", True),
    ("self_attn.q_proj.bias", "self_attn.q.bias", False),
    ("self_attn.k_proj.weight", "self_attn.k.kernel", True),
    ("self_attn.k_proj.bias", "self_attn.k.bias", False),  # absent in Whisper
    ("self_attn.v_proj.weight", "self_attn.v.kernel", True),
    ("self_attn.v_proj.bias", "self_attn.v.bias", False),
    ("self_attn.out_proj.weight", "self_attn.out.kernel", True),
    ("self_attn.out_proj.bias", "self_attn.out.bias", False),
    ("self_attn_layer_norm.weight", "self_attn_ln.scale", False),
    ("self_attn_layer_norm.bias", "self_attn_ln.bias", False),
    ("encoder_attn.q_proj.weight", "cross_attn.q.kernel", True),
    ("encoder_attn.q_proj.bias", "cross_attn.q.bias", False),
    ("encoder_attn.k_proj.weight", "cross_attn.k.kernel", True),
    ("encoder_attn.k_proj.bias", "cross_attn.k.bias", False),
    ("encoder_attn.v_proj.weight", "cross_attn.v.kernel", True),
    ("encoder_attn.v_proj.bias", "cross_attn.v.bias", False),
    ("encoder_attn.out_proj.weight", "cross_attn.out.kernel", True),
    ("encoder_attn.out_proj.bias", "cross_attn.out.bias", False),
    ("encoder_attn_layer_norm.weight", "cross_attn_ln.scale", False),
    ("encoder_attn_layer_norm.bias", "cross_attn_ln.bias", False),
    ("fc1.weight", "fc1.kernel", True),
    ("fc1.bias", "fc1.bias", False),
    ("fc2.weight", "fc2.kernel", True),
    ("fc2.bias", "fc2.bias", False),
    ("final_layer_norm.weight", "final_ln.scale", False),
    ("final_layer_norm.bias", "final_ln.bias", False),
]

_TOP_MAP = [
    ("model.encoder.embed_positions.weight", "encoder.pos_emb"),
    ("model.encoder.layer_norm.weight", "encoder.ln_post.scale"),
    ("model.encoder.layer_norm.bias", "encoder.ln_post.bias"),
    ("model.decoder.embed_tokens.weight", "decoder.tok_emb"),
    ("model.decoder.embed_positions.weight", "decoder.pos_emb"),
    ("model.decoder.layer_norm.weight", "decoder.ln.scale"),
    ("model.decoder.layer_norm.bias", "decoder.ln.bias"),
]

_SAFETENSORS_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16",
                      torch.float16: "F16"}
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """All tensors of one ``.safetensors`` file as CPU tensors in their
    stored dtype (little-endian, as the format is): views of one buffer
    read at once, a tensor whose offset does not align with its dtype
    copied out."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(path.stat().st_size - 8 - n)
        f.readinto(data)
    buf = torch.frombuffer(data, dtype=torch.uint8) if data else None
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: unsupported safetensors dtype "
                             f"{info['dtype']} for {name}")
        begin, end = info["data_offsets"]
        raw = (buf[begin:end] if end > begin
               else torch.empty(0, dtype=torch.uint8))
        if begin % torch.empty((), dtype=dtype).element_size():
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def _read_state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """Read all tensors from a local HF checkpoint dir (CPU, stored
    dtypes)."""
    single = path / "model.safetensors"
    index = path / "model.safetensors.index.json"
    if single.exists():
        return read_safetensors(single)
    if index.exists():
        with open(index) as f:
            shard_names = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, torch.Tensor] = {}
        for name in shard_names:
            out.update(read_safetensors(path / name))
        return out
    torch_bin = path / "pytorch_model.bin"
    if torch_bin.exists():
        return torch.load(str(torch_bin), map_location="cpu",
                          weights_only=True)
    raise FileNotFoundError(f"no model.safetensors / pytorch_model.bin in {path}")


def params_from_state_dict(sd: Dict[str, Any], cfg: WhisperConfig,
                           device="cpu",
                           dtype: torch.dtype = torch.float32) -> Params:
    """HF state dict (tensors or numpy arrays) -> stacked param tree of
    tensors on ``device``: floating leaves moved in their stored dtype and
    cast to ``dtype`` there (a bf16 checkpoint crosses to the card in half
    the bytes of fp32; the values are the same as casting first)."""
    flat: Dict[str, torch.Tensor] = {}
    sd = {k.removeprefix("model."): torch.as_tensor(v) for k, v in sd.items()}
    for hf, ours in _TOP_MAP:
        hf = hf.removeprefix("model.")
        if hf in sd:
            flat[ours] = sd[hf]
    # conv stem: HF (out, in, k) -> (k, in, out)
    for name in ("conv1", "conv2"):
        flat[f"encoder.{name}.kernel"] = sd[f"encoder.{name}.weight"].permute(
            2, 1, 0)
        flat[f"encoder.{name}.bias"] = sd[f"encoder.{name}.bias"]
    for side, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        for hf_tail, our_tail, transpose in _LAYER_MAP:
            # Keys absent for a side are skipped wholesale: cross-attn in the
            # encoder, k_proj.bias everywhere (Whisper k has no bias).
            keys = [f"{side}.layers.{i}.{hf_tail}" for i in range(n_layers)]
            if not all(k in sd for k in keys):
                continue
            flat[f"{side}.layers.{our_tail}"] = torch.stack(
                [sd[k].T if transpose else sd[k] for k in keys])
    out = {}
    for path, t in flat.items():
        t = t.contiguous().to(device)
        out[path] = t.to(dtype) if t.is_floating_point() else t
    return unflatten_paths(out)


def load_params(checkpoint_dir: str, cfg: Optional[WhisperConfig] = None,
                dtype: torch.dtype = torch.float32, device="cuda"):
    """Load (params, cfg) from a local HF checkpoint directory onto
    ``device``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = WhisperConfig.from_pretrained(checkpoint_dir)
    sd = _read_state_dict(Path(checkpoint_dir))
    return params_from_state_dict(sd, cfg, dev, dtype), cfg


def write_safetensors(tensors: Dict[str, torch.Tensor], path: Path,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write CPU tensors as one ``.safetensors`` file: the header lists the
    tensors by name with contiguous, ascending data offsets, padded with
    spaces to 8 bytes, then the raw little-endian buffers in that order."""
    header: Dict[str, Any] = {"__metadata__": metadata} if metadata else {}
    names, offset = sorted(tensors), 0
    for name in names:
        t = tensors[name]
        n_bytes = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n_bytes]}
        offset += n_bytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().cpu().contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    tmp.replace(path)


def state_dict_from_params(params: Params, cfg: WhisperConfig,
                           dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_state_dict`: HF names, unstacked
    layers, HF layouts (linear ``[out, in]``, conv ``[out, in, k]``), CPU
    tensors in ``dtype``; the tied lm head ``proj_out.weight`` is the
    embedding table itself."""
    flat = tree_paths(params)
    sd: Dict[str, torch.Tensor] = {}

    def put(key, val):
        sd[key] = val.detach().to("cpu", dtype).contiguous()

    for hf, ours in _TOP_MAP:
        if ours in flat:
            put(hf, flat[ours])
    for name in ("conv1", "conv2"):
        put(f"model.encoder.{name}.weight",
            flat[f"encoder.{name}.kernel"].permute(2, 1, 0))
        put(f"model.encoder.{name}.bias", flat[f"encoder.{name}.bias"])
    for side, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        for hf_tail, our_tail, transpose in _LAYER_MAP:
            key = f"{side}.layers.{our_tail}"
            if key not in flat:
                continue
            for i in range(n_layers):
                w = flat[key][i]
                put(f"model.{side}.layers.{i}.{hf_tail}", w.T if transpose else w)
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    return sd


def save_pretrained(params: Params, cfg: WhisperConfig, path: str,
                    dtype: torch.dtype = torch.float32) -> None:
    """Export to an HF-compatible checkpoint dir: ``config.json`` and
    ``model.safetensors`` (tensors in ``dtype``, fp32 by default as the JAX
    package writes; metadata ``{"format": "pt"}``, which transformers asks
    for; the tied head written as its own copy).  A tree sharded over a
    mesh's model or data axis raises: gather it first
    (``parallel.gather_params``, on every rank), then write from one."""
    from ..parallel import fsdp
    from ..parallel.tensor_parallel import degree
    q = params["decoder"]["layers"]["self_attn"]["q"]
    tp = degree(q, cfg.d_model)
    if tp > 1 or fsdp.is_sharded(q, cfg.d_model):
        raise ValueError(f"save_pretrained got a sharded tree (model axis "
                         f"{tp}); gather it with parallel.gather_params "
                         "first")
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    cfg.save_pretrained(path)
    sd = state_dict_from_params(params, cfg, dtype)
    sd["proj_out.weight"] = sd["proj_out.weight"].clone()
    write_safetensors(sd, p / "model.safetensors", metadata={"format": "pt"})
