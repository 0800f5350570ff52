"""Student initialisation from a teacher (create_student_model).

The port of ``distil_whisper_tpu.training.student``: the full encoder (or
a maximally-spaced subset of its layers) and a maximally-spaced subset of
decoder layers, the first and last pinned, or explicit layer picks; with
stacked layers this is one gather along the ``layers`` axis.  Optional
``max_source_positions`` truncation (15 s-context students).  The student
owns fresh tensors: nothing aliases the teacher.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.params import map_with_path

Params = Any


def student_layer_map(teacher_layers: int, student_layers: int) -> np.ndarray:
    mapping = np.linspace(0, teacher_layers - 1, student_layers, dtype=np.int64)
    mapping[-1] = teacher_layers - 1  # always keep the final teacher layer
    return mapping


def init_student_from_teacher(
        teacher_params: Params, teacher_cfg: WhisperConfig,
        decoder_layers: int = 2,
        encoder_layers: Optional[int] = None,
        decoder_layer_numbers: Optional[Sequence[int]] = None,
        max_source_positions: Optional[int] = None):
    """Returns (student_params, student_cfg)."""
    enc_l = encoder_layers or teacher_cfg.encoder_layers
    cfg = teacher_cfg.replace(encoder_layers=enc_l,
                              decoder_layers=decoder_layers)
    if decoder_layer_numbers is not None:
        if len(decoder_layer_numbers) != decoder_layers:
            raise ValueError(f"{len(decoder_layer_numbers)} decoder layer "
                             f"numbers for {decoder_layers} layers")
        dec_map = np.asarray(decoder_layer_numbers, np.int64)
    else:
        dec_map = student_layer_map(teacher_cfg.decoder_layers, decoder_layers)
    enc_map = (student_layer_map(teacher_cfg.encoder_layers, enc_l)
               if enc_l != teacher_cfg.encoder_layers else np.arange(enc_l))

    def side(tree, idx):
        idx = torch.as_tensor(idx)
        rest = {k: v for k, v in tree.items() if k != "layers"}
        return {**map_with_path(lambda _, x: x.clone(), rest),
                "layers": map_with_path(
                    lambda _, x: x.index_select(0, idx.to(x.device)),
                    tree["layers"])}

    student = {"encoder": side(teacher_params["encoder"], enc_map),
               "decoder": side(teacher_params["decoder"], dec_map)}
    if (max_source_positions is not None
            and max_source_positions != teacher_cfg.max_source_positions):
        cfg = cfg.replace(max_source_positions=max_source_positions)
        student["encoder"]["pos_emb"] = \
            student["encoder"]["pos_emb"][:max_source_positions].clone()
    return student, cfg
