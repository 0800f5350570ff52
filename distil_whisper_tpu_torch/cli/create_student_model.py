"""Initialise a distil student from a teacher checkpoint.

The port of ``distil_whisper_tpu.cli.create_student_model`` with its flags:
a maximally-spaced copy of the decoder layers with the last pinned, an
optional encoder shrink, optional ``--max_source_positions`` truncation,
then save (fp32 ``model.safetensors`` and ``config.json``, the teacher's
tokenizer files), reload and one forward pass as a self-check.  Runs on the
GPU unless ``--device cpu``.

    python -m distil_whisper_tpu_torch.cli.create_student_model \\
        --teacher_checkpoint /path/to/whisper-large-v3 \\
        --decoder_layers 2 --save_dir ./distil-large-v3-init
"""

from __future__ import annotations

import argparse

import torch

from ..models import forward, load_params, save_pretrained
from ..training.student import init_student_from_teacher
from .common import copy_tokenizer_files, logger, setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--teacher_checkpoint", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--decoder_layers", type=int, default=2)
    p.add_argument("--encoder_layers", type=int, default=None)
    p.add_argument("--decoder_layers_numbers", type=int, nargs="*",
                   default=None,
                   help="explicit teacher decoder layers to copy")
    p.add_argument("--max_source_positions", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)
    setup_logging()

    teacher, teacher_cfg = load_params(args.teacher_checkpoint,
                                       device=args.device)
    logger.info("teacher: %d enc / %d dec layers, d_model %d",
                teacher_cfg.encoder_layers, teacher_cfg.decoder_layers,
                teacher_cfg.d_model)
    student, student_cfg = init_student_from_teacher(
        teacher, teacher_cfg,
        decoder_layers=args.decoder_layers,
        encoder_layers=args.encoder_layers,
        decoder_layer_numbers=args.decoder_layers_numbers,
        max_source_positions=args.max_source_positions)
    del teacher
    save_pretrained(student, student_cfg, args.save_dir)
    copy_tokenizer_files(args.teacher_checkpoint, args.save_dir)
    del student

    # reload + one forward pass: the saved student loads and runs
    reloaded, cfg = load_params(args.save_dir, device=args.device)
    mel = torch.zeros((1, cfg.num_mel_bins, 3000), device=args.device)
    tokens = torch.tensor([[cfg.decoder_start_token_id]], device=args.device)
    with torch.no_grad():
        logits, _ = forward(reloaded, cfg, mel, tokens)
    if not torch.isfinite(logits).all():
        raise RuntimeError("the reloaded student gives non-finite logits")
    logger.info("student saved to %s (%d dec layers), smoke forward OK",
                args.save_dir, cfg.decoder_layers)


if __name__ == "__main__":
    main()
