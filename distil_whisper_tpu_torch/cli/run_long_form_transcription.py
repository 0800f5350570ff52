"""Long-form transcription eval: a thin front-end over :mod:`.run_eval` with
long-form defaults (chunked mode unless ``--mode`` is given; 25 s chunks;
WER/IER/SER/DER + repeated-5-gram reporting).

    python -m distil_whisper_tpu_torch.cli.run_long_form_transcription \
        --model_checkpoint ./distil-large-v3 --dataset_path ./long.jsonl
"""

from __future__ import annotations

import sys

from .run_eval import main as _eval_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--mode" not in argv and not (len(argv) == 1 and argv[0].endswith(".json")):
        argv += ["--mode", "chunked"]
    return _eval_main(argv)


if __name__ == "__main__":
    main()
