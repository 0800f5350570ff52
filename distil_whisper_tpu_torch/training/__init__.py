"""Training: losses, the optimizer and train state, the distillation and
fine-tuning steps, student init, data preparation, checkpoints and the
streaming input pipeline.

The package's names load lazily (PEP 562): importing one submodule, such as
``training.data`` in a pseudo-labelling featurizer worker, does not import
the steps and the model with it.
"""

import importlib

_EXPORTS = {
    "losses": ("cross_entropy", "kl_divergence", "hidden_state_mse",
               "get_layers_to_supervise", "chunked_ce_kl", "token_mask",
               "LABEL_PAD"),
    "state": ("TrainState", "OptimizerConfig", "make_schedule", "place_state"),
    "distill": ("DistillConfig", "build_train_step", "build_finetune_step",
                "optax_global_norm"),
    "student": ("init_student_from_teacher", "student_layer_map"),
    "data": ("Collator", "shift_and_mask", "prepare_labels",
             "prev_prompt_from_output", "is_wer_in_range", "in_length_range",
             "pack_samples", "pack_samples_iter", "round_timestamp_ids"),
    "checkpoint": ("CheckpointManager",),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_MODULE_OF))
