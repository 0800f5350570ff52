from .losses import (  # noqa: F401
    cross_entropy, kl_divergence, hidden_state_mse, get_layers_to_supervise,
    chunked_ce_kl, token_mask, LABEL_PAD,
)
from .state import TrainState, OptimizerConfig, make_schedule  # noqa: F401
from .distill import (DistillConfig, build_train_step,  # noqa: F401
                      build_finetune_step, optax_global_norm)
from .student import init_student_from_teacher, student_layer_map  # noqa: F401
from .data import (  # noqa: F401
    Collator, shift_and_mask, prepare_labels, prev_prompt_from_output,
    is_wer_in_range, in_length_range, pack_samples, pack_samples_iter,
    round_timestamp_ids,
)
from .checkpoint import CheckpointManager  # noqa: F401
