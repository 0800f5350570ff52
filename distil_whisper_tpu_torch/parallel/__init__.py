"""Multi-GPU: process groups, the ``(data, model)`` device mesh and its
rules, tensor parallelism over the model axis (``tensor_parallel``), 2-D
(FSDP-style) parameter sharding over the data axis (``fsdp``), the axes'
groups and one recorder of their collectives (``groups``), the
leader's command stream of serving under a mesh (``lockstep``), host-side
collectives, and a multi-process dry run (``parallel.dryrun``)."""

from .mesh import (  # noqa: F401
    DEFAULT_RULES, RULES_2D, make_mesh, spec_for_axes, shardings_for_tree,
    shard_params, gather_params, shard_batch, data_sharding, replicated,
    data_group, model_group, coordinates,
)
from .multihost import (  # noqa: F401
    maybe_initialize_distributed, host_local_batch_to_global,
    process_local_slice, gather_rows, global_row_positions,
)
