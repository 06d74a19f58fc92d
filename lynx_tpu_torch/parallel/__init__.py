"""The parallel layer (counterpart of ``lynx_tpu.parallel``): a ``(batch,
particles)`` mesh of ranks with explicit collectives (``sharding``),
pipelined tracking over lattice stages (``pipeline``) and multi-node
start-up (``distributed``), on ``torch.distributed``: NCCL on the card,
Gloo on the CPU."""

from lynx_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    shard_beam,
    shard_segment,
    make_tuning_train_step,
)
from lynx_tpu_torch.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    make_pipeline_mesh,
    pipeline_track,
    split_into_stages,
)
from lynx_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize,
    is_initialized,
    global_mesh,
    host_local_beam_to_global,
    replicate_to_global,
    process_count,
    process_index,
)
