from founddiff_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    replicate_state,
    shard_batch,
)
from founddiff_tpu_torch.parallel.sequence import (
    apply_prefix,
    local_summary,
    seq_sharded_selective_scan,
)

__all__ = [
    "Mesh",
    "apply_prefix",
    "init_distributed",
    "local_summary",
    "make_mesh",
    "replicate_state",
    "seq_sharded_selective_scan",
    "shard_batch",
]
