"""Data parallelism, fsdp and tensor parallelism across processes: the
port of ``avsr_tpu/mesh/`` for the data axes and ``tp`` (``sharding.py``,
``multihost.py``; every collective in ``collectives.py``)."""

from avsr_tpu_torch.mesh.multihost import (  # noqa: F401
    data_parallel_ways,
    init_distributed,
    local_rows,
    process_shard,
)
from avsr_tpu_torch.mesh.sharding import (  # noqa: F401
    Mesh,
    RowShard,
    build_mesh,
    check_model,
    gather_tree,
    param_spec,
    row_shard,
    shard_params,
)
