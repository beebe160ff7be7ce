"""Public parallelism API: meshes and the Partitioner seam.

The population programs route through `get_partitioner()` (see
parallel/partitioner.py).  The sequence-parallel indicators
(parallel/time_shard.py) and ring attention (parallel/ring_attention.py)
are not re-exported here: import them from their modules.
"""

from ai_crypto_trader_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    default_mesh,
    data_sharding,
    initialize_distributed,
    pad_to_multiple,
    replicated,
    shard_leading_axis,
)
from ai_crypto_trader_tpu_torch.parallel.partitioner import (  # noqa: F401
    MeshPartitioner,
    Partitioner,
    SingleDevicePartitioner,
    get_partitioner,
    match_partition_rules,
)
