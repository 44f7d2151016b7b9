"""The data and model axes of the port's mesh (:mod:`ovmr_tpu_torch.parallel.mesh`)
and multi-process start-up (:mod:`ovmr_tpu_torch.parallel.multihost`)."""

from ovmr_tpu_torch.parallel.mesh import (  # noqa: F401
    DataAxis,
    Mesh,
    ModelAxis,
    build_mesh,
    map_data_shards,
    pad_to_multiple,
    place_local_batch,
    place_packed_mlp,
    place_tower_params,
    replicate,
    shard_batch,
    shard_batch_local,
    shard_block,
    to_host,
)
from ovmr_tpu_torch.parallel.multihost import (  # noqa: F401
    barrier,
    is_primary,
    maybe_initialize_distributed,
)
