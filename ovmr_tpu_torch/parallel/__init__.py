"""The model axis of tensor parallelism (:mod:`ovmr_tpu_torch.parallel.mesh`)."""

from ovmr_tpu_torch.parallel.mesh import (  # noqa: F401
    ModelAxis,
    pad_to_multiple,
    place_tower_params,
    shard_block,
)
