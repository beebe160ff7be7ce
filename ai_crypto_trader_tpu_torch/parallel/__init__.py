"""The Partitioner seam: on one card, the single-device end only."""

from ai_crypto_trader_tpu_torch.parallel.partitioner import (  # noqa: F401
    SingleDevicePartitioner,
    get_partitioner,
)
