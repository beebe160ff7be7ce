"""Host utilities of the port: checkpoints, the write-ahead journal."""

from ai_crypto_trader_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
