"""Strategy management of the port: the model registry (the JAX package's
other `strategy` exports are not ported yet)."""

from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry  # noqa: F401
