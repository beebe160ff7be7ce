"""Strategy management of the port: evaluation (trade metrics,
cross-validation, comparison), selection, the hybrid evolver, the model
registry, explanations and the structure search with its service.  The
JAX package's `integration`, `grid`, `grid_live`, `dca` and `arbitrage`
are not ported yet (ROADMAP item 16)."""

from ai_crypto_trader_tpu_torch.strategy.evaluation import (  # noqa: F401
    compare_strategies,
    cross_validate,
    trade_metrics,
)
from ai_crypto_trader_tpu_torch.strategy.selection import StrategySelector  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.evolution import StrategyEvolver  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.explain import explain_signal  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.generator import (  # noqa: F401
    GeneratorService,
    StrategyGenerator,
    StrategyStructure,
)
