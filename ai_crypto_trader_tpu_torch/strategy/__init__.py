"""Strategy management of the port: evaluation (trade metrics,
cross-validation, comparison), the feature-importance integrator,
selection, the hybrid evolver, the model registry, explanations, the
structure search with its service, grid and DCA trading (simulated and
live) and triangle arbitrage — the JAX package's `strategy` exports."""

from ai_crypto_trader_tpu_torch.strategy.evaluation import (  # noqa: F401
    compare_strategies,
    cross_validate,
    trade_metrics,
)
from ai_crypto_trader_tpu_torch.strategy.integration import (  # noqa: F401
    FeatureImportanceIntegrator,
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
from ai_crypto_trader_tpu_torch.strategy.grid import GridTrader  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.grid_live import (  # noqa: F401
    DCAService,
    GridTraderService,
)
from ai_crypto_trader_tpu_torch.strategy.dca import DCAStrategy  # noqa: F401
from ai_crypto_trader_tpu_torch.strategy.arbitrage import (  # noqa: F401
    find_triangle_arbitrage,
)
