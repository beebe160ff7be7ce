from ai_crypto_trader_tpu_torch.evolve.ga import (  # noqa: F401
    GAState,
    GeneratorDraws,
    backtest_fitness,
    evolve_step,
    population_diversity,
    run_ga,
)
from ai_crypto_trader_tpu_torch.evolve.selection import (  # noqa: F401
    quantile_split,
    tournament,
)
