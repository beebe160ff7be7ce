"""Monte-Carlo engine of the port (`mc.engine`)."""

from ai_crypto_trader_tpu_torch.mc.engine import (  # noqa: F401
    estimate_mu_sigma,
    path_statistics,
    portfolio_stats,
    run_simulation,
    simulate_bootstrap,
    simulate_gbm,
    simulate_portfolio_correlated,
)
