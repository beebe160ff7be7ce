"""Risk layer of the port: VaR / CVaR and sizing (`risk.var`), stop-loss
machinery (`risk.stops`) and the social-sentiment adjustment
(`risk.social`)."""

from ai_crypto_trader_tpu_torch.risk.var import (  # noqa: F401
    correlation_matrix,
    cvar,
    diversification_analysis,
    equal_risk_position_sizes,
    historical_var,
    parametric_var,
    portfolio_var,
    stress_var_cvar,
)
from ai_crypto_trader_tpu_torch.risk.stops import (  # noqa: F401
    STRATEGIES,
    TrailingStopState,
    adaptive_stop_loss,
    trailing_stop_init,
    trailing_stop_update,
)
from ai_crypto_trader_tpu_torch.risk.social import (  # noqa: F401
    SocialSnapshot,
    social_risk_adjustment,
    weighted_sentiment,
)
