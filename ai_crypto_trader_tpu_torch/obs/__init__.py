"""Observability of the port: the drift spec the tick program computes
against (`obs.drift`), the fleet observatory (`obs.fleetscope`), the gate
vocabulary (`obs.flightrec`) and the model-quality scorecard
(`obs.scorecard`).  The JAX package's flight recorder and PnL attribution
are not ported yet."""

from ai_crypto_trader_tpu_torch.obs.drift import (  # noqa: F401
    DRIFT_FEATURES,
    N_BINS,
    PSI_ALERT_THRESHOLD,
    reference_histogram,
)
from ai_crypto_trader_tpu_torch.obs.fleetscope import FleetScope  # noqa: F401
from ai_crypto_trader_tpu_torch.obs.scorecard import Scorecard  # noqa: F401

__all__ = ["DRIFT_FEATURES", "N_BINS", "PSI_ALERT_THRESHOLD", "FleetScope", "Scorecard",
           "reference_histogram"]
