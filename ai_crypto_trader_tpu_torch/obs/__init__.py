"""Observability of the port: the drift spec the tick program computes
against (`obs.drift`), the fleet observatory (`obs.fleetscope`), the
decision flight recorder and its gate vocabulary (`obs.flightrec`), the
model-quality scorecard (`obs.scorecard`) and the PnL attribution by
signal source (`obs.attribution`)."""

from ai_crypto_trader_tpu_torch.obs.attribution import PnLAttribution  # noqa: F401
from ai_crypto_trader_tpu_torch.obs.drift import (  # noqa: F401
    DRIFT_FEATURES,
    N_BINS,
    PSI_ALERT_THRESHOLD,
    reference_histogram,
)
from ai_crypto_trader_tpu_torch.obs.fleetscope import FleetScope  # noqa: F401
from ai_crypto_trader_tpu_torch.obs.flightrec import (  # noqa: F401
    FlightRecorder,
    load_decisions,
)
from ai_crypto_trader_tpu_torch.obs.scorecard import Scorecard  # noqa: F401

__all__ = ["DRIFT_FEATURES", "N_BINS", "PSI_ALERT_THRESHOLD", "FleetScope", "FlightRecorder",
           "PnLAttribution", "Scorecard", "load_decisions", "reference_histogram"]
