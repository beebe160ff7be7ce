"""The decision gate vocabulary (the port's copy of
`ai_crypto_trader_tpu/obs/flightrec.py:41-88`).

A gate id is a position in `GATES`, and gate ids live in journaled decision
records, so the tuple is copied in the same order and only ever appended
to.  `VETO_ORDER` is the priority in which the executor's gates test a
signal; the tenant engine resolves its predicates in this order.  The
flight recorder itself is not ported yet.
"""

GATES = (
    "analysis_interval",      # analyzer per-symbol cadence gate
    "outcome_probability",    # trade-outcome model downgraded BUY → HOLD
    "nan_gate",               # non-finite price/feature poisoned payload
    "confidence_floor",       # AI confidence below threshold
    "strength_floor",         # technical signal strength below floor
    "signal_disagreement",    # technical signal != AI decision
    "not_buy",                # agreed decision is HOLD/SELL
    "position_open",          # symbol already holds a position
    "pending_intent",         # unresolved ambiguous order parks entry
    "max_positions",          # position slots exhausted
    "risk_min_size",          # sized below min_trade_amount
    "entry_rejected",         # venue rejected the entry order
    "quarantine",             # executor stage quarantined mid-flight
    "lane_quarantined",       # tenant lane poisoned (NaN/Inf state or
    #                           params), masked out of sizing and entry
    #                           until the host healer re-seeds it
)

VETO_ORDER = (
    "lane_quarantined",
    "nan_gate",
    "confidence_floor",
    "strength_floor",
    "not_buy",
    "signal_disagreement",
    "position_open",
    "pending_intent",
    "max_positions",
    "risk_min_size",
)
