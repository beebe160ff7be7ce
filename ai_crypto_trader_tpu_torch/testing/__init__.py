"""Deterministic fault-injection harnesses (testing/chaos.py)."""

from ai_crypto_trader_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosBus,
    ChaosExchange,
    FaultSchedule,
    SimulatedCrash,
    inject_bus_faults,
    torn_tail,
)
