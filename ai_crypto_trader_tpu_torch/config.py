"""Configuration of the port's GA.

The port's own copy of `ai_crypto_trader_tpu/config.py:130-140`
(`GAParams`), with the same defaults: the port imports nothing of the JAX
package, not even its jax-free modules.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GAParams:
    """GA budgets (the reference's strategy_evolution_service.py:78-79,
    config:213)."""

    population_size: int = 20
    generations: int = 10
    elite_size: int = 2
    tournament_size: int = 3
    crossover_rate: float = 0.7
    mutation_rate: float = 0.2
    mutation_scale: float = 0.2  # fraction of range
