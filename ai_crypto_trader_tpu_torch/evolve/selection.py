"""Selection primitives of the GA.

Port of `ai_crypto_trader_tpu/evolve/selection.py:20-51`.  Both take a [P]
fitness vector and return index tensors.  `tournament` takes its candidate
draw as an argument (the JAX function draws it from a key inside): the GA's
draws come from a provider (evolve/ga.py), so that a test can hand over
the JAX package's own.
"""

from __future__ import annotations

import torch


def tournament(cand: torch.Tensor, fitness: torch.Tensor) -> torch.Tensor:
    """[n_picks] winner indices of uniform tournaments over the candidate
    draw ``cand`` [n_picks, k] (`genetic_algorithm.py:152-161`): each row's
    fittest candidate, the first of equals, as `jnp.argmax` picks it."""
    cand_fit = fitness[cand]
    return cand[torch.arange(cand.shape[0], device=cand.device),
                torch.argmax(cand_fit, dim=1)]


def quantile_split(fitness: torch.Tensor, frac: float):
    """PBT exploit bracket: indices of the bottom-``frac`` and top-``frac``
    quantiles by fitness (truncation selection).  ``n = floor(P * frac)``;
    the ranking is stable, as `jnp.argsort`'s.  Returns ``(bottom, top,
    n)``: ``bottom[i]`` the i-th worst member, ``top[i]`` the i-th best."""
    pop = fitness.shape[0]
    n = int(pop * frac)
    order = torch.argsort(fitness, stable=True)     # ascending: worst first
    bottom = order[:n]
    top = order[pop - n:].flip(0)                   # best first
    return bottom, top, n
