"""Where the RL trainer's random draws come from.

`jax.random` streams cannot be replayed in PyTorch, so the port's DQN and
PBT fleet take every random quantity from a provider, as tensors on the
card.  `GeneratorDraws` is the default: three ``torch.Generator`` streams,
kept apart as the JAX package keeps its keys apart —

  * the members' training draws (the JAX member key): each rollout step's
    ε-explore uniforms and random actions and the reset draws of every env,
    [R, P, N]; each learn step's replay indices, [L, P, batch];
  * the greedy evaluation's resets (JAX: ``fold_in(member.key, salt)``,
    which leaves the training key alone);
  * the PBT exchange's donor picks and hyperparameter coins (JAX:
    ``fold_in(key, g + 1)``).

With the exchange and the evaluation on streams of their own, a fleet of
one trains on exactly the draws the single agent does: the P = 1 oracle of
`rl.population`.  A clone that the exchange makes draws the next [P, ...]
rows of the fleet's training stream at its own slot, so it never shares its
donor's draws; `fork` (which the JAX package's ``fold_in(key, lineage)``
needs) is a no-op here.

A replay index is ``floor(u · max(size, 1))`` for a uniform u, computed on
the card from the ring's size there: reading the size would sync.

`GeneratorDraws.get_state` / `from_state` carry the three streams' states
through a checkpoint (`rl.trainer_service`), so a resumed fleet draws what
an unbroken one would.

A provider for tests implements the same methods (``init_params``,
``resets``, ``rollout``, ``replay_indices``, ``eval_resets``,
``exchange``, ``fork``) and may hand over the JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# seed offsets of the evaluation and exchange streams from the training one
EVAL_SALT, EXCHANGE_SALT = 0x5EED, 0xE8C4


class RolloutDraws(NamedTuple):
    """One iteration's rollout draws, each [R, P, N]."""

    explore_u: torch.Tensor     # float32 uniforms in [0, 1): explore where < ε
    random_a: torch.Tensor      # int64 random actions in [0, n_actions)
    scen: torch.Tensor          # int64 reset scenario rows in [0, S)
    start: torch.Tensor         # int64 reset start offsets in [0, hi)


class GeneratorDraws:
    """The default provider: draws from ``generator`` (training), and from
    two generators seeded from its initial seed (evaluation, exchange), all
    on the generator's device."""

    def __init__(self, generator: torch.Generator):
        self.train = generator
        dev, seed = generator.device, generator.initial_seed()
        self.eval = torch.Generator(dev).manual_seed(seed + EVAL_SALT)
        self.exchange_gen = torch.Generator(dev).manual_seed(seed + EXCHANGE_SALT)
        self.device = dev

    def init_params(self, build, P: int) -> list:
        """P freshly initialised networks: ``build(generator)`` each."""
        return [build(self.train) for _ in range(P)]

    def _resets(self, gen, shape, bounds):
        S, hi = bounds
        return (torch.randint(0, S, shape, generator=gen, device=self.device),
                torch.randint(0, hi, shape, generator=gen, device=self.device))

    def resets(self, P: int, N: int, bounds) -> tuple:
        """(scen, start) [P, N] of the initial episodes (training stream)."""
        return self._resets(self.train, (P, N), bounds)

    def rollout(self, R: int, P: int, N: int, n_actions: int, bounds) -> RolloutDraws:
        shape = (R, P, N)
        u = torch.rand(shape, generator=self.train, device=self.device)
        a = torch.randint(0, n_actions, shape, generator=self.train, device=self.device)
        return RolloutDraws(u, a, *self._resets(self.train, shape, bounds))

    def replay_indices(self, L: int, batch: int, size: torch.Tensor) -> torch.Tensor:
        """[L, P, batch] indices uniform in [0, max(size, 1)) of each
        member's ring (``size`` [P], on the card)."""
        P = size.shape[0]
        u = torch.rand((L, P, batch), generator=self.train, device=self.device)
        hi = torch.clamp_min(size, 1).to(u.dtype).reshape(1, P, 1)
        idx = torch.floor(u * hi).long()
        return torch.minimum(idx, (hi - 1).long())

    def eval_resets(self, P: int, N: int, bounds) -> tuple:
        """(scen, start) [P, N] of the greedy evaluation's episodes."""
        return self._resets(self.eval, (P, N), bounds)

    def exchange(self, generation: int, P: int, n: int) -> tuple:
        """(donor picks [n] in [0, n), coins [5, P] bool) of one exchange."""
        pick = torch.randint(0, n, (n,), generator=self.exchange_gen, device=self.device)
        coins = torch.rand((5, P), generator=self.exchange_gen, device=self.device) < 0.5
        return pick, coins

    def fork(self, lineage: torch.Tensor) -> None:
        """Clones already draw at slots of their own: nothing to do."""

    STREAMS = ("train", "eval", "exchange_gen")

    def get_state(self) -> dict:
        """The three streams' states ({stream: uint8 tensor on the CPU},
        ``torch.Generator.get_state``): what a checkpoint must carry for a
        resumed fleet to draw what an unbroken one would."""
        return {name: getattr(self, name).get_state() for name in self.STREAMS}

    @classmethod
    def from_state(cls, states: dict, device) -> "GeneratorDraws":
        """A provider on ``device`` whose three streams continue from
        ``states`` (`get_state`'s, from a generator of that device type)."""
        draws = cls(torch.Generator(device))
        for name in cls.STREAMS:
            getattr(draws, name).set_state(states[name])
        return draws


def as_draws(key):
    """A provider for ``key``: a ``torch.Generator`` becomes
    `GeneratorDraws`; anything else is taken as a provider."""
    return GeneratorDraws(key) if isinstance(key, torch.Generator) else key


class FleetDraws:
    """The fleet's draws split over a mesh: each draw of a generation is
    made once, by ``base`` for all P members, when the first shard asks for
    it, and every shard gets its own rows of it
    (`parallel.mesh.current_shard`), so a shard trains on exactly the
    draws the single device's fleet would give its members.  A shard's
    k-th call of a generation takes the k-th draw made.  On a process mesh
    each rank's ``base`` is in the same state, so the rank makes every
    draw for all P at its own shard's call and takes its rows.

    A replay draw is made at the size of every member's ring: each member
    has pushed the same number of transitions, so one member's ring size
    is every member's.  The exchange and ``fork`` run on the whole fleet
    after the gather and go to ``base``."""

    def __init__(self, base, population: int):
        self.base, self.population = base, population
        self._made: list = []
        self._calls: dict = {}

    def _draw(self, make):
        from ai_crypto_trader_tpu_torch.parallel.mesh import current_shard

        sh = current_shard()
        i = self._calls.get(sh.index, 0)
        self._calls[sh.index] = i + 1
        if i == len(self._made):
            self._made.append(make())
        return self._made[i], sh

    def rollout(self, R: int, P: int, N: int, n_actions: int, bounds) -> RolloutDraws:
        d, sh = self._draw(lambda: self.base.rollout(R, self.population, N, n_actions, bounds))
        return RolloutDraws(*(sh.take(x, dim=1) for x in d))

    def replay_indices(self, L: int, batch: int, size: torch.Tensor) -> torch.Tensor:
        d, sh = self._draw(lambda: self.base.replay_indices(
            L, batch, size[:1].expand(self.population)))
        return sh.take(d, dim=1)

    def eval_resets(self, P: int, N: int, bounds) -> tuple:
        d, sh = self._draw(lambda: self.base.eval_resets(self.population, N, bounds))
        return tuple(sh.take(x, dim=0) for x in d)

    def exchange(self, generation: int, P: int, n: int) -> tuple:
        return self.base.exchange(generation, P, n)

    def fork(self, lineage: torch.Tensor) -> None:
        self.base.fork(lineage)
