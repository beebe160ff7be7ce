"""Population-based RL: a DQN fleet trained inside the simulated markets,
with PBT exploit/explore between generations.

Port of `ai_crypto_trader_tpu/rl/population.py`.  The fleet is one `DQNState` whose every tensor leads with the [P] member axis
(`rl.dqn._fleet_iteration` steps all members at once), and the PBT loop of
Fast PBT (arXiv 2206.08888) runs on top:

  * a **generation**: every member trains ``iters_per_generation``
    iterations with its own `Hypers`, then plays ``eval_steps`` greedy
    steps of fresh episodes; its fitness is the mean final balance.  A NaN
    or Inf in a member's parameters, moments or fitness trips its sticky
    quarantine bit and arms its cooldown;
  * the **exchange**, on the card from the fitness tensor: the bottom
    ``exploit_frac`` of the healthy members copy a random top-``exploit_frac``
    member's whole training state and perturb the copied hyperparameters
    (×s or ×1/s, clipped to the search box).  A quarantined member ranks
    −inf as a donor; while its cooldown runs it is kept out of the bottom
    bracket (+inf) too; once it has run out it ranks −inf there — the
    forced exploit — and the clone that overwrites it is its heal;
  * ONE `host_read` a generation: fitness, lineage, hypers, metrics and the
    quarantine bits packed into one float32 copy.  Nothing else in a
    generation reads the host.

At P = 1 the exploit bracket is empty, the exchange does nothing, and G
generations of I iterations are bit-identical to the single agent's
`train_iterations(n_iters=G·I)` from the same draws: the evaluation and the
exchange draw from streams of their own (`rl.draws`).

The winning member closes the loop: `adopt_winner` registers it in the
model registry (`strategy.registry`) and runs it through the scorecard's
adoption gate (`obs.scorecard`, on simulator fitness) before it may go
active; a policy worse than the incumbent lands as shadow.

The generation goes through the partitioner seam (`parallel.partitioner`,
program ``pbt_generation``).  A `parallel.MeshPartitioner` splits the
members over its mesh: every draw of the generation is made for the whole
fleet and each shard takes its members' rows (`rl.draws.FleetDraws`), the
markets ride replicated, and the members, fitness and metrics are gathered
onto the mesh's first device, where the exchange runs on the whole fleet.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import minus_product
from ai_crypto_trader_tpu_torch.evolve.selection import quantile_split
from ai_crypto_trader_tpu_torch.ops.tick_engine import Readback, read_packed, stage
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner
from ai_crypto_trader_tpu_torch.rl.dqn import (
    DQNConfig, DQNState, Hypers, _fleet_init, _fleet_iteration, _greedy_rollout,
    hypers_from_config, map_state, poisoned_members)
from ai_crypto_trader_tpu_torch.rl.draws import FleetDraws, as_draws
from ai_crypto_trader_tpu_torch.rl.env import EnvParams, reset_bounds
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof


class PBTConfig(NamedTuple):
    """Population and PBT knobs."""

    population: int = 16
    generations: int = 4
    iters_per_generation: int = 8   # train iterations per member per generation
    eval_steps: int = 128           # greedy-eval rollout length
    exploit_frac: float = 0.25      # bottom/top truncation quantile
    perturb_scale: float = 1.2      # multiplicative hyperparameter jitter
    lr_bounds: tuple = (1e-5, 1e-1)
    gamma_bounds: tuple = (0.90, 0.999)
    eps_decay_bounds: tuple = (0.9, 0.99999)
    eps_min_bounds: tuple = (1e-3, 0.2)
    sync_bounds: tuple = (2, 1000)  # target_sync_every clip (learn steps)
    # exchanges a tripped member stays frozen before the forced-exploit heal
    quarantine_cooldown: int = 1


class PopState(NamedTuple):
    """The fleet on the card: every tensor leads with [P]."""

    members: DQNState
    hypers: Hypers             # each field [P]
    quarantined: torch.Tensor  # [P] bool — sticky poison bit
    cooldown: torch.Tensor     # [P] int32 — exchanges left before the heal


class PBTResult(NamedTuple):
    state: PopState
    fitness: np.ndarray        # [P] final-generation fitness (host)
    best_member: int           # argmax over healthy members
    history: list              # one dict per generation
    cfg: DQNConfig
    pcfg: PBTConfig
    quarantined: np.ndarray | None = None  # [P] final quarantine bits


def host_read(readback: Readback) -> dict:
    """THE per-generation device→host read: wait for the generation's one
    packed copy and unpack it (nested dicts of NumPy arrays).  A
    module-level seam, so tests can count reads.  Timed into the
    ``host_read`` SLO window, the sanctioned sync of a watch window."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():
        out = read_packed(readback)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


# (cfg, pcfg) pairs whose fleet trained in this process: a first
# generation builds what it launches by design (the sentinel's cold window)
_PBT_SEEN: set = set()


def pop_init(key, env_params: EnvParams, cfg: DQNConfig, pcfg: PBTConfig) -> PopState:
    """The fleet: member i's state from the provider's i-th draws (``key``:
    a ``torch.Generator`` on the env's device, or a provider); every
    member's hypers at the config's values."""
    P = pcfg.population
    members = _fleet_init(as_draws(key), env_params, cfg, P)
    dev = env_params.close.device
    hypers = Hypers(*(x.expand(P).clone() for x in hypers_from_config(cfg, dev)))
    return PopState(members=members, hypers=hypers,
                    quarantined=torch.zeros(P, dtype=torch.bool, device=dev),
                    cooldown=torch.zeros(P, dtype=torch.int32, device=dev))


def _eval_member(env_params: EnvParams, params: dict, cfg: DQNConfig, draws,
                 n_steps: int) -> torch.Tensor:
    """[P] greedy fitness: the mean final balance of ``cfg.num_envs`` fresh
    episodes (the provider's evaluation resets) after ``n_steps`` steps."""
    P = next(iter(params.values())).shape[0]
    dev = env_params.close.device
    scen, start = draws.eval_resets(P, cfg.num_envs, reset_bounds(env_params))
    states, _ = _greedy_rollout(env_params, params, scen.to(dev), start.to(dev), n_steps)
    return states.balance.mean(dim=1)


def _generation(pop: PopState, env_params: EnvParams, cfg: DQNConfig, pcfg: PBTConfig):
    """Every member's ``iters_per_generation`` iterations and greedy
    evaluation, then containment: (pop', fitness [P], metrics {name: [P]})."""
    members, losses, rewards = pop.members, [], []
    for _ in range(pcfg.iters_per_generation):
        members, m = _fleet_iteration(env_params, members, cfg, pop.hypers)
        losses.append(m["loss"])
        rewards.append(m["mean_reward"])
    fitness = _eval_member(env_params, members.params, cfg, members.draws, pcfg.eval_steps)
    poisoned = poisoned_members(members, fitness)
    newly = poisoned & ~pop.quarantined
    quarantined = pop.quarantined | poisoned
    cooldown = torch.where(newly, pcfg.quarantine_cooldown, pop.cooldown).to(torch.int32)
    met = {"loss": torch.stack(losses).mean(dim=0), "mean_reward": torch.stack(rewards).mean(dim=0),
           "epsilon": members.epsilon, "tripped_new": newly}
    return PopState(members, pop.hypers, quarantined, cooldown), fitness, met


def _exchange(members: DQNState, hypers: Hypers, quarantined, cooldown, fitness,
              generation: int, pcfg: PBTConfig):
    """The PBT step between generations: (members', hypers', quarantined',
    cooldown', lineage [P]) where ``lineage[i]`` is the member slot i copied
    (its own index if it survived).  Empty bracket (P·frac < 1): nothing
    moves, nothing is drawn."""
    P = fitness.shape[0]
    n = int(pcfg.population * pcfg.exploit_frac)
    arange = torch.arange(P, device=fitness.device)
    lineage = arange.to(torch.int32)
    heal_ready = quarantined & (cooldown <= 0)
    frozen = quarantined & ~heal_ready
    cooldown = torch.clamp_min(cooldown - frozen.to(torch.int32), 0).to(torch.int32)
    if n == 0:
        return members, hypers, quarantined, cooldown, lineage

    # two rankings of the same fitness: donors never poisoned; frozen slots
    # never exploited; heal-ready slots forced into the exploit bracket
    fit_top = torch.where(quarantined, -torch.inf, fitness)
    fit_bottom = torch.where(frozen, torch.inf, torch.where(heal_ready, -torch.inf, fitness))
    bottom, _, _ = quantile_split(fit_bottom, pcfg.exploit_frac)
    _, top, _ = quantile_split(fit_top, pcfg.exploit_frac)
    draws = members.draws
    pick, coins = (x.to(fitness.device) for x in draws.exchange(generation, P, n))
    lineage = lineage.index_put((bottom,), top[pick].to(torch.int32))
    cloned = lineage != arange
    healed = cloned & heal_ready
    quarantined = quarantined & ~healed
    cooldown = torch.where(healed, 0, cooldown).to(torch.int32)

    # exploit: a clone takes its donor's whole training state; its draws
    # are its own slot's (`draws.fork`)
    src = lineage.long()
    members = map_state(lambda x: x[src], members)
    draws.fork(lineage)

    # explore: clones jitter the donor's hypers, clipped to the search box
    s = pcfg.perturb_scale
    jit = torch.where(coins, s, 1.0 / s)
    hy = Hypers(*(x[src] for x in hypers))
    pert = Hypers(
        learning_rate=torch.clamp(hy.learning_rate * jit[0], *pcfg.lr_bounds),
        gamma=torch.clamp(hy.gamma * jit[1], *pcfg.gamma_bounds),
        # perturb ε decay's distance to 1, so the jitter moves its half-life
        # (rounded once: XLA fuses 1 − a·b into a multiply-add)
        epsilon_decay=torch.clamp(minus_product(torch.ones_like(jit[2]),
                                                1.0 - hy.epsilon_decay, jit[2]),
                                  *pcfg.eps_decay_bounds),
        epsilon_min=torch.clamp(hy.epsilon_min * jit[3], *pcfg.eps_min_bounds),
        target_sync_every=torch.clamp(torch.round(hy.target_sync_every * jit[4])
                                      .to(torch.int32), *pcfg.sync_bounds))
    hypers = Hypers(*(torch.where(cloned, p, o) for p, o in zip(pert, hy)))
    return members, hypers, quarantined, cooldown, lineage


_HYPER_DTYPES = {"target_sync_every": np.int32}


def _pack(fitness, lineage, hypers: Hypers, met: dict, pre_q, quarantined, cooldown):
    """Everything the host reads of a generation, as one float32 tensor and
    its layout (every value is exact in float32: P ≤ 2^24, sync ≤ 1000)."""
    P = fitness.shape[0]
    parts = [("fitness", fitness, np.float32), ("lineage", lineage, np.int32)]
    parts += [(f"hypers/{k}", v, _HYPER_DTYPES.get(k, np.float32))
              for k, v in hypers._asdict().items()]
    parts += [(f"metrics/{k}", v, np.bool_ if k == "tripped_new" else np.float32)
              for k, v in met.items()]
    parts += [("pre_quarantined", pre_q, np.bool_), ("quarantined", quarantined, np.bool_),
              ("cooldown", cooldown, np.int32)]
    packed = torch.cat([v.float().reshape(P) for _, v, _ in parts])
    return stage(packed, [(name, (P,), dtype) for name, _, dtype in parts])


def _row(g: int, host: dict, P: int) -> dict:
    """The JAX package's history row of one generation."""
    fin = np.asarray(host["fitness"])
    q = np.asarray(host["quarantined"])
    pre_q = np.asarray(host["pre_quarantined"])
    healthy = ~pre_q
    return {
        "generation": g,
        "best_fitness": float(fin[healthy].max()) if healthy.any() else float("nan"),
        "mean_fitness": float(fin[healthy].mean()) if healthy.any() else float("nan"),
        "n_exploited": int((host["lineage"] != np.arange(P)).sum()),
        "fitness": fin.tolist(),
        "lineage": host["lineage"].tolist(),
        "hypers": {k: np.asarray(v).tolist() for k, v in host["hypers"].items()},
        "loss": float(host["metrics"]["loss"].mean()),
        "mean_reward": float(host["metrics"]["mean_reward"].mean()),
        "quarantined": q.tolist(),
        "n_quarantined": int(q.sum()),
        "n_tripped": int(np.asarray(host["metrics"]["tripped_new"]).sum()),
        "n_healed": int((pre_q & ~q).sum()),
    }


def _split_draws(generation, population: int):
    """``generation`` with the members' provider wrapped for the mesh's
    shards (`rl.draws.FleetDraws`) for its span, and put back after."""
    def run(pop: PopState, env):
        base = pop.members.draws
        split = pop._replace(members=pop.members._replace(draws=FleetDraws(base, population)))
        out, fitness, met = generation(split, env)
        return out._replace(members=out.members._replace(draws=base)), fitness, met

    return run


def train_pbt(key, env_params: EnvParams, cfg: DQNConfig, pcfg: PBTConfig,
              partitioner=None, *, init_pop: PopState | None = None,
              start_generation: int = 0, on_generation=None) -> PBTResult:
    """The host loop: G generations of [train + eval → exchange], ONE
    `host_read` a generation.  ``key``: a ``torch.Generator`` on the env's
    device or a provider; with ``init_pop`` the fleet goes on drawing from
    its own provider.  ``start_generation`` numbers the generations (the
    exchange draws of generation g); ``on_generation(g, pop, row)`` fires
    after each generation's read.  ``partitioner``: None (the single
    device) or a `parallel.MeshPartitioner` (module docstring)."""
    part = resolve_partitioner(partitioner)
    pop = init_pop if init_pop is not None else pop_init(key, env_params, cfg, pcfg)
    # the generation through the partitioner seam (its layout card)
    generation = part.population_eval(
        lambda p, env: _generation(p, env, cfg, pcfg), name="pbt_generation")
    if part.device_count > 1:
        generation = _split_draws(generation, pcfg.population)
    try:
        cold = (cfg, pcfg) not in _PBT_SEEN
        _PBT_SEEN.add((cfg, pcfg))
    except TypeError:                      # an unhashable config: unseen
        cold = True
    prof = devprof.active()
    history, host = [], None
    for g in range(start_generation, start_generation + pcfg.generations):
        gcold, cold = cold, False
        t0 = time.perf_counter()
        # the pbt_generation cost card on the first carded generation, and
        # a watch window through the generation's one host_read
        with meshprof.watch("pbt_generation", cold=gcold):
            with devprof.carding("pbt_generation", (pop, env_params),
                                 note=devprof.NOTE_NO_DONATION) as card:
                pop, fitness, met = card.result(generation(pop, env_params))
            pre_q = pop.quarantined
            members, hypers, quarantined, cooldown, lineage = _exchange(
                pop.members, pop.hypers, pop.quarantined, pop.cooldown, fitness, g, pcfg)
            pop = PopState(members=members, hypers=hypers, quarantined=quarantined,
                           cooldown=cooldown)
            host = host_read(_pack(fitness, lineage, hypers, met, pre_q, quarantined,
                                   cooldown))
        if prof is not None:
            prof.observe_latency("pbt_generation", time.perf_counter() - t0)
        row = _row(g, host, pcfg.population)
        history.append(row)
        if on_generation is not None:
            on_generation(g, pop, row)

    fitness = np.asarray(host["fitness"])
    q = np.asarray(host["quarantined"])
    return PBTResult(state=pop, fitness=fitness,
                     best_member=int(np.argmax(np.where(q, -np.inf, fitness))),
                     history=history, cfg=cfg, pcfg=pcfg, quarantined=q)


def best_params(result: PBTResult) -> dict:
    """The winning member's Q-network parameters (on the card)."""
    return {k: v[result.best_member] for k, v in result.state.members.params.items()}


def adopt_winner(result: PBTResult, registry, scorecard=None, *, kind: str = "rl_policy",
                 symbol: str = "SIM", interval: str = "pbt",
                 checkpoint_path: str | None = None) -> dict:
    """Register the winning policy and run it through the scorecard's
    adoption gate before it may go active (the JAX package's verdict, on
    the same fitness): the gate compares the candidate's simulator fitness
    with the registry's best incumbent of ``kind``; a worse candidate is
    registered as shadow, never made active.  With ``checkpoint_path`` the
    winner's Q-network is saved there (`utils.checkpoint.save_checkpoint`).
    The winner's hypers come from the last generation's host read (no
    read of the card), the fitness from ``result.fitness``."""
    best = result.best_member
    if result.history:
        hypers = result.history[-1]["hypers"]
    else:
        hypers = {k: v.cpu().tolist() for k, v in result.state.hypers._asdict().items()}
    hy = {k: float(hypers[k][best]) for k in Hypers._fields}
    fitness = float(result.fitness[best])

    incumbent = registry.best(kind, metric="fitness")
    allowed, reason = True, "no_scorecard"
    if scorecard is not None:
        allowed, reason = scorecard.adoption_gate(
            "dqn_pbt:candidate",
            incumbent["version"] if incumbent else "dqn_pbt:none",
            symbol, interval, candidate_score=fitness,
            incumbent_score=(incumbent or {}).get("performance", {}).get("fitness"))

    payload = dict(hy, arch="dqn_pbt", state_size=result.cfg.state_size,
                   hidden=str(result.cfg.hidden), fitness=fitness)
    if checkpoint_path is not None:
        from ai_crypto_trader_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(checkpoint_path, tree=best_params(result),
                        metadata={"kind": kind, "fitness": fitness})
        payload["checkpoint"] = checkpoint_path
    # exact duplicates only: a winner that cleared its gate gets its own version
    vid = registry.register(kind, payload, metadata={
        "arch": "dqn_pbt",
        "population": result.pcfg.population,
        "generations": result.pcfg.generations,
        "dynamics": "lob",
        "adoption": "adopted" if allowed else "blocked_by_scorecard",
        "adoption_reason": reason,
    }, similarity_threshold=1.0)
    registry.update_performance(vid, {"fitness": fitness,
                                      "mean_fitness": float(result.fitness.mean())})
    registry.set_status(vid, "active" if allowed else "shadow")
    return {"version": vid, "adopted": allowed, "reason": reason, "fitness": fitness}


def pbt_env_params(key, scenario="mixed", num_scenarios: int = 32, steps: int = 1024,
                   episode_len: int = 256, fee_rate: float = 0.0005, dynamics: str = "lob",
                   flow=None, device=None):
    """The fleet's training markets: `sim.engine.scenario_env_params` with
    the order-flow book by default (book-state columns and the half-spread
    cost).  Returns (EnvParams, labels); size networks with
    `rl.env.obs_size`."""
    from ai_crypto_trader_tpu_torch.sim.engine import scenario_env_params

    return scenario_env_params(key, scenario=scenario, num_scenarios=num_scenarios,
                               steps=steps, episode_len=episode_len, fee_rate=fee_rate,
                               dynamics=dynamics, flow=flow, device=device)
