"""Genetic strategy evolution with real backtest fitness.

Port of `ai_crypto_trader_tpu/evolve/ga.py:65-334`: elitism, tournament
selection, uniform crossover, Gaussian mutation scaled to each parameter's
range with integer dimensions re-rounded (the reference's
`genetic_algorithm.py`), and fitness = the penalised Sharpe of a full
backtest of every genome (`backtest_fitness`).

`run_ga` is a loop over generations on the device: the population's
fitness is one evaluation of the whole population (a [pop] batch, where the
JAX package vmaps), history stays on the device, and one `host_read` at the
end brings the results back — the port's counterpart of the JAX package's
one compiled scan.  `run_ga_legacy` reads the history every generation, as
its JAX counterpart does.  `run_ga` takes the JAX package's ``partitioner``
keyword (None: the single device, the population one batch).  The
population's fitness goes through the seam's
``population_eval(name="ga_scan")``: a `parallel.MeshPartitioner` splits
the genomes over its mesh after the generation's draws were made for the
whole population, so every shard evaluates exactly the single device's
rows (a fitness from `backtest_fitness` has its candles and tables copied
once to each device of the mesh; any other callable is called on each
shard's rows where they lie).  The layout card is recorded with
`utils.meshprof` active; with `utils.devprof`
active the first run takes the ``ga_scan`` cost card, and the run through
its one `host_read` is a ``ga_scan`` watch window.

Random draws.  `jax.random` streams cannot be replayed in PyTorch, so the
GA takes its draws from a provider with two methods: ``init(pop)`` returns
the initial genomes [pop, n_params], and ``generation(pop, n_children, k,
n_params, cfg)`` returns the six draws of one generation — the two
tournaments' candidates [n_children, k], the crossover and gene masks, the
mutation noise and the mutation mask.  The noise is normal with variance
1/2: `jax.random.normal` draws √2·erfinv(u), and the compiled JAX program
folds that √2 into the constant span it multiplies by, so the noise here
is erfinv(u) and `_evolve_core` multiplies it by (√2·span)·scale — the
JAX package's rounding, given its draws.  `GeneratorDraws`
makes them from one ``torch.Generator`` (on its device: a CUDA generator
keeps the loop free of host copies).  `_evolve_core` is a pure function of
(draws, state, cfg).
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.evolvable import (
    build_indicator_tables,
    evolvable_fused_backtest,
)
from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics
from ai_crypto_trader_tpu_torch.backtest.strategy import (
    N_PARAMS,
    StrategyParams,
    _ranges,
    sample_params,
    stack_params,
    unstack_params,
)
from ai_crypto_trader_tpu_torch.config import GAParams
from ai_crypto_trader_tpu_torch.device import resolve_device, to_device
from ai_crypto_trader_tpu_torch.evolve.selection import tournament
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof

_SQRT2 = float(np.sqrt(np.float32(2.0), dtype=np.float32))


class GAState(NamedTuple):
    genomes: torch.Tensor      # [pop, n_params]
    fitness: torch.Tensor      # [pop]
    best_genome: torch.Tensor  # [n_params]
    best_fitness: torch.Tensor


def _numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return type(tree)(*map(_numpy, tree)) if hasattr(tree, "_fields") \
        else type(tree)(map(_numpy, tree))


def host_read(tree):
    """THE per-run device→host read: GA outputs (tensors in nested tuples)
    → NumPy.  A module-level seam, so a test can count it.  Timed into the
    ``host_read`` SLO window when the observatory is on, and the
    sanctioned sync of the ``ga_scan`` watch window."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = _numpy(tree)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


# fitness functions whose GA ran at a config in this process: a first run
# builds what it launches by design (the recompile sentinel's cold window)
_GA_RUNS_SEEN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def population_diversity(genomes: torch.Tensor) -> torch.Tensor:
    """Mean normalized variance across parameter dims
    (`genetic_algorithm.py:293-348`)."""
    lows, highs, _ = _ranges(genomes.device)
    norm = (genomes - lows) / (highs - lows)
    centred = norm - norm.mean(dim=0, keepdim=True)
    return torch.mean(torch.mean(centred * centred, dim=0))


def backtest_fitness(ohlcv: dict, *, min_sharpe_weight: float = 1.0,
                     drawdown_limit: float = 15.0, win_rate_target: float = 52.0,
                     device=None) -> Callable:
    """Fitness = backtest Sharpe, penalized by the monitoring thresholds of
    the reference's _needs_improvement (strategy_evolution_service.py:
    1571-1582): excess drawdown and win-rate shortfall subtract, and a
    genome that never trades loses 5.

    Returns ``fitness(p)``: params [pop] → fitness [pop] on ``device``
    (default: the CUDA card).  The integer-period indicator tables for this
    window are built once, here (the fused-EWMA kernel's launches), and
    every evaluation gathers rows from them and replays the population
    through the replay kernel's rows form.  The direct per-genome path,
    the parity oracle, is `population_backtest` without tables.

    ``fitness.core(p, arrays, tables)`` is the same function of the
    candles and tables it is handed, on ``p``'s device, and
    ``fitness.replicated`` those two: the partitioner seam copies them to
    each device of a mesh."""
    dev = resolve_device(device)
    arrays = {k: to_device(v, dev, torch.float32) for k, v in ohlcv.items() if k != "regime"}
    tbl = build_indicator_tables(arrays, device=dev)

    def core(p: StrategyParams, arrays: dict, tbl) -> torch.Tensor:
        on = p.stop_loss.device
        stats = evolvable_fused_backtest(arrays, p, tbl, device=on)
        m = compute_metrics(stats, device=on)
        dd_pen = torch.clamp_min(m["max_drawdown_pct"] - drawdown_limit, 0.0) * 0.05
        wr_pen = torch.clamp_min(win_rate_target - m["win_rate"], 0.0) * 0.01
        no_trades = (stats.total_trades == 0).to(torch.float32)
        return (min_sharpe_weight * m["sharpe_ratio"] - dd_pen - wr_pen
                - no_trades * 5.0)

    def fitness(p: StrategyParams) -> torch.Tensor:
        return core(p, arrays, tbl)

    fitness.device, fitness.tables = dev, tbl
    fitness.core, fitness.replicated = core, (arrays, tbl)
    return fitness


class GeneratorDraws:
    """The GA's draws from one ``torch.Generator``, made on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init(self, pop: int) -> torch.Tensor:
        return stack_params(sample_params(self.generator, pop, device=self.generator.device))

    def generation(self, pop: int, n_children: int, k: int, n_params: int, cfg: GAParams):
        g, dev = self.generator, self.generator.device
        rand = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731
        return (torch.randint(0, pop, (n_children, k), generator=g, device=dev),
                torch.randint(0, pop, (n_children, k), generator=g, device=dev),
                rand(n_children, 1) < cfg.crossover_rate,
                rand(n_children, n_params) < 0.5,
                torch.randn((n_children, n_params), generator=g, device=dev) / _SQRT2,
                rand(n_children, n_params) < cfg.mutation_rate)


def _provider(draws):
    return GeneratorDraws(draws) if isinstance(draws, torch.Generator) else draws


def _generation_draws(draws, state: GAState, cfg: GAParams):
    pop, n_params = state.genomes.shape
    dev = state.genomes.device
    out = draws.generation(pop, pop - cfg.elite_size, cfg.tournament_size, n_params, cfg)
    cand_a, cand_b, do_cross, mask, noise, do_mut = (to_device(x, dev) for x in out)
    return (cand_a.to(torch.int64), cand_b.to(torch.int64), do_cross.to(torch.bool),
            mask.to(torch.bool), noise.to(torch.float32), do_mut.to(torch.bool))


def _evolve_core(draws, state: GAState, cfg: GAParams) -> GAState:
    """One generation of selection → crossover → mutation → clamp, from the
    six draws of `_generation_draws`, in the JAX package's arithmetic
    order.  The new genomes' fitness is filled in by the next evaluation."""
    cand_a, cand_b, do_cross, mask, noise, do_mut = draws
    genomes, fitness = state.genomes, state.fitness

    # Elitism (genetic_algorithm.py:139-146); a stable ranking, as jnp.argsort
    elites = genomes[torch.argsort(-fitness, stable=True)[: cfg.elite_size]]
    parents_a = genomes[tournament(cand_a, fitness)]
    parents_b = genomes[tournament(cand_b, fitness)]

    # Uniform crossover (genetic_algorithm.py:163-189)
    children = torch.where(do_cross & mask, parents_b, parents_a)

    # Gaussian mutation scaled to range; ints re-rounded (:191-223)
    lows, highs, is_int = _ranges(genomes.device)
    noise = noise * (_SQRT2 * (highs - lows)) * cfg.mutation_scale
    children = children + torch.where(do_mut, noise, 0.0)
    children = torch.clamp(children, lows, highs)
    children = torch.where(is_int, torch.round(children), children)
    return state._replace(genomes=torch.cat([elites, children], dim=0))


evolve_step = _evolve_core


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor ``i`` on the device, without reading
    it back (indexing with a 0-d tensor converts it to a Python int: a
    device→host sync)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _update_best(state: GAState) -> GAState:
    i = torch.argmax(state.fitness)
    better = _at(state.fitness, i) > state.best_fitness
    return state._replace(
        best_genome=torch.where(better, _at(state.genomes, i), state.best_genome),
        best_fitness=torch.where(better, _at(state.fitness, i), state.best_fitness))


def _init_state(draws, fitness_fn: Callable, cfg: GAParams,
                seed_params: StrategyParams | None, dev) -> GAState:
    """Initial genomes (individual 0 the incumbent strategy when
    ``seed_params`` is given, genetic_algorithm.py:92-99) and their
    fitness."""
    genomes = to_device(draws.init(cfg.population_size), dev, torch.float32)
    if genomes.shape != (cfg.population_size, N_PARAMS):
        raise ValueError(f"draws.init gave genomes of shape {tuple(genomes.shape)}")
    if seed_params is not None:
        genomes = genomes.clone()
        genomes[0] = stack_params(StrategyParams(
            *(to_device(v, dev, torch.float32) for v in seed_params)))
    fitness = fitness_fn(unstack_params(genomes))
    i = torch.argmax(fitness)
    return _update_best(GAState(genomes, fitness, _at(genomes, i), _at(fitness, i)))


def _generation(draws, fitness_fn: Callable, state: GAState, cfg: GAParams) -> GAState:
    state = _evolve_core(_generation_draws(draws, state, cfg), state, cfg)
    state = state._replace(fitness=fitness_fn(unstack_params(state.genomes)))
    return _update_best(state)


def _history(rows) -> list:
    return [{"generation": gen, "best_fitness": float(b), "mean_fitness": float(m),
             "diversity": float(d)} for gen, (b, m, d) in enumerate(rows)]


def _population_fitness(part, fitness_fn: Callable) -> Callable:
    """params [pop] → fitness [pop] through ``part``'s ``ga_scan``
    program: a fitness that names its replicated tensors has them copied
    to each device of a mesh."""
    if hasattr(fitness_fn, "core"):
        program = part.population_eval(fitness_fn.core, name="ga_scan")
        return lambda p: program(p, *fitness_fn.replicated)
    return part.population_eval(fitness_fn, name="ga_scan")


def run_ga(draws, fitness_fn: Callable, cfg: GAParams,
           seed_params: StrategyParams | None = None, partitioner=None, device=None):
    """The GA (`genetic_algorithm.py:254-291`): returns (best
    StrategyParams of CPU tensors, history list of per-generation records).

    ``draws`` is a ``torch.Generator`` or a draw provider (module
    docstring); ``fitness_fn`` maps params [pop] to fitness [pop] on
    ``device`` (default: the CUDA card), as `backtest_fitness` builds it.
    The generations run on the device with nothing read back until the one
    `host_read` at the end.  Given the same draws it follows
    `run_ga_legacy` genome for genome.  ``partitioner``: None (the single
    device), `parallel.get_partitioner()` or a `parallel.MeshPartitioner`,
    whose mesh splits each evaluation and gathers the fitness back onto
    its first device; another object raises ``TypeError``."""
    part = resolve_partitioner(partitioner)
    dev = part.home if part.device_count > 1 else resolve_device(device)
    draws = _provider(draws)
    cold = True
    if meshprof.active() is not None:
        seen = _GA_RUNS_SEEN.setdefault(fitness_fn, set())
        cold = cfg not in seen
        seen.add(cfg)
    # the population's fitness through the partitioner seam: its layout
    # card (population, pad) is recorded under the program's name
    evaluate = _population_fitness(part, fitness_fn)
    # the ga_scan cost card on the first carded run, and a watch window
    # from the first evaluation through the one sanctioned host_read
    with meshprof.watch("ga_scan", cold=cold):
        with devprof.carding("ga_scan", (seed_params,), note=devprof.NOTE_NO_DONATION,
                             device=dev) as card:
            state = _init_state(draws, evaluate, cfg, seed_params, dev)
            records = []
            for _ in range(cfg.generations):
                state = _generation(draws, evaluate, state, cfg)
                records.append(torch.stack([state.best_fitness, torch.mean(state.fitness),
                                            population_diversity(state.genomes)]))
            rows = torch.stack(records) if records else torch.zeros((0, 3), device=dev)
            card.result((state, rows))
        best, rows = host_read((state.best_genome, rows))
    return unstack_params(torch.from_numpy(best)), _history(rows)


def run_ga_legacy(draws, fitness_fn: Callable, cfg: GAParams,
                  seed_params: StrategyParams | None = None, device=None):
    """The host-driven generation loop: three scalars read back for the
    history every generation.  Kept as the counterpart of the JAX
    package's `run_ga_legacy`; product code calls `run_ga`."""
    dev = resolve_device(device)
    draws = _provider(draws)
    state = _init_state(draws, fitness_fn, cfg, seed_params, dev)
    rows = []
    for _ in range(cfg.generations):
        state = _generation(draws, fitness_fn, state, cfg)
        rows.append((float(state.best_fitness), float(torch.mean(state.fitness)),
                     float(population_diversity(state.genomes))))
    return unstack_params(state.best_genome.detach().cpu()), _history(rows)
