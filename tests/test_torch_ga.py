"""The port's GA (evolve/) against the JAX package's, on the CPU.

`jax.random` streams cannot be replayed in PyTorch, so the port's GA takes
its draws from a provider.  `JaxDraws` below makes them with `jax.random`
from a key, consuming the key exactly as the JAX package's `_init_genomes`
(ga.py:236-248) and `run_ga_legacy` (:323-325) do, and each generation's
six draws exactly as `_evolve_core` (:140-161) and `tournament`
(selection.py:27) do; the mutation noise is erfinv(u) of the uniform that
`jax.random.normal` draws (the port folds normal's √2 into the span, as
the compiled JAX program does).  Given those draws:

  * `tournament`, `quantile_split` and `_evolve_core` are bit-equal to the
    JAX functions (a tie in fitness included: both rank stably and pick the
    first of equal tournament candidates);
  * `backtest_fitness` agrees at rtol 1e-5 (the engine's tolerance on the
    stats it combines) and `population_diversity` at rtol 1e-6;
  * `run_ga` follows JAX's `run_ga_legacy` genome for genome after every
    generation, with the same best genome and the history at rtol 1e-5.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from ai_crypto_trader_tpu.backtest import default_params as jax_default_params  # noqa: E402
from ai_crypto_trader_tpu.backtest import strategy as jst  # noqa: E402
from ai_crypto_trader_tpu.config import GAParams as JaxGAParams  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.evolve import ga as jga  # noqa: E402
from ai_crypto_trader_tpu.evolve import selection as jsel  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import default_params  # noqa: E402
from ai_crypto_trader_tpu_torch.config import GAParams  # noqa: E402
from ai_crypto_trader_tpu_torch.evolve import ga as tga  # noqa: E402
from ai_crypto_trader_tpu_torch.evolve import selection as tsel  # noqa: E402

T = 1024
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_erf_inv = jax.jit(lax.erf_inv)


def generation_draws(key, pop, n_children, k, n_params, cfg):
    """The six draws of ga.py:140-161 from one generation key, as NumPy."""
    k_sel, k_cross, k_mut, k_scale = jax.random.split(key, 4)
    u = jax.random.uniform(k_scale, (n_children, n_params), jnp.float32, _LO, 1.0)
    draws = (jax.random.randint(k_sel, (n_children, k), 0, pop),
             jax.random.randint(jax.random.fold_in(k_sel, 1), (n_children, k), 0, pop),
             jax.random.uniform(k_cross, (n_children, 1)) < cfg.crossover_rate,
             jax.random.bernoulli(jax.random.fold_in(k_cross, 1), 0.5, (n_children, n_params)),
             _erf_inv(u),
             jax.random.bernoulli(k_mut, cfg.mutation_rate, (n_children, n_params)))
    return tuple(np.asarray(x) for x in draws)


class JaxDraws:
    """A draw provider fed by `jax.random`, consuming ``key`` as the JAX
    package's `_init_genomes` and `run_ga_legacy` do."""

    def __init__(self, key):
        self.key = key

    def init(self, pop):
        k_init, self.key = jax.random.split(self.key)
        return np.asarray(jst.stack_params(jst.sample_params(k_init, pop)))

    def generation(self, pop, n_children, k, n_params, cfg):
        self.key, k_gen = jax.random.split(self.key)
        return generation_draws(k_gen, pop, n_children, k, n_params, cfg)


def _jax_cfg(cfg):
    return JaxGAParams(**cfg.__dict__)


@pytest.fixture(scope="module")
def candles():
    return {k: v[:T] for k, v in generate_ohlcv(n=T, seed=3).items() if k != "regime"}


def _genomes(pop, seed):
    return np.asarray(jst.stack_params(jst.sample_params(jax.random.PRNGKey(seed), pop)))


def test_tournament_and_quantile_split():
    rng = np.random.default_rng(4)
    fit = rng.normal(size=24).astype(np.float32)
    fit[[2, 9, 17]] = fit.max()                       # ties at the top
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsel.tournament(key, jnp.asarray(fit), 3, 40))
    cand = np.asarray(jax.random.randint(key, (40, 3), 0, 24))
    got = tsel.tournament(torch.from_numpy(np.array(cand)).long(), torch.from_numpy(fit))
    np.testing.assert_array_equal(got.numpy(), ref)
    for frac in (0.0, 0.25, 0.5):
        rb, rt, rn = jsel.quantile_split(jnp.asarray(fit), frac)
        gb, gt, gn = tsel.quantile_split(torch.from_numpy(fit), frac)
        assert gn == rn
        np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))


@pytest.mark.parametrize("pop", [8, 16])
def test_population_diversity(pop):
    g = _genomes(pop, 1)
    ref = float(jga.population_diversity(jnp.asarray(g)))
    got = float(tga.population_diversity(convert.genomes_from_numpy(g, device="cpu")))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("pop,tie", [(8, False), (16, True), (64, True)])
def test_evolve_core_bit_equal_given_jax_draws(pop, tie):
    cfg = GAParams(population_size=pop)
    g = _genomes(pop, pop)
    fit = np.random.default_rng(pop).normal(size=pop).astype(np.float32)
    if tie:                      # equal fitness, as genomes without trades have
        fit[[1, 4, 6]] = fit.max()
        fit[[0, 3]] = fit.min()
    key = jax.random.PRNGKey(100 + pop)
    state = jga.GAState(jnp.asarray(g), jnp.asarray(fit), jnp.asarray(g[0]), jnp.float32(0.0))
    ref = np.asarray(jga.evolve_step(key, state, _jax_cfg(cfg)).genomes)
    tstate = tga.GAState(convert.genomes_from_numpy(g, device="cpu"), torch.from_numpy(fit),
                         torch.from_numpy(g[0].copy()), torch.tensor(0.0))
    raw = generation_draws(key, pop, pop - cfg.elite_size, cfg.tournament_size, g.shape[1], cfg)
    draws = tga._generation_draws(_Fixed(raw), tstate, cfg)
    got = tga._evolve_core(draws, tstate, cfg).genomes.numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


class _Fixed:
    def __init__(self, draws):
        self.draws = draws

    def generation(self, *args):
        return self.draws


def test_backtest_fitness(candles):
    pop = jst.sample_params(jax.random.PRNGKey(6), 12)
    ref = jax.jit(jax.vmap(jga.backtest_fitness({k: jnp.asarray(v) for k, v in candles.items()})))(pop)
    fit = tga.backtest_fitness(candles, device="cpu")
    got = fit(convert.params_from_numpy(pop, device="cpu"))
    assert got.shape == (12,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert fit.tables is not None and fit.device == torch.device("cpu")


def test_run_ga_follows_jax_legacy(candles, monkeypatch):
    """The same genomes after every generation, the same best genome, the
    history at rtol 1e-5 — and one `host_read` for the whole run."""
    cfg = GAParams(population_size=8, generations=3, elite_size=2)
    key = jax.random.PRNGKey(4)
    seen = {"jax": [], "port": [], "reads": 0}
    jax_step, port_core, read = jga.evolve_step, tga._evolve_core, tga.host_read

    def jax_recording(k, state, c):
        out = jax_step(k, state, c)
        seen["jax"].append(np.asarray(out.genomes))
        return out

    def port_recording(draws, state, c):
        out = port_core(draws, state, c)
        seen["port"].append(out.genomes.numpy().copy())
        return out

    def counting_read(tree):
        seen["reads"] += 1
        return read(tree)

    monkeypatch.setattr(jga, "evolve_step", jax_recording)
    monkeypatch.setattr(tga, "_evolve_core", port_recording)
    monkeypatch.setattr(tga, "host_read", counting_read)
    jfit = jga.backtest_fitness({k: jnp.asarray(v) for k, v in candles.items()})
    b_ref, h_ref = jga.run_ga_legacy(key, jfit, _jax_cfg(cfg), seed_params=jax_default_params())
    b_got, h_got = tga.run_ga(JaxDraws(key), tga.backtest_fitness(candles, device="cpu"), cfg,
                              seed_params=default_params(device="cpu"), device="cpu")
    assert seen["reads"] == 1
    assert len(seen["port"]) == len(seen["jax"]) == cfg.generations
    for gen, (g, r) in enumerate(zip(seen["port"], seen["jax"])):
        np.testing.assert_array_equal(g, r, err_msg=f"generation {gen}")
    for f in b_ref._fields:
        assert float(getattr(b_got, f)) == float(getattr(b_ref, f)), f
    assert len(h_got) == len(h_ref) == cfg.generations
    for hg, hr in zip(h_got, h_ref):
        assert hg["generation"] == hr["generation"]
        for k in ("best_fitness", "mean_fitness", "diversity"):
            np.testing.assert_allclose(hg[k], hr[k], rtol=1e-5, atol=1e-6, err_msg=k)
    best = [h["best_fitness"] for h in h_got]
    assert all(b2 >= b1 for b1, b2 in zip(best, best[1:]))     # elitism


def test_run_ga_with_a_generator_and_the_legacy_loop(candles, monkeypatch):
    """The default provider (a torch.Generator): the same run twice gives
    the same result; `run_ga_legacy` on the same draws gives run_ga's."""
    cfg = GAParams(population_size=6, generations=2, elite_size=2)
    fit = tga.backtest_fitness(candles, device="cpu")
    runs = [tga.run_ga(torch.Generator().manual_seed(11), fit, cfg, device="cpu")
            for _ in range(2)]
    legacy = tga.run_ga_legacy(torch.Generator().manual_seed(11), fit, cfg, device="cpu")
    for best, hist in runs[1:] + [legacy]:
        for a, b in zip(best, runs[0][0]):
            assert torch.equal(a, b)
        assert hist == runs[0][1]
    for name, (lo, hi, _) in zip(tga.StrategyParams._fields, jst.PARAM_RANGES.values()):
        assert lo <= float(getattr(runs[0][0], name)) <= hi, name


def test_cli_evolve_on_the_cpu(capsys):
    from ai_crypto_trader_tpu_torch import cli

    cli.main(["evolve", "--days", "1", "--population", "6", "--generations", "2",
              "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert len(out["history"]) == 2 and out["device"] == "cpu"
    assert set(out["best_params"]) == set(tga.StrategyParams._fields)
    assert all(np.isfinite(h["best_fitness"]) for h in out["history"])
