"""The port's Monte-Carlo engine and risk layer against the JAX package, on
the CPU.

    mc.engine (GBM, bootstrap, statistics, stress mode, correlated
    portfolio) · risk.var · risk.stops · risk.social · sim.scenarios

The simulators take the JAX package's own draws (`jax.random.normal` /
`randint` on the same key), injected, so both packages walk the same
paths.  Tolerances sit next to each assert.  The floats differ from the
jitted JAX programs only in the order of sums (means, cumsums, matrix
products) and in the fused multiply-adds XLA forms on the CPU, a few ulps
of float32; rtol 1e-5 covers that with room.  Where a value is a
difference of nearly equal numbers (a drawdown near 0), an atol of 1e-6
of its unit joins it.  The stops are elementwise, and the port rounds
XLA's fused multiply-adds there once as XLA does (`device.minus_product`),
so the adaptive stop and the trailing-stop state machine agree exactly.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.config import SocialRiskParams as JSocialRiskParams  # noqa: E402
from ai_crypto_trader_tpu.mc import engine as jmc  # noqa: E402
from ai_crypto_trader_tpu.risk import social as jsocial  # noqa: E402
from ai_crypto_trader_tpu.risk import stops as jstops  # noqa: E402
from ai_crypto_trader_tpu.risk import var as jvar  # noqa: E402
from ai_crypto_trader_tpu.sim import scenarios as jscen  # noqa: E402
from ai_crypto_trader_tpu_torch.config import SocialRiskParams  # noqa: E402
from ai_crypto_trader_tpu_torch.mc import engine as mc  # noqa: E402
from ai_crypto_trader_tpu_torch.risk import social, stops, var  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import scenarios  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def no_persistent_compile_cache():
    """This module's JAX references compile with the persistent compile
    cache off, as tests/test_trainer_service.py's do: a GBM reference that
    a run loaded from an entry another process wrote disagreed with the
    eager draws it was given (7.7 % of the paths beyond rtol 1e-5 in one
    run of six workers), while every compile in this process agrees with
    itself.  Nothing here needs the cache: each program compiles in well
    under a second."""
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def _returns(n=2048, seed=0):
    """The bench's MC inputs (bench.py:837-866), at their full length."""
    return np.random.default_rng(seed).normal(0.0002, 0.01, n).astype(np.float32)


def _close(got, ref, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# --- sim.scenarios: a copy of the JAX package's module --------------------

def test_scenarios_code_is_the_jax_package_code_byte_for_byte():
    def code(path):
        src = open(path, "rb").read()
        return src[src.index(b"from __future__ import annotations"):]

    mine = code(os.path.join(ROOT, "ai_crypto_trader_tpu_torch", "sim", "scenarios.py"))
    ref = code(os.path.join(ROOT, "ai_crypto_trader_tpu", "sim", "scenarios.py"))
    assert mine == ref


@pytest.mark.parametrize("name", ["flash_crash", "black_swan", "vol_regime_shift"])
def test_mc_schedule_draws_the_jax_package_schedule(name):
    for a, b in zip(scenarios.mc_schedule(name, 64, 29, seed=3),
                    jscen.mc_schedule(name, 64, 29, seed=3)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --- mc.engine --------------------------------------------------------------

def test_estimate_mu_sigma_uses_ddof_1():
    r = _returns()
    mu, sd = mc.estimate_mu_sigma(r, **CPU)
    jmu, jsd = jmc.estimate_mu_sigma(jnp.asarray(r))
    _close(mu, jmu, what="mu")
    _close(sd, jsd, what="sigma")
    _close(sd, np.std(r.astype(np.float64), ddof=1) * np.sqrt(252.0), rtol=1e-5)


@pytest.mark.parametrize("stress", [None, "flash_crash"])
def test_simulate_gbm_on_jax_draws(stress):
    key = jax.random.PRNGKey(7)
    sims, days = 512, 30
    shift = vol = None
    if stress:
        shift, vol = jscen.mc_schedule(stress, sims, days - 1, seed=1)
    ref = jmc.simulate_gbm(key, 40_000.0, jnp.float32(0.05), jnp.float32(0.6), days, sims,
                           shock_shift=None if shift is None else jnp.asarray(shift),
                           shock_vol=None if vol is None else jnp.asarray(vol))
    z = jax.random.normal(key, (sims, days - 1))
    got = mc.simulate_gbm(None, 40_000.0, 0.05, 0.6, days, sims, shock_shift=shift,
                          shock_vol=vol, z=np.asarray(z), **CPU)
    assert got.shape == ref.shape == (sims, days) and got.dtype == torch.float32
    assert bool((got[:, 0] == 40_000.0).all())
    # the same paths in float64 from the same draws: the port within float32
    # rounding of them, so a disagreement below is JAX's draws or JAX's
    # program, not the port's arithmetic
    zz = np.asarray(z, np.float64) * (1.0 if vol is None else vol)
    dt = np.float64(np.float32(1.0 / 252.0))           # mc.engine.PERIODS_PER_YEAR
    inc = (0.05 - 0.5 * 0.6 ** 2) * dt + 0.6 * np.sqrt(dt) * zz
    if shift is not None:
        inc = inc + shift
    truth = 40_000.0 * np.exp(np.concatenate([np.zeros((sims, 1)), np.cumsum(inc, -1)], -1))
    _close(got, truth, what="float64 paths from the same draws")
    _close(got, ref)


@pytest.mark.parametrize("log_returns", [True, False])
def test_simulate_bootstrap_on_jax_draws(log_returns):
    key = jax.random.PRNGKey(3)
    r = _returns(256)
    sims, days = 400, 30
    ref = jmc.simulate_bootstrap(key, 100.0, jnp.asarray(r), days, sims,
                                 log_returns=log_returns)
    idx = jax.random.randint(key, (sims, days - 1), 0, r.shape[-1])
    got = mc.simulate_bootstrap(None, 100.0, r, days, sims, log_returns=log_returns,
                                idx=np.asarray(idx), **CPU)
    _close(got, ref)


def test_path_statistics_on_the_same_paths():
    """Both packages' statistics of the JAX paths; 1,000 paths, so the
    drawdown median is the midpoint of two values."""
    paths = jmc.simulate_gbm(jax.random.PRNGKey(11), 40_000.0, jnp.float32(0.1),
                             jnp.float32(0.8), 30, 1000)
    ref = jmc.path_statistics(paths, 40_000.0, 0.95)
    got = mc.path_statistics(np.asarray(paths), 40_000.0, 0.95, **CPU)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        _close(got[k], ref[k], what=k)


def test_median_is_the_midpoint_with_an_even_count():
    x = np.asarray([4.0, 1.0, 3.0, 2.0, 10.0, 7.0], np.float32)
    m = mc.median(torch.from_numpy(x))
    assert float(m) == float(jnp.median(jnp.asarray(x))) == 3.5
    assert float(torch.median(torch.from_numpy(x))) == 3.0   # torch's lower middle
    rows = np.random.default_rng(2).normal(size=(5, 8)).astype(np.float32)
    np.testing.assert_array_equal(mc.median(torch.from_numpy(rows)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(rows), axis=-1)))


@pytest.mark.parametrize("q", [0.05, 0.5, [0.01, 0.25, 0.99]])
def test_quantile_follows_jnp_quantile(q):
    x = np.random.default_rng(4).normal(size=(3, 101)).astype(np.float32)
    got = mc.quantile(torch.from_numpy(x), q)
    ref = jnp.quantile(jnp.asarray(x), jnp.asarray(q, jnp.float32), axis=-1)
    _close(got, ref, rtol=1e-6, atol=0.0)
    x[1, 7] = np.nan
    got = mc.quantile(torch.from_numpy(x), q)
    assert bool(torch.isnan(got[..., 1]).all()) and not bool(torch.isnan(got[..., 0]).any())


@pytest.mark.parametrize("method,scenario,stress", [
    ("gbm", "base", None), ("gbm", "bear", None), ("bootstrap", "volatile", None),
    ("gbm", "base", "flash_crash"), ("bootstrap", "base", "black_swan")])
def test_run_simulation_on_jax_draws(method, scenario, stress):
    key = jax.random.PRNGKey(5)
    r = _returns()
    sims, days = 1000, 30
    ref = jmc.run_simulation(key, 40_000.0, r, days=days, num_sims=sims, scenario=scenario,
                             method=method, stress=stress, stress_seed=2)
    draws = ({"z": np.asarray(jax.random.normal(key, (sims, days - 1)))} if method == "gbm"
             else {"idx": np.asarray(jax.random.randint(key, (sims, days - 1), 0, r.size))})
    got = mc.run_simulation(None, 40_000.0, r, days=days, num_sims=sims, scenario=scenario,
                            method=method, stress=stress, stress_seed=2, **draws, **CPU)
    assert set(got) == set(ref)
    for k in ("scenario", "drift_factor", "volatility_factor", "stress"):
        assert got[k] == ref[k], k
    for k in ("paths", "percentile_prices", "var", "cvar", "expected_price",
              "expected_pct_change", "prob_profit", "prob_loss", "mu", "sigma",
              "max_drawdown_mean", "max_drawdown_median", "max_drawdown_max"):
        _close(got[k], ref[k], what=k)


def test_stress_var_cvar_on_jax_draws():
    key = jax.random.PRNGKey(9)
    r = _returns()
    ref = jvar.stress_var_cvar(key, 40_000.0, r, stress="flash_crash", num_sims=2048)
    z = np.asarray(jax.random.normal(key, (2048, 29)))
    got = var.stress_var_cvar(None, 40_000.0, r, stress="flash_crash", num_sims=2048, z=z,
                              **CPU)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v
        else:
            _close(got[k], v, what=k)
    assert got["stress_var_pct"] > got["var_pct"]   # the crash moves the tail


def test_correlated_portfolio_on_jax_draws():
    key = jax.random.PRNGKey(1)
    rng = np.random.default_rng(8)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    cov = (a @ a.T * 0.05 + np.eye(4, dtype=np.float32) * 0.02).astype(np.float32)
    prices = np.asarray([100.0, 40_000.0, 2_000.0, 1.0], np.float32)
    mus = np.asarray([0.1, 0.2, -0.05, 0.0], np.float32)
    w = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    ref = jmc.simulate_portfolio_correlated(key, jnp.asarray(prices), jnp.asarray(mus),
                                            jnp.asarray(cov), jnp.asarray(w), 30, 500)
    z = np.asarray(jax.random.normal(key, (500, 29, 4)))
    got = mc.simulate_portfolio_correlated(None, prices, mus, cov, w, 30, 500, z=z, **CPU)
    _close(got, ref)
    ps = mc.portfolio_stats(w, mus, [0.1, 0.2, 0.3, 0.4], [0.2, 0.3, 0.4, 0.5], **CPU)
    jps = jmc.portfolio_stats(jnp.asarray(w), jnp.asarray(mus), jnp.asarray([0.1, 0.2, 0.3, 0.4]),
                              jnp.asarray([0.2, 0.3, 0.4, 0.5]))
    for k in jps:
        _close(ps[k], jps[k], what=k)


def test_simulators_draw_from_the_generator_given():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = mc.run_simulation(g(), 100.0, _returns(64), num_sims=32, **CPU)
    b = mc.run_simulation(g(), 100.0, _returns(64), num_sims=32, **CPU)
    c = mc.run_simulation(torch.Generator().manual_seed(4), 100.0, _returns(64),
                          num_sims=32, **CPU)
    assert torch.equal(a["paths"], b["paths"]) and not torch.equal(a["paths"], c["paths"])
    boot = mc.run_simulation(g(), 100.0, _returns(64), num_sims=32, method="bootstrap", **CPU)
    assert boot["paths"].shape == (32, 30)
    with pytest.raises(ValueError, match="method"):
        mc.run_simulation(g(), 100.0, _returns(64), method="brownian", **CPU)


# --- risk.var ---------------------------------------------------------------

def _matrix(n=5, T=300, seed=6):
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 0.01, T)
    return np.stack([0.5 * base + rng.normal(0.0005 * i, 0.01 + 0.004 * i, T)
                     for i in range(n)]).astype(np.float32)


@pytest.mark.parametrize("confidence", [0.85, 0.90, 0.93, 0.95, 0.975, 0.99, 0.995])
def test_var_family_matches_jax(confidence):
    r = _matrix()
    for fn, jfn in ((var.historical_var, jvar.historical_var),
                    (var.parametric_var, jvar.parametric_var),
                    (var.cvar, jvar.cvar)):
        _close(fn(r, confidence, **CPU), jfn(jnp.asarray(r), confidence), what=fn.__name__)
    w = np.asarray([0.3, 0.25, 0.2, 0.15, 0.1], np.float32)
    _close(var.portfolio_var(w, r, confidence, **CPU),
           jvar.portfolio_var(jnp.asarray(w), jnp.asarray(r), confidence))


def test_interp3_is_jnp_interp():
    for c in np.linspace(0.8, 1.0, 41):
        ref = jnp.interp(jnp.float32(c), jnp.asarray([0.90, 0.95, 0.99]),
                         jnp.asarray([1.2816, 1.6449, 2.3263]))
        assert np.float32(var.interp3(c)) == np.float32(ref), c


def test_correlation_and_diversification_match_jax():
    r = _matrix()
    _close(var.correlation_matrix(r, **CPU), jvar.correlation_matrix(jnp.asarray(r)))
    w = np.asarray([0.3, 0.25, 0.2, 0.15, 0.1], np.float32)
    got = var.diversification_analysis(w, r, **CPU)
    ref = jvar.diversification_analysis(jnp.asarray(w), jnp.asarray(r))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], what=k)


@pytest.mark.parametrize("vols,cap,capital", [
    ([0.001, 0.02, 0.03, 0.04, 0.05, 0.06], 0.25, 1.0),     # one cap binds
    ([0.001, 0.0012, 0.03, 0.04, 0.05, 0.06, 0.07], 0.2, 5_000.0),  # two bind
    ([0.01, 0.01, 0.01, 0.01], 0.25, 1.0),                 # exactly at the cap
    ([0.02, 0.03, 0.05], 0.25, 1.0),                       # caps infeasible
])
def test_equal_risk_position_sizes_with_binding_caps(vols, cap, capital):
    v = np.asarray(vols, np.float32)
    got = var.equal_risk_position_sizes(v, capital, cap, **CPU)
    ref = jvar.equal_risk_position_sizes(jnp.asarray(v), capital, cap)
    _close(got, ref)
    assert float(got.max()) <= cap * capital * (1 + 1e-6)


# --- risk.stops -------------------------------------------------------------

def test_adaptive_stop_loss_matches_jax():
    entry = np.asarray([100.0, 40_000.0, 2.5, 7.0], np.float32)
    vol = np.asarray([0.0, 0.25, 0.5, 0.9], np.float32)
    sp, pct = stops.adaptive_stop_loss(entry, vol, **CPU)
    jsp, jpct = jstops.adaptive_stop_loss(jnp.asarray(entry), jnp.asarray(vol))
    # exact: the port rounds XLA's two fused multiply-adds once each
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(pct.numpy(), np.asarray(jpct))
    rng = np.random.default_rng(0)
    entry = rng.uniform(1.0, 50_000.0, 4096).astype(np.float32)
    vol = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    for a, b in zip(stops.adaptive_stop_loss(entry, vol, 1.5, 0.4, 2.5, **CPU),
                    jstops.adaptive_stop_loss(jnp.asarray(entry), jnp.asarray(vol), 1.5, 0.4, 2.5)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("strategy", stops.STRATEGIES)
def test_trailing_stop_over_a_price_sequence_matches_jax_exactly(strategy):
    """A [16, 8] grid of positions over 20 prices, every strategy: the same
    state, bit for bit, at every step."""
    rng = np.random.default_rng(12)
    entry = rng.uniform(50.0, 500.0, (16, 8)).astype(np.float32)
    moves = np.cumprod(1.0 + rng.normal(0.004, 0.02, (20, 16, 8)), axis=0)
    prices = (entry * moves).astype(np.float32)
    atr = (entry * 0.01).astype(np.float32)
    kw = dict(strategy=strategy, atr=atr, volatility=entry * np.float32(0.02))
    st = stops.trailing_stop_init(entry, entry * np.float32(0.97), **CPU)
    jst = jstops.trailing_stop_init(jnp.asarray(entry), jnp.asarray(entry) * 0.97)
    fired = adjusted = 0
    for p in prices:
        st, trig = stops.trailing_stop_update(st, p, **kw, **CPU)
        jst, jtrig = jstops.trailing_stop_update(jst, jnp.asarray(p), **kw)
        for f in stops.TrailingStopState._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(jst, f)), err_msg=f)
        np.testing.assert_array_equal(trig.numpy(), np.asarray(jtrig))
        fired += int(trig.sum())
    adjusted = int(st.n_adjustments.sum())
    assert adjusted > 0 and fired > 0, (adjusted, fired)   # not vacuous
    with pytest.raises(ValueError, match="strategy"):
        stops.trailing_stop_update(st, prices[0], strategy="chandelier", **CPU)


# --- risk.social ------------------------------------------------------------

def _snapshot(level, quality=0.9, n=12, seed=0):
    rng = np.random.default_rng(seed)
    s = np.clip(rng.normal(level, 0.05, (n, 4)), 0.0, 1.0).astype(np.float32)
    age = rng.uniform(0.0, 48.0, n).astype(np.float32)
    return (s, age, np.float32(quality))


@pytest.mark.parametrize("level,quality", [(0.9, 0.9), (0.1, 0.9), (0.5, 0.9),
                                           (0.9, 0.3), (0.66, 0.5)])
def test_social_risk_adjustment_matches_jax(level, quality):
    s, age, q = _snapshot(level, quality)
    got = social.social_risk_adjustment(social.SocialSnapshot(s, age, q), **CPU)
    ref = jsocial.social_risk_adjustment(jsocial.SocialSnapshot(
        jnp.asarray(s), jnp.asarray(age), jnp.asarray(q)))
    assert set(got) == set(ref)
    for k in ref:
        if k == "data_quality_ok":
            assert bool(got[k]) == bool(ref[k])
        else:
            _close(got[k], ref[k], what=k)
    if quality < SocialRiskParams().min_data_quality:
        # the data-quality gate: exact neutrality
        for k in ("position_size_factor", "stop_loss_factor", "take_profit_factor",
                  "correlation_limit_factor"):
            assert float(got[k]) == 1.0, k
        assert float(got["intensity"]) == 0.0


def test_weighted_sentiment_and_params_match_jax():
    s, age, q = _snapshot(0.7, seed=3)
    w = (0.5, 0.2, 0.2, 0.1)
    got = social.weighted_sentiment(social.SocialSnapshot(s, age, q), w, 3.0, **CPU)
    ref = jsocial.weighted_sentiment(jsocial.SocialSnapshot(
        jnp.asarray(s), jnp.asarray(age), jnp.asarray(q)), w, 3.0)
    _close(got, ref)
    off = SocialRiskParams(enabled=False)
    got = social.social_risk_adjustment(social.SocialSnapshot(s, age, q), off, **CPU)
    ref = jsocial.social_risk_adjustment(jsocial.SocialSnapshot(
        jnp.asarray(s), jnp.asarray(age), jnp.asarray(q)), JSocialRiskParams(enabled=False))
    assert float(got["position_size_factor"]) == float(ref["position_size_factor"]) == 1.0
