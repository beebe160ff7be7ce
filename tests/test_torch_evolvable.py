"""The port's evolvable strategy (backtest/evolvable.py) against the JAX
package's, on the CPU, at T = 1024 candles and a population of 16.

  * Period tables: the rolling rows (bb_mid, vol_ma_fill) bit for bit; the
    EWMA rows (ema, rsi, atr and the ATR medians) at rtol 2e-5, atol 1e-3
    against the jitted JAX build (XLA contracts some scan combines into
    fused multiply-adds; tests/test_torch_dynamic.py holds them bit for bit
    against the JAX program run op by op); bb_sd at rtol 2e-3 of the
    float64 std (the cancelling second moment, test_torch_dynamic.py).
  * Signals: exactly equal.  Strength at atol 0.5 on its 0-100 scale, the
    bound tests/test_evolve.py:128-140 gives the JAX package's own two
    paths: %B divides by the Bollinger band width, which amplifies a
    last-bit difference of sd where sd → 0.  Volatility and the SL/TP rows
    at rtol 2e-5 (ATR's tolerance).
  * Backtest stats of `population_backtest` (direct and tabled) and
    `evolvable_fused_backtest` against JAX's three paths, the pins of
    tests/test_evolve.py:109-146: counts exact, floats at the engine's
    tolerance (rtol 1e-5, atol 1e-6; tests/test_torch_backtest.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_backtest import assert_stats_equal  # noqa: E402

from ai_crypto_trader_tpu.backtest import evolvable as jev  # noqa: E402
from ai_crypto_trader_tpu.backtest import sample_params  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import evolvable as tev  # noqa: E402

T, POP = 1024, 16
ROLLING_LEAVES = {"bb_mid", "vol_ma_fill"}
EWMA_LEAVES = {"ema_raw", "ema_fill", "rsi_fill", "atr_fill", "atr_median"}


@pytest.fixture(scope="module")
def market():
    d = {k: v[:T] for k, v in generate_ohlcv(n=T, seed=3).items() if k != "regime"}
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    pop = sample_params(jax.random.PRNGKey(5), POP)
    return {"d": d, "jd": jd, "pop": pop,
            "tpop": convert.params_from_numpy(pop, device="cpu"),
            "jtab": jev.build_indicator_tables(jd),
            "ttab": tev.build_indicator_tables(d, device="cpu")}


def _one(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# the JAX package jits these inside its own callers; run op by op they take
# a compile per op
_jax_signal = jax.jit(jev.evolvable_signal)


def _std_truth(x, w):
    win = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), w)
    return np.concatenate([np.full(w - 1, np.nan), win.std(-1)])


def test_every_table_leaf_matches(market):
    jtab, ttab = market["jtab"], market["ttab"]
    assert ttab._fields == jtab._fields
    for f in jtab._fields:
        got, ref = getattr(ttab, f).numpy(), np.asarray(getattr(jtab, f))
        assert got.shape == ref.shape and got.dtype == ref.dtype, f
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=f)
        if f in ROLLING_LEAVES:
            np.testing.assert_array_equal(got, ref, err_msg=f)
        elif f in EWMA_LEAVES:
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3, err_msg=f)
    close = market["d"]["close"]
    for i, w in enumerate(range(tev._BB_LO, tev._BB_HI + 1)):
        truth = _std_truth(close, w)
        np.testing.assert_allclose(ttab.bb_sd[i].numpy(), truth, rtol=2e-3)
        np.testing.assert_allclose(np.asarray(jtab.bb_sd[i]), truth, rtol=2e-3)
    assert ttab.ema_raw.shape == (tev._EMA_HI - tev._EMA_LO + 1, T) == (96, T)


def test_median_is_the_jax_median():
    rng = np.random.default_rng(0)
    for n in (7, 8, 1024):
        x = rng.normal(size=(3, n)).astype(np.float32)
        x[2, 3] = np.nan
        got = tev.median(torch.from_numpy(x)).numpy()
        ref = np.asarray(jax.jit(lambda v: jnp.median(v, axis=-1))(jnp.asarray(x)))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _assert_signal(got, ref):
    signal, strength, vol = (g.numpy() for g in got)
    assert signal.dtype == np.int32
    np.testing.assert_array_equal(signal, np.asarray(ref[0]))
    np.testing.assert_allclose(strength, np.asarray(ref[1]), atol=0.5)
    np.testing.assert_allclose(vol, np.asarray(ref[2]), rtol=2e-5, atol=1e-9)
    assert set(np.unique(signal)) == {-1, 0, 1}


@pytest.mark.parametrize("tabled", [False, True])
def test_signal_and_inputs_one_genome_and_population(market, tabled):
    jtab = market["jtab"] if tabled else None
    ttab = market["ttab"] if tabled else None
    for i in (0, 7):
        ref = _jax_signal(market["jd"], _one(market["pop"], i), tables=jtab)
        got = tev.evolvable_signal(market["d"], convert.params_from_numpy(
            _one(market["pop"], i), device="cpu"), tables=ttab, device="cpu")
        assert got[0].shape == (T,)
        _assert_signal(got, ref)
    # the population as the leading dimension, where JAX vmaps
    ref = jax.jit(jax.vmap(lambda p: jev.evolvable_inputs(market["jd"], p, tables=jtab)))(
        market["pop"])
    got = tev.evolvable_inputs(market["d"], market["tpop"], tables=ttab, device="cpu")
    for f in ("close", "volume", "confidence"):
        assert getattr(got, f).shape == (T,), f
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f))[0],
                                   rtol=1e-6, err_msg=f)
    for f in ("signal", "decision"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(got.strength.numpy(), np.asarray(ref.strength), atol=0.5)
    for f in ("volatility", "sl_pct", "tp_pct"):
        assert getattr(got, f).shape == (POP, T), f
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=2e-5, atol=1e-9, err_msg=f)


def test_population_backtest_three_paths(market):
    """tests/test_evolve.py:109-146's pins, port against JAX path by path.
    (The port's tabled `population_backtest` and `evolvable_fused_backtest`
    are both `evolvable_backtest` with tables, so they are held to JAX's
    two tabled paths, not to each other.)"""
    jd, d, pop, tpop = market["jd"], market["d"], market["pop"], market["tpop"]
    direct = jev.population_backtest(jd, pop)
    tabled = jev.population_backtest(jd, pop, tables=market["jtab"])
    fused = jax.jit(jax.vmap(lambda p: jev.evolvable_fused_backtest(jd, p, market["jtab"])))(pop)
    t_direct = tev.population_backtest(d, tpop, device="cpu")
    t_tabled = tev.population_backtest(d, tpop, tables=market["ttab"], device="cpu")
    t_fused = tev.evolvable_fused_backtest(d, tpop, market["ttab"], device="cpu")
    for ref, got in ((direct, t_direct), (tabled, t_tabled), (fused, t_fused)):
        assert got.total_trades.shape == (POP,)
        assert_stats_equal(ref, got)
    assert int(np.sum(np.asarray(direct.total_trades))) > 0
    # JAX's own tables, carried over, give JAX's tabled stats too
    jtab = convert.tables_from_numpy(market["jtab"], device="cpu")
    assert_stats_equal(tabled, tev.population_backtest(d, tpop, tables=jtab, device="cpu"))


def test_one_genome_backtest(market):
    p0 = _one(market["pop"], 3)
    ref = jev.evolvable_backtest(market["jd"], p0, tables=market["jtab"])
    got = tev.evolvable_backtest(market["d"], convert.params_from_numpy(p0, device="cpu"),
                                 tables=market["ttab"], device="cpu")
    assert got.total_trades.shape == ()
    assert_stats_equal(ref, got)


def test_social_branch(market):
    rng = np.random.default_rng(2)
    soc = (rng.uniform(30, 90, T), rng.uniform(0, 60_000, T), rng.uniform(0, 25_000, T))
    soc = [s.astype(np.float32) for s in soc]
    jsoc = jev.SocialInputs(*(jnp.asarray(s) for s in soc))
    tsoc = tev.SocialInputs(*(torch.from_numpy(s) for s in soc))
    for i in (1, 9):
        p = _one(market["pop"], i)
        ref = _jax_signal(market["jd"], p, social=jsoc)
        got = tev.evolvable_signal(market["d"], convert.params_from_numpy(p, device="cpu"),
                                   social=tsoc, device="cpu")
        _assert_signal(got, ref)
        plain = tev.evolvable_signal(market["d"], convert.params_from_numpy(p, device="cpu"),
                                     device="cpu")
        assert (plain[0] != got[0]).any()          # the social votes are live
    ref = jev.population_backtest(market["jd"], market["pop"], social=jsoc)
    got = tev.population_backtest(market["d"], market["tpop"], social=tsoc, device="cpu")
    assert_stats_equal(ref, got)


def test_constant_price_series():
    """Zero Bollinger range and zero ATR: no trades, a finite balance, the
    fused path equal to the direct one (the JAX package's probe)."""
    flat = np.full(300, 100.0, np.float32)
    d = {"open": flat, "high": flat, "low": flat, "close": flat,
         "volume": np.full(300, 25.0, np.float32)}
    p = convert.params_from_numpy(sample_params(jax.random.PRNGKey(1), 4), device="cpu")
    tab = tev.build_indicator_tables(d, device="cpu")
    direct = tev.population_backtest(d, p, device="cpu")
    fused = tev.evolvable_fused_backtest(d, p, tab, device="cpu")
    for a, b in zip(direct, fused):
        assert torch.equal(a, b)
    assert (direct.total_trades == 0).all()
    assert torch.isfinite(direct.final_balance).all()
