"""The port's indicator table (ops/indicators.py) against the JAX package's
`compute_indicators`, all 21 columns, on the CPU.

On the CPU the EMA family runs the fused EWMA's plain version.  Tolerances:

  * NaN masks: exactly equal.
  * ema_12, ema_26, rsi, atr: rtol 2e-5, atol 1e-3 (tests/test_pallas.py:23:
    the JAX program rounds its scans in its own fused order).
  * macd, macd_signal, macd_diff: the same, plus an absolute term of
    2e-6·|close|.  MACD is the difference of two EMAs of the close, so the
    two EMAs' rounding — relative to the close, one float32 ulp of a
    40,000 price is 0.004 — survives the cancellation while |macd| itself
    can be near 0.  2e-6·|close| is ~16 ulps of the close.
  * every other column: rtol 1e-5, with two looser atols, for the two
    columns that carry the rolling std: bb_width 3e-5 (widths ~1e-2) and
    bb_position 1e-3.  The std comes from the centred second moment
    m2 - m², which cancels: the series mean it is centred on is summed in
    another order here than in the JAX program, and that ulp is amplified
    by (x - mean)²/var in quiet windows.  Both bounds are 5× the largest
    difference measured over eight series of 150 to 2100 candles.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.ops import compute_indicators as jax_indicators  # noqa: E402
from ai_crypto_trader_tpu_torch import ops  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import INDICATOR_NAMES, compute_indicators  # noqa: E402

EMA_COLUMNS = {"ema_12", "ema_26", "rsi", "atr"}
MACD_COLUMNS = {"macd", "macd_signal", "macd_diff"}
ATOL = {"bb_width": 3e-5, "bb_position": 1e-3}


def _ohlcv(n, seed=3):
    return {k: v for k, v in generate_ohlcv(n=n, seed=seed).items() if k != "regime"}


def _constant(n):
    flat = np.full(n, 100.0, np.float32)
    return {"open": flat, "high": flat, "low": flat, "close": flat,
            "volume": np.full(n, 25.0, np.float32)}


def assert_table_close(got, ref, close):
    assert set(INDICATOR_NAMES) <= set(got)
    for k in INDICATOR_NAMES:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
        if k in EMA_COLUMNS:
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-3, err_msg=k)
        elif k in MACD_COLUMNS:
            bound = 1e-3 + 2e-5 * np.abs(r) + 2e-6 * np.abs(close)
            ok = (np.abs(g - r) <= bound) | (np.isnan(g) & np.isnan(r))
            assert ok.all(), (k, np.nanmax(np.abs(g - r)))
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=ATOL.get(k, 0.0),
                                       err_msg=k)


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("n", [800, 2100])
def test_all_columns_match_jax(n, fill):
    d = _ohlcv(n)
    ref = jax_indicators({k: jnp.asarray(v) for k, v in d.items()}, fill=fill)
    got = compute_indicators(d, fill=fill, device="cpu")
    assert_table_close(got, ref, d["close"])
    for k in ("open", "high", "low", "close", "volume"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    if fill:
        assert not any(np.isnan(got[k].numpy()).any() for k in INDICATOR_NAMES)


@pytest.mark.parametrize("fill", [False, True])
def test_series_shorter_than_the_longest_window(fill):
    d = _ohlcv(150, seed=11)
    ref = jax_indicators({k: jnp.asarray(v) for k, v in d.items()}, fill=fill)
    got = compute_indicators(d, fill=fill, device="cpu")
    assert_table_close(got, ref, d["close"])
    expect = 0.0 if fill else np.nan
    np.testing.assert_array_equal(got["sma_200"].numpy(), np.full(150, expect, np.float32))


@pytest.mark.parametrize("fill", [False, True])
def test_constant_price_series(fill):
    """Zero Bollinger range and zero ATR: %B and the stochastics are NaN
    (then filled), RSI is 50."""
    d = _constant(400)
    ref = jax_indicators({k: jnp.asarray(v) for k, v in d.items()}, fill=fill)
    got = compute_indicators(d, fill=fill, device="cpu")
    assert_table_close(got, ref, d["close"])
    assert float(got["atr"][-1]) == 0.0 and float(got["rsi"][-1]) == 50.0


def test_batched_rows_match_single_series():
    d = {k: np.stack([v, v[::-1].copy()]) for k, v in _ohlcv(600).items()}
    got = compute_indicators(d, device="cpu")
    for b in range(2):
        one = compute_indicators({k: v[b] for k, v in d.items()}, device="cpu")
        for k in INDICATOR_NAMES:
            np.testing.assert_array_equal(got[k][b].numpy(), one[k].numpy(), err_msg=k)


@pytest.mark.parametrize("name,args", [
    ("rolling_sum", (20,)), ("rolling_mean", (50,)), ("rolling_max", (14,)),
    ("rolling_min", (26,)), ("ema", (12,)),
    ("roc", (12,)),
])
def test_single_series_functions_match_jax(name, args):
    import torch

    from ai_crypto_trader_tpu.ops import indicators as jind

    close = _ohlcv(700)["close"]
    got = getattr(ops, name)(torch.from_numpy(close.copy()), *args).numpy()
    # compiled, as compute_indicators is: XLA's rewrites are the rounding
    # the port follows
    ref = np.asarray(jax.jit(lambda x: getattr(jind, name)(x, *args))(jnp.asarray(close)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("n", [700, 2100])
def test_rolling_std_as_accurate_as_the_jax_package(n):
    """m2 - m² cancels in float32: the JAX package's own rolling std is
    ~1e-3 off the float64 std in quiet windows.  The port's must be within
    2e-3 of it too, with the same NaN mask."""
    import torch

    from ai_crypto_trader_tpu.ops import indicators as jind

    close = _ohlcv(n)["close"]
    got = ops.rolling_std(torch.from_numpy(close.copy()), 20).numpy()
    ref = np.asarray(jax.jit(lambda x: jind.rolling_std(x, 20))(jnp.asarray(close)))
    windows = np.lib.stride_tricks.sliding_window_view(close.astype(np.float64), 20)
    truth = np.concatenate([np.full(19, np.nan), windows.std(-1)])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, truth, rtol=2e-3)
    np.testing.assert_allclose(ref, truth, rtol=2e-3)


def test_oscillators_and_fill_match_jax():
    import torch

    from ai_crypto_trader_tpu.ops import indicators as jind

    d = _ohlcv(500)
    t = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    pairs = [
        (ops.rsi(t["close"]), jind.rsi(j["close"])),
        (ops.atr(t["high"], t["low"], t["close"]), jind.atr(j["high"], j["low"], j["close"])),
        (ops.williams_r(t["high"], t["low"], t["close"]),
         jind.williams_r(j["high"], j["low"], j["close"])),
        (ops.vwap(t["high"], t["low"], t["close"], t["volume"]),
         jind.vwap(j["high"], j["low"], j["close"], j["volume"])),
        (ops.obv(t["close"], t["volume"]), jind.obv(j["close"], j["volume"])),
        *zip(ops.stochastic(t["high"], t["low"], t["close"]),
             jind.stochastic(j["high"], j["low"], j["close"])),
        *zip(ops.ichimoku(t["high"], t["low"]), jind.ichimoku(j["high"], j["low"])),
        *zip(ops.bollinger(t["close"])[:3], jind.bollinger(j["close"])[:3]),
    ]
    for got, ref in pairs:
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-3)
    x = np.array([np.nan, 1, np.nan, np.nan, 4, np.nan], np.float32)
    for fn in ("ffill", "bfill", "nanfill"):
        np.testing.assert_array_equal(
            getattr(ops.indicators, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jind, fn)(jnp.asarray(x))), err_msg=fn)
