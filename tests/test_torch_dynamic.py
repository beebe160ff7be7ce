"""The port's indicators with tensor periods (ops/dynamic.py) against the
JAX package's `ops/dynamic.py`, on the CPU.

Each function runs at periods across its range, one period at a time and
as a whole period grid at once (a column [n, 1] of periods over a [T]
series, the port's form of the JAX package's `vmap` over `_grid`).

  * Rolling sum/mean/max/min: bit for bit against the jitted JAX function
    (the port adds the lagged copies in the JAX loop's order, and divides
    by the period truly, as XLA divides by a traced value).
  * The EMA family (EMA, MACD, RSI, ATR), through `fused_ewma_plain` on the
    CPU: bit for bit against the JAX function run op by op
    (`jax.disable_jit`), whose scan rounds every combine apart as the plain
    version does; against the jitted JAX function at rtol 2e-5, atol 1e-3
    (tests/test_pallas.py:23), because XLA's CPU compiler contracts some of
    the scan's combines into fused multiply-adds.  MACD carries the
    cancellation of two EMAs: an absolute 2e-6·|close| more
    (tests/test_torch_indicators.py).
  * Rolling std and the Bollinger bands: the std is the centred second
    moment m2 - m², which cancels.  The JAX program sums the series mean in
    its own order and the port in float64, so an ulp of the centring is
    amplified in quiet windows: both are held to the float64 std of each
    window at rtol 2e-3 (as test_torch_indicators.py holds the static
    one), and %B at atol 1e-3 (test_torch_indicators.py's bound).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.ops import dynamic as jdyn  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import dynamic as tdyn  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import ewma  # noqa: E402

T = 1024
T_EAGER = 256     # the op-by-op JAX runs compile every op at every shape


@pytest.fixture(scope="module")
def candles():
    return {k: v[:T] for k, v in generate_ohlcv(n=T, seed=3).items() if k != "regime"}


def _head(candles, n):
    return {k: v[:n] for k, v in candles.items()}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_rows(fn, periods, eager):
    """The JAX function over a period grid, as the JAX package's tables
    compute it: vmap over float32 periods, jitted or op by op."""
    grid = jnp.asarray(periods, jnp.float32)
    if eager:
        with jax.disable_jit():
            return np.asarray(jax.vmap(fn)(grid))
    return np.asarray(jax.jit(jax.vmap(fn))(grid))


def assert_bits(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def assert_close(got, ref, rtol=2e-5, atol=1e-3, extra=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = (np.abs(got - ref) <= atol + rtol * np.abs(ref) + extra) | np.isnan(ref)
    assert ok.all(), np.nanmax(np.abs(got - ref))


ROLLING = {"rolling_sum_dyn": 30, "rolling_mean_dyn": 30,
           "rolling_max_dyn": 30, "rolling_min_dyn": 30}


@pytest.mark.parametrize("name", sorted(ROLLING))
def test_rolling_reductions_bit_for_bit(candles, name):
    wmax = ROLLING[name]
    x = candles["high"]
    periods = np.arange(5, wmax + 1)
    jfn, tfn = getattr(jdyn, name), getattr(tdyn, name)
    ref = _jax_rows(lambda w: jfn(jnp.asarray(x), w, wmax), periods, eager=False)
    assert_bits(tfn(_t(x), _t(periods)[:, None], wmax), ref)        # the grid at once
    for w in (5, 17, wmax):                                          # one period
        one = np.asarray(jax.jit(lambda v: jfn(jnp.asarray(x), v, wmax))(jnp.float32(w)))
        assert_bits(tfn(_t(x), _t(w), wmax), one)


def _ewma_cases(candles):
    close, high, low = (candles[k] for k in ("close", "high", "low"))
    jc, jh, jl = (jnp.asarray(v) for v in (close, high, low))
    tc, th, tl = (_t(v) for v in (close, high, low))
    return {
        "ema": (lambda w: jdyn.ema_dyn(jc, w), lambda w: tdyn.ema_dyn(tc, w),
                np.arange(5, 101)),
        "rsi": (lambda w: jdyn.rsi_dyn(jc, w), lambda w: tdyn.rsi_dyn(tc, w),
                np.arange(5, 31)),
        "atr": (lambda w: jdyn.atr_dyn(jh, jl, jc, w), lambda w: tdyn.atr_dyn(th, tl, tc, w),
                np.arange(7, 26)),
    }


@pytest.mark.parametrize("name", ["ema", "rsi", "atr"])
def test_ewma_family_grid(candles, name):
    jfn, tfn, periods = _ewma_cases(candles)[name]
    got = tfn(_t(periods)[:, None]).numpy()
    assert got.shape == (len(periods), T)
    assert_close(got, _jax_rows(jfn, periods, eager=False))
    jfn_e, tfn_e, _ = _ewma_cases(_head(candles, T_EAGER))[name]
    assert_bits(tfn_e(_t(periods)[:, None]).numpy(), _jax_rows(jfn_e, periods, eager=True))
    # one period at a time gives the grid's rows
    for i in (0, len(periods) // 2, len(periods) - 1):
        assert_bits(tfn(_t(periods[i])).numpy(), got[i])


@pytest.mark.parametrize("name", ["ema", "rsi", "atr"])
def test_ewma_family_range_grid_matches_tensor_grid(candles, name):
    """A ``range`` of integer periods (the period tables' form, whose
    alphas are made on the host with NumPy) gives the tensor column's
    rows bit for bit."""
    _, tfn, periods = _ewma_cases(candles)[name]
    got = tfn(range(int(periods[0]), int(periods[-1]) + 1))
    assert got.shape == (len(periods), T)
    assert_bits(got.numpy(), tfn(_t(periods)[:, None]).numpy())


def test_ewma_family_packs_into_kernel_launches(candles):
    """96 EMA spans are 12 jobs of 8 alphas in 3 launches of 4 jobs; the
    plain results do not depend on the packing."""
    close = _t(candles["close"])
    alphas = [float(a) for a in (2.0 / (np.arange(5, 101, dtype=np.float32) + 1))]
    launches = tdyn.family_launches(close, alphas, 0)
    assert [len(jobs) for jobs in launches] == [4, 4, 4]
    assert all(len(a) == ewma.MAX_K for jobs in launches for _, a, _ in jobs)
    fam = tdyn.ewma_family(close, alphas, 0)
    assert fam.shape == (96, T)
    assert_bits(fam[40], ewma.fused_ewma_plain(close[None], [alphas[40]], 0)[0, 0])
    # the Wilder grids: 26 RSI periods on two series, 19 ATR periods
    assert [len(j) for j in tdyn.family_launches(close, list(range(26)), 1)] == [4]
    assert [len(j) for j in tdyn.family_launches(close, list(range(19)), 1)] == [3]


@pytest.mark.parametrize("fast,slow,signal", [(8, 20, 5), (12, 26, 9), (20, 40, 15)])
def test_macd(candles, fast, slow, signal):
    close = candles["close"]
    args = tuple(np.float32(v) for v in (fast, slow, signal))
    got = tdyn.macd_dyn(_t(close), *(_t(v) for v in args))
    jitted = jax.jit(jdyn.macd_dyn)(jnp.asarray(close), *(jnp.asarray(v) for v in args))
    for g, j in zip(got, jitted):
        assert_close(g.numpy(), j, extra=2e-6 * np.abs(close))
    head = close[:T_EAGER]
    with jax.disable_jit():
        eager = jdyn.macd_dyn(jnp.asarray(head), *(jnp.asarray(v) for v in args))
    for g, e in zip(tdyn.macd_dyn(_t(head), *(_t(v) for v in args)), eager):
        assert_bits(g.numpy(), e)


def test_per_genome_rows_and_batches_of_series(candles):
    """A column of periods per genome (the direct per-genome path): rows
    equal the one-period calls.  One period over a batch of series is one
    job of that batch; a column of periods over a batch is refused."""
    close = _t(candles["close"])
    periods = _t([12.0, 5.0, 12.0, 77.0])[:, None]
    rows = tdyn.ema_dyn(close, periods)
    assert rows.shape == (4, T)
    assert_bits(rows[0], rows[2])
    assert_bits(rows[3], tdyn.ema_dyn(close, _t(77.0)))
    batch = torch.stack([close, close.flip(0)])
    for fn in (lambda x, w: tdyn.ema_dyn(x, w), lambda x, w: tdyn.rsi_dyn(x, w)):
        both = fn(batch, _t(12.0))
        assert both.shape == (2, T)
        assert_bits(both[0], fn(close, _t(12.0)))
        assert_bits(both[1], fn(close.flip(0), _t(12.0)))
    with pytest.raises(ValueError, match="one series"):
        tdyn.ema_dyn(batch, _t([12.0, 77.0])[:, None])


def _std_truth(x, w):
    win = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), w)
    return np.concatenate([np.full(w - 1, np.nan), win.std(-1)])


def test_rolling_std_and_bollinger(candles):
    close = candles["close"]
    periods = np.arange(10, 31)
    ref_sd = _jax_rows(lambda w: jdyn.rolling_std_dyn(jnp.asarray(close), w, 30),
                       periods, eager=False)
    got_sd = tdyn.rolling_std_dyn(_t(close), _t(periods)[:, None], 30).numpy()
    for i, w in enumerate(periods):
        truth = _std_truth(close, int(w))
        np.testing.assert_array_equal(np.isnan(got_sd[i]), np.isnan(ref_sd[i]))
        np.testing.assert_allclose(got_sd[i], truth, rtol=2e-3)
        np.testing.assert_allclose(ref_sd[i], truth, rtol=2e-3)
    for w, k in ((10, 1.5), (20, 2.0), (30, 3.0)):
        got = tdyn.bollinger_dyn(_t(close), _t(w), _t(k), 30)
        ref = jax.jit(lambda v, s: jdyn.bollinger_dyn(jnp.asarray(close), v, s, 30))(
            jnp.float32(w), jnp.float32(k))
        hi, mid, lo, width, pos = (g.numpy() for g in got)
        assert_bits(mid, ref[1])
        band = np.abs(np.asarray(ref[0]) - np.asarray(ref[1]))      # k·sd
        for g, r in ((hi, ref[0]), (lo, ref[2])):
            assert_close(g, r, rtol=1e-7, atol=0.0, extra=2e-3 * np.nan_to_num(band))
        assert_close(pos, ref[4], rtol=0.0, atol=1e-3)
        assert_close(width, ref[3], rtol=2e-3, atol=1e-6)
