"""The port's portfolio backtest against the JAX package, on the CPU.

    {symbol: candles} → stack_symbol_inputs → portfolio_backtest
        (capital silos, or one shared pool: shared_capital_backtest)

Three symbols, one of them shorter (left-padded), about 400 candles.  The
stacked inputs are held against JAX's at tests/test_torch_slice.py's
tolerances (signals exact); the backtests run on JAX's own stacked inputs,
so the replay alone is compared: stats at rtol 1e-5, atol 1e-6 (the engine
tolerance of tests/test_torch_slice.py) with every count equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.backtest import portfolio as jp  # noqa: E402
from ai_crypto_trader_tpu.backtest.strategy import default_params as jdefault  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import (  # noqa: E402
    engine, portfolio_backtest, prepare_inputs, shared_capital_backtest, stack_symbol_inputs)
from ai_crypto_trader_tpu_torch.ops import compute_indicators  # noqa: E402

SYMBOLS = ("AAAUSDC", "BBBUSDC", "CCCUSDC")
T = 400


@pytest.fixture(scope="module")
def candles():
    per = {}
    for i, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=T if i != 1 else T - 70, seed=20 + i)
        per[s] = {k: d[k] for k in ("open", "high", "low", "close", "volume")}
    return per


@pytest.fixture(scope="module")
def stacked(candles):
    jin, jsym = jp.stack_symbol_inputs(candles)
    return jin, jsym, convert.inputs_from_numpy(jin, device="cpu")


def _params(stop_loss, take_profit):
    p = jdefault()
    return p._replace(stop_loss=jnp.float32(stop_loss), take_profit=jnp.float32(take_profit))


def _assert_stats(got, ref, where):
    for f in ref._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, (where, f)
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=f"{where} {f}")


def test_stack_symbol_inputs_matches_jax(candles, stacked):
    jin, jsym, _ = stacked
    got, sym = stack_symbol_inputs(candles, device="cpu")
    assert sym == jsym == sorted(SYMBOLS)
    for f in jin._fields:
        r, g = np.asarray(getattr(jin, f)), getattr(got, f).numpy()
        assert g.shape == r.shape == (len(SYMBOLS), T) and g.dtype == r.dtype, f
        if f == "strength":
            # min(|macd|, 1)·20 carries MACD's rounding (2e-6·|close|, the
            # bound of tests/test_torch_indicators.py) where |macd| < 1, as
            # tests/test_torch_slice.py holds it
            close = np.asarray(jin.close)
            macd = np.asarray(jp.ops.compute_indicators(
                {k: jnp.asarray(v) for k, v in _padded(candles).items()})["macd"])
            bound = 1e-4 + 1e-5 * np.abs(r) + np.where(np.abs(macd) < 1.0,
                                                        20 * 2e-6 * np.abs(close), 0.0)
            assert (np.abs(g - r) <= bound).all()
        elif f in ("volatility", "volume"):
            # ATR/close and mean(volume)·mean(close), each at rtol 1e-5
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0.0, err_msg=f)
        else:
            # close, the signal and the decision exactly; the pass-through
            # gate and the NaN overrides exactly
            np.testing.assert_array_equal(g, r, err_msg=f)
    # the padding repeats the short symbol's first candle: flat, no signal
    pad = T - len(candles["BBBUSDC"]["close"])
    assert (got.close[1, :pad] == got.close[1, pad]).all()


def _padded(candles):
    """The stacked candles as stack_symbol_inputs pads them."""
    out = {}
    for k in ("open", "high", "low", "close", "volume"):
        rows = []
        for s in sorted(candles):
            v = np.asarray(candles[s][k], np.float32)
            rows.append(np.concatenate([np.full(T - len(v), v[0], np.float32), v]))
        out[k] = np.stack(rows)
    return out


def test_stacked_rows_equal_each_symbol_alone(candles):
    """One compute_indicators call over the [S, T] stack gives each row
    what that symbol alone gives, bit for bit."""
    got, sym = stack_symbol_inputs(candles, device="cpu")
    pad = _padded(candles)
    for i, s in enumerate(sym):
        alone = prepare_inputs(compute_indicators({k: v[i] for k, v in pad.items()},
                                                  device="cpu"), device="cpu")
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f)[i].numpy(),
                                          getattr(alone, f).numpy(), err_msg=f"{s} {f}")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("use_param_sl_tp", [False, True])
def test_portfolio_backtest_matches_jax(stacked, shared, use_param_sl_tp):
    jin, _, tin = stacked
    jparams = _params(0.6, 1.2)
    js, jm, jpf = jp.portfolio_backtest(jin, jparams, use_param_sl_tp=use_param_sl_tp,
                                        shared_capital=shared)
    ts, tm, tpf = portfolio_backtest(tin, convert.params_from_numpy(jparams, device="cpu"),
                                     use_param_sl_tp=use_param_sl_tp, shared_capital=shared,
                                     device="cpu")
    where = f"shared={shared} param_sl_tp={use_param_sl_tp}"
    _assert_stats(ts, js, where)
    assert int(np.sum(np.asarray(js.total_trades))) > 0, where
    assert tm.keys() == jm.keys()
    for k, r in jm.items():
        # each metric combines several stats, each at rtol 1e-5
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{where} {k}")
    assert tpf.keys() == jpf.keys()
    for k, r in jpf.items():
        np.testing.assert_allclose(tpf[k].numpy(), np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{where} {k}")


@pytest.mark.parametrize("case", ["scalar_params", "params_per_symbol", "params_grid_curve"])
def test_per_series_split_equals_one_batched_run(stacked, case):
    """On the card `run_backtest` over [S, T] gives each close series its
    own replay-kernel launch (`engine._per_series`).  The split and the
    putting back are device-free: here each piece runs the plain loop, and
    the whole equals one batched plain run bit for bit, at every broadcast
    shape of the params."""
    _, _, tin = stacked
    tin = type(tin)(*(x[..., :200] for x in tin))
    params = convert.params_from_numpy(jdefault(), device="cpu")
    sl_tp = {"scalar_params": (0.6, 1.2),
             "params_per_symbol": ([0.4, 0.6, 0.9], [0.8, 1.2, 2.0]),
             "params_grid_curve": ([[0.4], [0.9]], [[0.8], [2.0]])}[case]
    params = params._replace(stop_loss=torch.tensor(sl_tp[0]), take_profit=torch.tensor(sl_tp[1]))
    curve = case.endswith("curve")

    def run(i, p):
        return engine.run_backtest(i, p, use_param_sl_tp=True, return_curve=curve, device="cpu")

    got, ref = engine._per_series(run, tin, params, curve), run(tin, params)
    if curve:
        (got, got_curve), (ref, ref_curve) = got, ref
        assert torch.equal(got_curve, ref_curve) and got_curve.shape == (2, len(SYMBOLS), 200)
    shape = (2, len(SYMBOLS)) if curve else (len(SYMBOLS),)
    for f in ref._fields:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.shape == r.shape == shape and g.dtype == r.dtype, f
        assert torch.equal(g, r), f
    assert int(ref.total_trades.sum()) > 0


@pytest.mark.parametrize("cadence", ["per_update", "per_candle"])
def test_shared_capital_cadences_and_slot_cap_match_jax(stacked, cadence):
    """Two slots for three symbols, so the cap binds; both equity
    cadences."""
    jin, _, tin = stacked
    js, jps = jp.shared_capital_backtest(jin, None, max_positions=2,
                                         min_signal_strength=40.0, equity_cadence=cadence)
    ts, tps = shared_capital_backtest(tin, None, max_positions=2, min_signal_strength=40.0,
                                      equity_cadence=cadence, device="cpu")
    _assert_stats(ts, js, cadence)
    np.testing.assert_array_equal(tps["trades"].numpy(), np.asarray(jps["trades"]))
    np.testing.assert_allclose(tps["realized_pnl"].numpy(), np.asarray(jps["realized_pnl"]),
                               rtol=1e-5, atol=1e-4)
    assert int(ts.total_trades) > 0 and ts.n_r.dtype == torch.int32


def test_shared_capital_rejects_bad_options(stacked):
    _, _, tin = stacked
    with pytest.raises(ValueError, match="equity_cadence"):
        shared_capital_backtest(tin, equity_cadence="per_tick", device="cpu")
    with pytest.raises(ValueError, match="StrategyParams"):
        shared_capital_backtest(tin, use_param_sl_tp=True, device="cpu")


@pytest.mark.parametrize("entry", ["stack_symbol_inputs", "portfolio_backtest",
                                   "shared_capital_backtest"])
def test_portfolio_entry_points_default_to_cuda(monkeypatch, candles, stacked, entry):
    _, _, tin = stacked
    calls = {"stack_symbol_inputs": lambda: stack_symbol_inputs(candles),
             "portfolio_backtest": lambda: portfolio_backtest(tin),
             "shared_capital_backtest": lambda: shared_capital_backtest(tin)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
