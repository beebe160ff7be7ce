"""The whole slice, end to end, against the JAX package on the CPU:

    generate_ohlcv → compute_indicators → prepare_inputs → sweep
        → compute_metrics

from the same candles and the same strategy draws, each package through
its own indicators.  Signals must agree exactly; stats at
`assert_stats_equal`'s tolerance (rtol 1e-5, atol 1e-6) with equal trade
counts; metrics at rtol 1e-4 (each metric combines several stats, each at
rtol 1e-5).

Where rounding in the two indicator tables could flip a signal, a flipped
candle would have to sit within the tables' tolerance of a vote threshold;
none does on these series, and the test says so if one ever appears.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import backtest as jbt  # noqa: E402
from ai_crypto_trader_tpu import ops as jops  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv as jax_generate  # noqa: E402
from ai_crypto_trader_tpu_torch import backtest as tbt  # noqa: E402
from ai_crypto_trader_tpu_torch import convert, ops  # noqa: E402
from ai_crypto_trader_tpu_torch.data import generate_ohlcv  # noqa: E402


def _candles(gen, T):
    return {k: v for k, v in gen(n=T, seed=3).items() if k != "regime"}


def _flip_report(tind, jind, flips):
    cols = ("rsi", "stoch_k", "macd", "williams_r", "bb_position")
    return {int(t): {c: (float(tind[c][t]), float(jind[c][t])) for c in cols}
            for t in flips[:5]}


@pytest.mark.parametrize("T,B", [(1024, 64), (2100, 96)])
def test_chain_matches_jax(T, B):
    # JAX chain
    jind = jops.compute_indicators({k: jnp.asarray(v) for k, v in
                                    _candles(jax_generate, T).items()})
    jinp = jbt.prepare_inputs(jind)
    jparams = jbt.sample_params(jax.random.PRNGKey(0), B)
    jstats = jbt.sweep(jinp, jparams)
    jmetrics = jbt.compute_metrics(jstats)

    # the port's chain, from its own generator and indicators
    tind = ops.compute_indicators(_candles(generate_ohlcv, T), device="cpu")
    tinp = tbt.prepare_inputs(tind, device="cpu")
    tparams = convert.params_from_numpy(jparams, device="cpu")
    tstats = tbt.sweep(tinp, tparams, device="cpu")
    tmetrics = tbt.compute_metrics(tstats, device="cpu")

    flips = np.flatnonzero(tinp.signal.numpy() != np.asarray(jinp.signal))
    assert flips.size == 0, ("signals flipped", _flip_report(tind, jind, flips))
    np.testing.assert_array_equal(tinp.decision.numpy(), np.asarray(jinp.decision))
    # strength carries min(|macd|, 1)·20: the MACD tolerance of
    # tests/test_torch_indicators.py (2e-6·|close|), times 20, where |macd| < 1
    close = np.asarray(jind["close"])
    macd_term = np.where(np.abs(np.asarray(jind["macd"])) < 1.0, 20 * 2e-6 * close, 0.0)
    diff = np.abs(tinp.strength.numpy() - np.asarray(jinp.strength))
    assert (diff <= 1e-4 + 1e-5 * np.asarray(jinp.strength) + macd_term).all()

    got = convert.stats_to_numpy(tstats)
    for f in jstats._fields:
        r = np.asarray(getattr(jstats, f))
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(got[f], r, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], r, rtol=1e-5, atol=1e-6, err_msg=f)
    assert int(got["total_trades"].sum()) > 0

    assert tmetrics.keys() == jmetrics.keys()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(tmetrics[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(bool(torch.isfinite(v).all()) for v in tmetrics.values())
