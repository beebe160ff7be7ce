"""The port's triangle arbitrage (strategy/arbitrage.py) against the JAX
package's, on the CPU.

Tolerances, and why:

  * `build_rate_matrix`: host NumPy in float64, the same operations —
    exactly equal;
  * `_cycle_profits`: bit for bit, for n = 3-32.  Both cast R to float32,
    form ``(R[a,b]·R[b,c])·R[c,a]`` and multiply by ``(1 − fee)³``, which
    the JAX program computes in float32 as ``x·(x·x)`` (an integer power
    of 3 expands into two multiplies); the port takes that order;
  * `find_triangle_arbitrage`: the masking, the sort, the dedupe and the
    top-k are NumPy on the same float32 tensor — the same lists, planted
    cycles included; `executable_volume`: host code, equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.strategy import arbitrage as J  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import arbitrage as P  # noqa: E402

FEES = (0.0, 0.001, 0.00075, 0.0025)


def _market(n, seed, planted=()):
    """Tickers over n assets: every pair quoted (ASSETiASSETj for i > j,
    plus ASSETiUSDC), mid prices from a log-normal draw with a spread, and
    the ``planted`` (a, b, c, edge) cycles whose cross rate is moved by
    ``edge`` so that a→b→c→a pays."""
    rng = np.random.default_rng(seed)
    assets = ["USDC"] + [f"A{i:02d}" for i in range(n - 1)]
    value = np.exp(rng.normal(0.0, 1.5, n))
    value[0] = 1.0
    tickers = {}
    for i in range(1, n):
        for j in range(i):
            mid = value[i] / value[j]
            half = mid * rng.uniform(1e-4, 2e-3)
            tickers[assets[i] + assets[j]] = {"bid": mid - half, "ask": mid + half}
    for a, b, c, edge in planted:
        # cross rate of (b, c): make selling b for c pay `edge`
        i, j = max(b, c), min(b, c)
        t = tickers[assets[i] + assets[j]]
        scale = (1.0 + edge) if i == b else 1.0 / (1.0 + edge)
        tickers[assets[i] + assets[j]] = {"bid": t["bid"] * scale, "ask": t["ask"] * scale}
    return tickers, assets


@pytest.mark.parametrize("n", [3, 4, 7, 12, 20, 32])
def test_build_rate_matrix_exact(n):
    tickers, assets = _market(n, seed=n)
    tickers["BOGUS"] = {"price": 3.0}                          # no market: skipped
    tickers[assets[1] + "USDT"] = {"price": 2.5}                # quote not an asset
    got, ref = P.build_rate_matrix(tickers, assets), J.build_rate_matrix(tickers, assets)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [3, 5, 8, 13, 21, 32])
@pytest.mark.parametrize("fee", FEES)
def test_cycle_profits_bit_for_bit(n, fee):
    tickers, assets = _market(n, seed=100 + n, planted=[(0, 1, 2, 0.02)])
    R = J.build_rate_matrix(tickers, assets)
    R[1, n - 1] = 0.0                                           # a missing leg
    got = P._cycle_profits(R, fee, device="cpu")
    ref = np.asarray(J._cycle_profits(jnp.asarray(R), fee))
    assert got.dtype == torch.float32 and got.shape == (n, n, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_fee_cube_is_the_programs_power():
    """The host float32 ``x·(x·x)`` is JAX's ``(1 − fee) ** 3`` under jit
    for a traced fee, bit for bit, over many fees."""
    fees = np.random.default_rng(0).uniform(0.0, 0.01, 256)
    ref = np.asarray(jax.jit(lambda f: (1.0 - f) ** 3)(jnp.asarray(fees, jnp.float32)))
    got = np.asarray([P._fee_cube(float(np.float32(f))) for f in fees], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("n,planted", [
    (3, [(0, 1, 2, 0.01)]),
    (8, [(0, 3, 5, 0.015), (2, 4, 6, 0.008)]),
    (16, [(0, 7, 11, 0.012), (3, 9, 14, 0.02), (1, 2, 15, 0.004)]),
    (32, [(0, 30, 31, 0.03), (5, 10, 20, 0.011)]),
])
@pytest.mark.parametrize("fee,min_pct,top_k", [(0.001, 0.1, 5), (0.0, 0.0, 3),
                                               (0.00075, 0.05, 10)])
def test_find_triangle_arbitrage_lists_equal(n, planted, fee, min_pct, top_k):
    tickers, assets = _market(n, seed=7 * n, planted=planted)
    got = P.find_triangle_arbitrage(tickers, assets, fee_rate=fee, min_profit_pct=min_pct,
                                    top_k=top_k, device="cpu")
    ref = J.find_triangle_arbitrage(tickers, assets, fee_rate=fee, min_profit_pct=min_pct,
                                    top_k=top_k)
    assert got == ref
    # the largest planted edge (its pair b, c) is on the best cycle
    _, b, c, _ = max(planted, key=lambda p: p[3])
    assert got and {assets[b], assets[c]} <= set(got[0]["cycle"])


def test_planted_cycle_and_fees_as_the_jax_package_tests():
    tickers = {"BTCUSDC": {"bid": 100.0, "ask": 100.0},
               "ETHUSDC": {"bid": 10.1, "ask": 10.1},
               "ETHBTC": {"bid": 0.1, "ask": 0.1}}
    got = P.find_triangle_arbitrage(tickers, ["USDC", "BTC", "ETH"], fee_rate=0.0,
                                    min_profit_pct=0.1, device="cpu")
    assert got == J.find_triangle_arbitrage(tickers, ["USDC", "BTC", "ETH"], fee_rate=0.0,
                                            min_profit_pct=0.1)
    assert got[0]["profit_pct"] == pytest.approx(1.0, rel=1e-3)
    tickers["ETHUSDC"] = {"bid": 10.02, "ask": 10.02}
    assert P.find_triangle_arbitrage(tickers, ["USDC", "BTC", "ETH"], fee_rate=0.001,
                                     min_profit_pct=0.0, device="cpu") == []


def test_one_read_of_the_cycle_tensor(monkeypatch):
    reads = []
    real = P.host_read
    monkeypatch.setattr(P, "host_read", lambda x: reads.append(tuple(x.shape)) or real(x))
    tickers, assets = _market(9, seed=1, planted=[(0, 2, 4, 0.02)])
    assert P.find_triangle_arbitrage(tickers, assets, device="cpu")
    assert reads == [(9, 9, 9)]


@pytest.mark.parametrize("books,sides", [
    ([{"asks": [[100, 5]], "bids": []}, {"asks": [], "bids": [[10, 20]]},
      {"asks": [[0.1, 1000]], "bids": []}], ["BUY", "SELL", "BUY"]),
    ([{"asks": [[100, 5]], "bids": []}, {"asks": [], "bids": []},
      {"asks": [[0.1, 1000]], "bids": []}], ["BUY", "SELL", "BUY"]),
    ([], []),
])
def test_executable_volume_equal(books, sides):
    assert P.executable_volume(books, sides) == J.executable_volume(books, sides)
