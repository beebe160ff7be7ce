"""The port's grid and DCA trading (strategy/grid.py, dca.py, grid_live.py)
against the JAX package's, on the CPU.

Both packages' modules are host code (float64 NumPy and Python floats)
over their own `FakeExchange`: twin exchanges on the same candles, and the
same calls, give exactly equal levels, simulated fills and PnL, ladders,
tracked orders, exchange fills and balances, stats and published bus state
and notifications — partial fills, pairing retries and band re-anchors
included.  No tolerance.
"""

import asyncio

import numpy as np
import pytest

pytest.importorskip("jax")

from ai_crypto_trader_tpu.data import ingest as jingest  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.strategy import dca as jdca  # noqa: E402
from ai_crypto_trader_tpu.strategy import grid as jgrid  # noqa: E402
from ai_crypto_trader_tpu.strategy import grid_live as jlive  # noqa: E402
from ai_crypto_trader_tpu_torch.data import ingest as tingest  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import dca as tdca  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import grid as tgrid  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import grid_live as tlive  # noqa: E402

PKGS = {"jax": dict(ingest=jingest, bus=jbus, ex=jex, dca=jdca, grid=jgrid, live=jlive),
        "port": dict(ingest=tingest, bus=tbus, ex=tex, dca=tdca, grid=tgrid, live=tlive)}


def _path(n, price=100.0, amp=5.0, drift=0.0, seed=0):
    """A sine path with a drift and seeded noise: float32 OHLCV columns."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    close = price + amp * np.sin(t / 25.0) + drift * t + rng.normal(0, 0.3, n)
    return {"close": close, "high": close + 0.2 + rng.uniform(0, 0.3, n),
            "low": close - 0.2 - rng.uniform(0, 0.3, n)}


def _series(pkg, n, symbol="BTCUSDC", **kw):
    p = _path(n, **kw)
    return PKGS[pkg]["ingest"].OHLCV(
        timestamp=np.arange(n, dtype=np.int64) * 60_000,
        open=p["close"].astype(np.float32), high=p["high"].astype(np.float32),
        low=p["low"].astype(np.float32), close=p["close"].astype(np.float32),
        volume=np.full(n, 1e6, np.float32), symbol=symbol)


def _drain(q):
    return [q.get_nowait()["data"] for _ in range(q.qsize())]


# --- GridTrader and DCAStrategy (host math) --------------------------------

@pytest.mark.parametrize("spacing", ["arithmetic", "geometric"])
@pytest.mark.parametrize("lower,upper,n", [(90.0, 110.0, 10), (100.0, 400.0, 4),
                                           (0.5, 0.9, 14)])
def test_grid_levels_equal(spacing, lower, upper, n):
    np.testing.assert_array_equal(
        tgrid.generate_grid_levels(lower, upper, n, spacing),
        jgrid.generate_grid_levels(lower, upper, n, spacing))


@pytest.mark.parametrize("regime", ["bull", "ranging", "volatile", "unknown"])
def test_grid_simulation_and_live_orders_equal(regime):
    p = _path(800, amp=8.0, seed=3)
    traders = {pkg: PKGS[pkg]["grid"].GridTrader.for_regime(
        p["close"][:500], regime, fee_rate=0.0005) for pkg in PKGS}
    assert traders["port"].n_grids == traders["jax"].n_grids
    steps = {pkg: [g.step_simulation(float(h), float(lo))
                   for h, lo in zip(p["high"][:300], p["low"][:300])]
             for pkg, g in traders.items()}
    assert steps["port"] == steps["jax"]
    outs = {pkg: g.run_simulation(p["high"][300:], p["low"][300:])
            for pkg, g in traders.items()}
    assert outs["port"] == outs["jax"] and outs["jax"]["round_trips"] > 0
    np.testing.assert_array_equal(traders["port"].holdings, traders["jax"].holdings)
    for price in (95.0, 100.0, 104.5):
        assert traders["port"].live_orders(price) == traders["jax"].live_orders(price)


@pytest.mark.parametrize("schedule", ["fixed", "regime_based", "value_averaging",
                                      "weighted"])
def test_dca_strategy_purchases_equal(schedule):
    records = {}
    for pkg, p in PKGS.items():
        ex = p["ex"].FakeExchange({"BTCUSDC": _series(pkg, 900, amp=6.0, seed=4)},
                                  quote_balance=100_000.0)
        ex.advance("BTCUSDC", steps=300)
        dca = p["dca"].DCAStrategy(base_amount=150.0, interval_s=3600.0,
                                   schedule=schedule, dip_threshold_pct=2.0)
        out = []
        for k in range(40):
            ex.advance("BTCUSDC", steps=7)
            out.append(dca.maybe_purchase(ex, now=900.0 * k, regime="bear",
                                          sentiment=0.2 + 0.015 * k))
        records[pkg] = (out, dca.purchases, dca.average_cost(), ex.fills, ex.get_balances())
    assert records["port"] == records["jax"]
    assert sum(r is not None for r in records["jax"][0]) >= 3


@pytest.mark.parametrize("threshold", [1.0, 5.0, 30.0])
def test_rebalance_orders_equal(threshold):
    kw = dict(holdings={"BTC": 1.0, "ETH": 0.5, "SOL": 0.0},
              prices={"BTC": 100.0, "ETH": 10.0, "SOL": 3.0},
              targets={"BTC": 0.5, "ETH": 0.3, "SOL": 0.2}, threshold_pct=threshold,
              quote="USDT")
    assert tdca.DCAStrategy.rebalance_orders(**kw) == jdca.DCAStrategy.rebalance_orders(**kw)


# --- GridTraderService and DCAService on the exchanges ---------------------

def _grid_run(pkg, n, ticks, path_kw, svc_kw, max_fill_base=None, reject_every=0):
    p = PKGS[pkg]
    ex = p["ex"].FakeExchange({"BTCUSDC": _series(pkg, n, **path_kw)},
                              quote_balance=100_000.0, fee_rate=0.0,
                              max_fill_base=max_fill_base)
    ex.advance("BTCUSDC", steps=520)
    if reject_every:
        # every reject_every-th placement raises (an outage): the service
        # must not track it and must retry the pairing later
        real, count = ex.place_order, [0]

        def place(*a, **k):
            count[0] += 1
            if count[0] % reject_every == 0:
                raise p["ex"].ExchangeUnavailable("outage")
            return real(*a, **k)
        ex.place_order = place
    bus = p["bus"].EventBus()
    notes = bus.subscribe("grid_trade_notifications")
    svc = p["live"].GridTraderService(exchange=ex, symbol="BTCUSDC", bus=bus, **svc_kw)
    outs, published = [], []

    async def go():
        for _ in range(ticks):
            ex.advance("BTCUSDC")
            outs.append(await svc.run_once())
            published.append((bus.get("grid_orders_BTCUSDC"), bus.get("grid_profit_BTCUSDC")))

    asyncio.run(go())
    return {"outs": outs, "published": published, "notes": _drain(notes),
            "orders": svc.orders, "stats": svc.stats(),
            "levels": None if svc.levels is None else svc.levels.tolist(),
            "fills": ex.fills, "open": ex.open_orders, "balances": ex.get_balances()}


@pytest.mark.parametrize("case", [
    # a ranging sine: fills, pairs and booked round trips
    dict(n=900, ticks=300, path_kw=dict(amp=5.0, seed=1), svc_kw={}),
    # liquidity-capped: partial fills reconciled slice by slice
    dict(n=900, ticks=300, path_kw=dict(amp=5.0, seed=2),
         svc_kw={"order_size": 400.0}, max_fill_base=1.0),
    # a drift out of the band: re-anchors with carried inventory
    dict(n=1200, ticks=600, path_kw=dict(amp=3.0, drift=0.04, seed=5),
         svc_kw={"regime": "volatile", "reanchor_margin_pct": 0.5}),
    # placements that raise: pairing retried on a later tick
    dict(n=900, ticks=300, path_kw=dict(amp=5.0, seed=6),
         svc_kw={"spacing": "geometric", "regime": "bull"}, reject_every=5),
], ids=["ranging", "partial_fills", "reanchor", "rejected_placements"])
def test_grid_service_equal(case):
    got, ref = (_grid_run(pkg, **case) for pkg in ("port", "jax"))
    for k in ref:
        assert got[k] == ref[k], k
    assert ref["stats"]["total_trades"] > 0 or ref["stats"]["carry_sales"] > 0
    if case["path_kw"].get("drift"):
        assert any(o.get("reanchored") for o in ref["outs"])


def _dca_run(pkg, rebalance):
    p = PKGS[pkg]
    ex = p["ex"].FakeExchange({"BTCUSDC": _series(pkg, 900, amp=4.0, seed=8),
                               "ETHUSDC": _series(pkg, 900, price=20.0, amp=1.0, seed=9,
                                                  symbol="ETHUSDC")},
                              quote_balance=20_000.0, fee_rate=0.0)
    ex.advance(steps=520)
    if rebalance:
        ex.balances["BTC"] = 50.0
    bus = p["bus"].EventBus()
    buys = bus.subscribe("dca_purchases")
    clock = {"t": 0.0}
    svc = p["live"].DCAService(
        exchange=ex, dca=p["dca"].DCAStrategy(symbol="BTCUSDC", base_amount=120.0,
                                              interval_s=3_600.0, schedule="weighted"),
        bus=bus, now_fn=lambda: clock["t"],
        rebalance_targets={"BTC": 0.4, "ETH": 0.3, "USDC": 0.3, "DOGE": 0.1}
        if rebalance else None, rebalance_interval_s=7_200.0)
    outs = []

    async def go():
        for k in range(60):
            ex.advance()
            clock["t"] += 600.0
            if k % 9 == 0:
                bus.set("market_regime_BTCUSDC", {"regime": ("bear", "bull")[k % 2]})
                bus.set("social_metrics_BTCUSDC", {"sentiment": 0.3 + 0.01 * k})
            outs.append(await svc.run_once())

    asyncio.run(go())
    return {"outs": outs, "buys": _drain(buys), "purchases": svc.dca.purchases,
            "fills": ex.fills, "balances": ex.get_balances()}


@pytest.mark.parametrize("rebalance", [False, True], ids=["purchases", "rebalance"])
def test_dca_service_equal(rebalance):
    got, ref = _dca_run("port", rebalance), _dca_run("jax", rebalance)
    for k in ref:
        assert got[k] == ref[k], k
    assert len(ref["purchases"]) >= 5
    if rebalance:
        assert any(o["rebalanced"] for o in ref["outs"])
