"""The port's market monitor against the JAX package's, on the CPU.

    FakeExchange → MarketMonitor.poll: the fused path (TickEngine, one
    host read a poll), the per-symbol path (compute_indicators,
    volume_profile, the combination scores a frame), the pipelined path,
    the warm-up and historical-data keys, drift, market_updates

test_torch_tick.py's shape: 3 symbols, frames 1m/5m/15m, a 128-candle
window, on the JAX package's `FakeExchange` tape; the 15m frame warms up
during the run.  Published payloads follow JAX's at rtol 1e-5, atol 1e-6
and their labels exactly, except the fields that carry MACD or the long
SMAs, which get test_torch_tick.py's bounds derived from the indicators'
(`_payload_tolerance`).  The pipelined monitor's payloads equal the serial
ones shifted by one tick, bit for bit, and the per-symbol path's equal the
fused path's within the same bounds.  The JAX monitors are built once, in
a module fixture: the JAX tick engine compiles once per universe shape.
"""

import asyncio

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import monitor as jmon  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV as TOHLCV  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import monitor as tmon  # noqa: E402
from test_torch_tick import _tolerance  # noqa: E402

LIMIT = 128
SYMBOLS = ["BTCUSDC", "ETHUSDC", "SOLUSDC"]
FRAMES = ("1m", "5m", "15m")
START = 1_898                       # the 15m frame fills at the 7th poll (1,906 candles)
POLLS = 8
PKGS = {"jax": (jex, jbus, jmon, JOHLCV), "port": (tex, tbus, tmon, TOHLCV)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exchange(ex_mod, ohlcv_cls, clock):
    series = {}
    for i, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=2_100, seed=7 + i)
        series[s] = ohlcv_cls(timestamp=np.arange(2_100, dtype=np.int64) * 60_000,
                              open=d["open"], high=d["high"], low=d["low"],
                              close=d["close"], volume=d["volume"] * 1000, symbol=s)
    return ex_mod.make_exchange("fake", resilient=True, series=series, resilient_opts={
        "now_fn": lambda: clock[0], "sleep": lambda s: None})


def _run(pkg, polls=POLLS, **mon_kw):
    """POLLS polls of one monitor; the published payloads per poll, the bus
    keys after the last, the drift rows and the monitor."""
    ex_mod, bus_mod, mon_mod, ohlcv_cls = PKGS[pkg]
    clock = [50_000.0]
    ex = _exchange(ex_mod, ohlcv_cls, clock)
    ex.advance(steps=START)
    bus = bus_mod.EventBus(now_fn=lambda: clock[0])
    q = bus.subscribe("market_updates")
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mon = mon_mod.MarketMonitor(bus, ex, symbols=SYMBOLS, intervals=FRAMES,
                                kline_limit=LIMIT, now_fn=lambda: clock[0],
                                throttle_s=0.0, **kw, **mon_kw)

    async def go():
        per_poll = []
        for _ in range(polls):
            ex.advance()
            clock[0] += 60.0
            await mon.poll()
            per_poll.append([q.get_nowait()["data"] for _ in range(q.qsize())])
        if mon.pipelined:
            await mon.flush_pipeline()
            per_poll.append([q.get_nowait()["data"] for _ in range(q.qsize())])
        return per_poll

    if pkg == "jax":
        with jtickpath.use(None), devprof.use(None), meshprof.use(None):
            payloads = asyncio.run(go())
    else:
        payloads = asyncio.run(go())
    keys = {k: bus.get(k) for k in sorted(bus.keys("*"))}
    return {"payloads": payloads, "keys": keys, "drift": dict(mon.last_drift), "monitor": mon}


@pytest.fixture(scope="module")
def runs():
    return {("jax", "fused"): _run("jax"),
            ("jax", "symbol"): _run("jax", fused=False),
            ("port", "fused"): _run("port"),
            ("port", "symbol"): _run("port", fused=False),
            ("port", "pipelined"): _run("port", pipelined=True)}


_TABLE_KEY = {"macd_5m": "macd", "macd_15m": "macd", "top_family_score": "confluence"}
_LABELS = ("symbol", "signal", "trend", "top_family", "signal_5m", "signal_15m")


def _payload_tolerance(key, ref):
    """(rtol, atol) of a payload field against ``ref`` (the JAX payload),
    test_torch_tick.py's bounds: MACD (and the frames' MACD, whose last
    close is the 1m close) 1e-3 + 2e-6·|close|, the families and the
    confluence that carry its tanh 2e-3 (the top family's score is one of
    them), the trend strength 5e-5, the rest 1e-6."""
    table = {"current_price": np.float64(ref["current_price"]),
             "macd": np.float64(ref["macd"])}
    return _tolerance(_TABLE_KEY.get(key, key), table)


def assert_payload_close(got, ref, where):
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k]
        if k in _LABELS or isinstance(r, str):
            assert g == r, (where, k, g, r)
        elif isinstance(r, dict):
            for kk, rr in r.items():
                assert g[kk] == pytest.approx(rr, rel=1e-5, abs=1e-6), (where, k, kk)
        else:
            rtol, atol = _payload_tolerance(k, ref)
            assert abs(g - r) <= atol + rtol * abs(r), (where, k, g, r)


@pytest.mark.parametrize("path", ["fused", "symbol"])
def test_payloads_follow_jax(runs, path):
    port, ref = runs[("port", path)], runs[("jax", path)]
    assert [len(p) for p in port["payloads"]] == [len(p) for p in ref["payloads"]]
    for t, (gp, rp) in enumerate(zip(port["payloads"], ref["payloads"])):
        for g, r in zip(gp, rp):
            assert_payload_close(g, r, (path, t, r["symbol"]))
    # the run exercised the warm-up: the 15m columns appear mid-run
    first, last = port["payloads"][0][0], port["payloads"][-1][0]
    assert "rsi_15m" not in first and "rsi_15m" in last and "rsi_5m" in first


@pytest.mark.parametrize("path", ["fused", "symbol"])
def test_bus_keys_follow_jax(runs, path):
    port, ref = runs[("port", path)]["keys"], runs[("jax", path)]["keys"]
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k.startswith("market_data_"):
            assert_payload_close(port[k], v, k)
        else:                                   # klines and warm-up: exact
            assert port[k] == v, k
    assert any(k.startswith("monitor_warmup_") for k in port)


def test_drift_rows_follow_jax(runs):
    port, ref = runs[("port", "fused")]["drift"], runs[("jax", "fused")]["drift"]
    assert set(port) == set(ref) == set(SYMBOLS)
    for s in ref:
        assert set(port[s]) == set(ref[s])


def test_pipelined_payloads_equal_serial_shifted_by_one_poll(runs):
    serial, pipe = runs[("port", "fused")]["payloads"], runs[("port", "pipelined")]["payloads"]
    assert pipe[0] == []                        # the pipeline fills
    assert pipe[1:] == serial                   # the same bits, one poll later


def test_per_symbol_path_equals_the_fused_path(runs):
    fused, symbol = runs[("port", "fused")]["payloads"], runs[("port", "symbol")]["payloads"]
    for t, (f, s) in enumerate(zip(fused, symbol)):
        for a, b in zip(s, f):
            assert_payload_close(a, b, ("per-symbol vs fused", t, b["symbol"]))


def test_one_host_read_a_poll(monkeypatch, runs):
    from ai_crypto_trader_tpu_torch.ops import tick_engine

    reads = []
    real = tick_engine.host_read
    monkeypatch.setattr(tick_engine, "host_read", lambda rb: reads.append(1) or real(rb))
    mon = runs[("port", "fused")]["monitor"]
    mon.exchange.advance()
    mon.now_fn = lambda: 1e9
    assert asyncio.run(mon.poll()) == len(SYMBOLS)
    assert len(reads) == 1
