"""The port's exchange adapters against the JAX package's, on the CPU.

    shell.exchange: FakeExchange (fills, matching, balances, books, klines),
    resample_klines, load_depth_records, BinanceExchange over a fake
    client, ResilientExchange (breaker, token bucket, budgeted sleep on a
    virtual clock), make_exchange; utils.symbols, utils.circuit_breaker,
    utils.rate_limiter

Host code, held exactly: the same calls give the same fills, balances,
order states, books and klines (float64 all through), and the same
breaker, bucket and sleep histories.  Nothing is excluded.
"""

import asyncio
import random

import numpy as np
import pytest

pytest.importorskip("jax")

from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.utils import circuit_breaker as jcb  # noqa: E402
from ai_crypto_trader_tpu.utils import journal as jjournal  # noqa: E402
from ai_crypto_trader_tpu.utils import rate_limiter as jrl  # noqa: E402
from ai_crypto_trader_tpu.utils import symbols as jsym  # noqa: E402
from ai_crypto_trader_tpu_torch import utils as tutils  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV as TOHLCV  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import circuit_breaker as tcb  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import rate_limiter as trl  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import symbols as tsym  # noqa: E402

PKGS = {"jax": (jex, JOHLCV), "port": (tex, TOHLCV)}


def _series(ohlcv_cls, n=600, seed=3, symbol="BTCUSDC", scale=1.0):
    d = generate_ohlcv(n=n, seed=seed)
    return ohlcv_cls(timestamp=np.arange(n, dtype=np.int64) * 60_000,
                     open=d["open"] * scale, high=d["high"] * scale, low=d["low"] * scale,
                     close=d["close"] * scale, volume=d["volume"], symbol=symbol)


def _fake(pkg, **kw):
    ex_mod, ohlcv_cls = PKGS[pkg]
    series = {"BTCUSDC": _series(ohlcv_cls), "ETHUSDT": _series(ohlcv_cls, seed=4, scale=0.07,
                                                                 symbol="ETHUSDT")}
    return ex_mod.FakeExchange(series, **kw)


def _trade_script(ex):
    """Market, limit and stop orders, partial fills under a liquidity cap,
    rejects, cancels and client-id idempotency; returns everything the
    exchange reports along the way."""
    log = []
    ex.advance(steps=50)
    log.append(ex.place_order("BTCUSDC", "buy", "market", 0.05, client_order_id="c1"))
    log.append(ex.place_order("BTCUSDC", "BUY", "MARKET", 0.05, client_order_id="c1"))
    log.append(ex.place_order("BTCUSDC", "BUY", "MARKET", float("nan")))
    log.append(ex.place_order("BTCUSDC", "BUY", "MARKET", 10_000.0))     # too poor
    px = ex.get_ticker("BTCUSDC")["price"]
    log.append(ex.place_order("BTCUSDC", "SELL", "LIMIT", 0.04, price=px * 1.002,
                              client_order_id="tp"))
    log.append(ex.place_order("BTCUSDC", "SELL", "STOP_LOSS_LIMIT", 0.01,
                              price=px * 0.99, stop_price=px * 0.995))
    log.append(ex.place_order("BTCUSDC", "BUY", "LIMIT", 0.02, price=px * 0.995))
    log.append(ex.place_order("ETHUSDT", "BUY", "LIMIT", 1.0, price=1.0))
    for _ in range(40):
        ex.advance()
        log.append((ex.list_open_orders(), ex.get_balances()))
    oid = log[-1][0][0]["order_id"] if log[-1][0] else 999
    log.append(ex.cancel_order("BTCUSDC", oid))
    log.append(ex.cancel_order("BTCUSDC", 12345))
    log.append([ex.order_is_open("BTCUSDC", o) for o in range(1, 8)])
    log.append([ex.executed_qty("BTCUSDC", o, 1.0, False) for o in range(1, 8)])
    log.append([ex.order_state("BTCUSDC", o, 1.0) for o in range(1, 8)])
    log.append(ex.find_order_by_client_id("BTCUSDC", "tp"))
    log.append(ex.find_order_by_client_id("BTCUSDC", "nope"))
    log.append([ex.fills_for(o) for o in range(1, 8)])
    log.append(ex.last_fill(1))
    log.append((ex.fills, ex.get_balances(), ex.cursor))
    return log


@pytest.mark.parametrize("max_fill_base", [None, 0.015, 0.0])
def test_fake_exchange_trades_like_jax(max_fill_base):
    got = {pkg: _trade_script(_fake(pkg, max_fill_base=max_fill_base, fee_rate=0.00075))
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    # a resting order filled unless the cap leaves no liquidity at all
    fills = got["port"][-1][0]
    assert any(f["type"] != "MARKET" for f in fills) == (max_fill_base != 0.0)


def test_market_data_and_books_match_jax():
    got = {}
    for pkg in PKGS:
        ex = _fake(pkg)
        ex.advance(steps=333)
        got[pkg] = (ex.get_ticker("ETHUSDT"), ex.get_order_book("BTCUSDC", 10),
                    ex.list_symbols(), ex.list_symbols(quote="USDT"),
                    {iv: ex.get_klines("BTCUSDC", iv, 40) for iv in ("1m", "3m", "5m", "15m", "1h")},
                    ex.get_klines("ETHUSDT", "5m", 1000))
    assert got["port"] == got["jax"]
    rows = [[i * 60_000, 1.0 + i, 2.0 + i, 0.5 + i, 1.5 + i, 10.0 * i, 0, 0.0, 0, 0.0, 0.0, 0]
            for i in range(7)]
    assert tex.resample_klines(rows, 3) == jex.resample_klines(rows, 3)


def test_depth_capture_replays_like_jax(tmp_path):
    records = [{"symbol": "BTCUSDC", "kind": "snapshot", "E": 10 + i,
                "bids": [[100.0 - j - i, 1.0 + j] for j in range(5)],
                "asks": [[101.0 + j + i, 2.0 + j] for j in range(5)]} for i in range(3)]
    records.append({"symbol": "BTCUSDC", "kind": "diff", "bids": [[1.0, 0.0]], "asks": [[2.0, 0.0]]})
    path = str(tmp_path / "depth.journal")
    j = jjournal.WriteAheadJournal(path)
    for r in records:
        j.append("depth", r)
    j.close()
    for source in (records, path):
        got = {}
        for pkg in PKGS:
            ex = _fake(pkg, depth_capture=source)
            books = []
            for _ in range(4):
                ex.advance()
                books.append((ex.get_order_book("BTCUSDC", 3), ex.get_order_book("ETHUSDT", 3)))
            got[pkg] = (PKGS[pkg][0].load_depth_records(source), books)
        assert got["port"] == got["jax"]
        assert got["port"][1][0][0]["captured"] and "captured" not in got["port"][1][0][1]


class FakeClient:
    """A python-binance-shaped client that records its calls."""

    def __init__(self):
        self.calls = []

    def _rec(self, name, **kw):
        self.calls.append((name, kw))

    def get_symbol_ticker(self, **kw):
        self._rec("get_symbol_ticker", **kw)
        return {"price": "123.5"}

    def get_order_book(self, **kw):
        self._rec("get_order_book", **kw)
        return {"bids": [["1", "2"]], "asks": [["3", "4"]]}

    def get_klines(self, **kw):
        self._rec("get_klines", **kw)
        return [[0, "1", "2", "0.5", "1.5", "9"]]

    def create_order(self, **kw):
        self._rec("create_order", **kw)
        return {"orderId": 7, "status": "NEW"}

    def cancel_order(self, **kw):
        self._rec("cancel_order", **kw)
        return {"status": "CANCELED"}

    def get_order(self, **kw):
        self._rec("get_order", **kw)
        if kw.get("origClientOrderId") == "missing":
            err = RuntimeError("Order does not exist.")
            err.code = -2013
            raise err
        if kw.get("origClientOrderId") == "timeout":
            raise TimeoutError("read timed out")
        return {"orderId": 7, "status": "FILLED", "side": "BUY", "origQty": "2",
                "executedQty": "2", "price": "0", "cummulativeQuoteQty": "250"}

    def get_open_orders(self, **kw):
        self._rec("get_open_orders", **kw)
        return [{"orderId": 3, "symbol": "BTCUSDC", "status": "NEW", "side": "SELL",
                 "type": "LIMIT", "origQty": "1.5", "clientOrderId": "wj-tp-BTCUSDC-1"}]

    def get_account(self, **kw):
        self._rec("get_account", **kw)
        return {"balances": [{"asset": "USDC", "free": "10.5"}, {"asset": "BTC", "free": "0"}]}

    def get_exchange_info(self, **kw):
        self._rec("get_exchange_info", **kw)
        return {"symbols": [{"symbol": "ETHUSDC"}, {"symbol": "BTCUSDC"},
                            {"symbol": "XRPUSDT", "status": "BREAK"}]}


def _binance_script(ex_mod):
    client = FakeClient()
    ex = ex_mod.BinanceExchange(client)
    out = [ex.get_ticker("BTCUSDC"), ex.get_order_book("BTCUSDC", 5),
           ex.get_klines("BTCUSDC", "5m", 3),
           ex.place_order("BTCUSDC", "BUY", "LIMIT", 1.0, price=10.0, stop_price=9.0,
                          client_order_id="wj-ent-BTCUSDC-1"),
           ex.cancel_order("BTCUSDC", 7), ex.find_order_by_client_id("BTCUSDC", "x"),
           ex.find_order_by_client_id("BTCUSDC", "missing"), ex.list_open_orders(),
           ex.list_open_orders("BTCUSDC"), ex.order_is_open("BTCUSDC", 7),
           ex.executed_qty("BTCUSDC", 7, 2.0, False), ex.order_state("BTCUSDC", 7, 2.0),
           ex.get_balances(), ex.list_symbols(), ex.list_symbols(quote="USDC")]
    with pytest.raises(TimeoutError):
        ex.find_order_by_client_id("BTCUSDC", "timeout")
    with pytest.raises(RuntimeError, match="injected client"):
        ex_mod.BinanceExchange()
    return out, client.calls


def test_binance_adapter_over_a_fake_client_matches_jax():
    assert _binance_script(tex) == _binance_script(jex)


class Flaky(tex.ExchangeInterface):
    """Fails every call whose number is in ``fail_at``; records calls."""

    def __init__(self, fail_at):
        self.fail_at, self.n, self.calls = set(fail_at), 0, []

    def _call(self, name, value):
        self.n += 1
        self.calls.append(name)
        if self.n in self.fail_at:
            raise ConnectionError(f"{name} flake #{self.n}")
        return value

    def get_ticker(self, symbol):
        return self._call("get_ticker", {"symbol": symbol, "price": 100.0})

    def get_order_book(self, symbol, limit=20):
        return self._call("get_order_book", {"bids": [], "asks": []})

    def get_klines(self, symbol, interval="1m", limit=100):
        return self._call("get_klines", [[0, 1.0, 1.0, 1.0, 1.0, 1.0]])

    def place_order(self, symbol, side, order_type, quantity, price=None,
                    stop_price=None, client_order_id=None):
        return self._call("place_order", {"order_id": self.n, "status": "FILLED"})

    def cancel_order(self, symbol, order_id):
        return self._call("cancel_order", {"status": "CANCELED"})

    def get_balances(self):
        return self._call("get_balances", {"USDC": 1000.0})


class VirtualClock:
    def __init__(self):
        self.t, self.sleeps = 0.0, []

    def now(self):
        return self.t

    def sleep(self, dt):
        self.sleeps.append(dt)
        self.t += dt


def _resilient_script(ex_mod, fail_at, **kw):
    clock, inner = VirtualClock(), Flaky(fail_at)
    ex = ex_mod.ResilientExchange(inner, now_fn=clock.now, sleep=clock.sleep,
                                  rng=random.Random(5), **kw)
    log = []
    for step in range(60):
        method = ("get_ticker", "get_klines", "place_order", "get_balances",
                  "cancel_order", "get_order_book")[step % 6]
        args = {"get_ticker": ("BTCUSDC",), "get_klines": ("BTCUSDC", "5m", 10),
                "place_order": ("BTCUSDC", "BUY", "MARKET", 1.0), "get_balances": (),
                "cancel_order": ("BTCUSDC", 1), "get_order_book": ("BTCUSDC",)}[method]
        try:
            log.append((method, getattr(ex, method)(*args)))
        except ex_mod.ExchangeUnavailable as e:
            log.append((method, "unavailable", str(e)))
        if step % 10 == 9:
            clock.t += 31.0                     # past the breaker's reset timeout
    st = ex.breaker.stats
    return (log, inner.calls, clock.sleeps, ex.breaker.state.value, ex.breaker.failures,
            {k: st[k] for k in ("calls", "failures", "rejected")}, st["state_changes"],
            round(ex.bucket.tokens, 9))


@pytest.mark.parametrize("case", [
    {"fail_at": [1, 2, 5, 6, 7, 8, 9, 20, 21, 22, 23, 24, 25, 26, 27, 40]},
    {"fail_at": range(3, 60), "max_read_retries": 1, "failure_threshold": 2},
    {"fail_at": [4], "rate_per_s": 0.5, "burst": 2.0, "max_block_s": 3.0},
    {"fail_at": [], "rate_per_s": 1.0, "burst": 1.0, "max_block_s": None},
])
def test_resilient_exchange_breaker_and_bucket_match_jax(case):
    case = dict(case)
    fail_at = case.pop("fail_at")
    got = _resilient_script(tex, fail_at, **case)
    assert got == _resilient_script(jex, fail_at, **case)
    assert got[0]                              # the script ran


def test_make_exchange_and_delegation_match_jax():
    for pkg in PKGS:
        ex_mod, ohlcv_cls = PKGS[pkg]
        clock = VirtualClock()
        ex = ex_mod.make_exchange("fake", resilient=True,
                                  resilient_opts={"now_fn": clock.now, "sleep": clock.sleep},
                                  series={"BTCUSDC": _series(ohlcv_cls)})
        assert isinstance(ex, ex_mod.ResilientExchange)
        ex.advance(steps=10)                   # delegated to the fake
        assert ex.cursor["BTCUSDC"] == 10 and ex.fills == []
        assert isinstance(ex_mod.make_exchange("fake", series={}), ex_mod.FakeExchange)
        assert isinstance(ex_mod.make_exchange("binance", client=FakeClient()),
                          ex_mod.ResilientExchange)
        assert isinstance(ex_mod.make_exchange("binance", resilient=False, client=FakeClient()),
                          ex_mod.BinanceExchange)
        with pytest.raises(ValueError):
            ex_mod.make_exchange("kraken")
        got = asyncio.run(ex.acall("get_ticker", "BTCUSDC"))
        assert got == ex.get_ticker("BTCUSDC")


def test_symbol_helpers_match_jax():
    syms = ["BTCUSDC", "ETHUSDT", "BNBBUSD", "WEIRD", "BTCUSDT"]
    for f in ("split_symbol", "base_asset", "quote_asset"):
        assert [getattr(tsym, f)(s) for s in syms] == [getattr(jsym, f)(s) for s in syms]
    assert tsym.QUOTE_ASSETS == jsym.QUOTE_ASSETS
    bal = {"USDC": 10.0, "USDT": 0.0, "BTC": 0.5, "ETH": 2.0}
    md = {"BTCUSDC": {"current_price": 40_000.0}, "BTCUSDT": {"current_price": 1.0},
          "ETHUSDT": {"current_price": 2_000.0}}
    assert tsym.mark_holdings(bal, syms, md.get) == jsym.mark_holdings(bal, syms, md.get)


def _breaker_script(cb_mod, rl_mod):
    t = [0.0]
    cb = cb_mod.CircuitBreaker("x", failure_threshold=2, reset_timeout_s=5.0,
                               half_open_max_calls=1, now_fn=lambda: t[0])

    def boom():
        raise ValueError("boom")

    out = []
    for i in range(12):
        out.append(cb.call(boom if i in (0, 1, 5, 6, 7) else (lambda: i)))
        out.append((cb.state.value, cb.failures, dict(cb.stats, state_changes=list(
            cb.stats["state_changes"]))))
        t[0] += 2.0
    out.append(asyncio.run(cb.call_async(lambda: asyncio.sleep(0, result="ok"))))
    bucket = rl_mod.TokenBucket(rate_per_s=2.0, capacity=3.0, now_fn=lambda: t[0])
    for i in range(8):
        out.append((bucket.try_acquire(1.5), round(bucket.wait_time(2.0), 12)))
        t[0] += 0.3
    out.append(list(cb_mod.backoff_delays(5, 0.5, 3.0, 0.1, random.Random(1))))
    sleeps = []

    async def fake_sleep(d):
        sleeps.append(d)

    n = [0]

    def flaky():
        n[0] += 1
        if n[0] < 3:
            raise ConnectionError("x")
        return n[0]

    out.append(asyncio.run(cb_mod.retry_with_backoff(flaky, rng=random.Random(2),
                                                     sleep=fake_sleep)))
    out.append(sleeps)
    out.append(cb_mod.get_circuit_breaker("shared", failure_threshold=9).failure_threshold)
    return out


def test_breaker_and_bucket_match_jax():
    assert _breaker_script(tcb, trl) == _breaker_script(jcb, jrl)
    assert tutils.CircuitBreaker is tcb.CircuitBreaker and tutils.TokenBucket is trl.TokenBucket
    assert {"CircuitBreaker", "CircuitState", "get_circuit_breaker", "retry_with_backoff",
            "TokenBucket", "load_checkpoint", "save_checkpoint",
            "MetricsRegistry"} <= set(dir(tutils))
