"""The port's live signal path, whole, against the JAX package's, on the
CPU; and a ported service on the port's own bus.

    FakeExchange → ResilientExchange → MarketMonitor.poll (the TickEngine)
    → EventBus market_updates → SignalAnalyzer → trading_signals →
    TradeExecutor (→ on_price for each open trade), tick after tick, in the
    launcher's stage order

Both packages run the same ticks on twin paper exchanges behind the
resilient adapter, on one virtual clock, with `bench_recovery`'s trading
parameters (bench.py:974-975) so that entries happen.  The analyzers'
decisions (symbol, decision, confidence) must agree tick for tick, and
then every trade must be equal: fills, books, closures, journal records.
"""

import asyncio
import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.config import TradingParams as JTP  # noqa: E402
from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.shell import analyzer as jan  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import executor as jexe  # noqa: E402
from ai_crypto_trader_tpu.shell import monitor as jmon  # noqa: E402
from ai_crypto_trader_tpu.shell.llm import LLMTrader as JLLM  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu.utils import journal as jjournal  # noqa: E402
from ai_crypto_trader_tpu_torch.config import TradingParams as TTP  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV as TOHLCV  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import analyzer as tan  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import executor as texe  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import monitor as tmon  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader as TLLM  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import journal as tjournal  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

SYMBOLS = ["AAAUSDC", "BBBUSDC", "CCCUSDC"]
FRAMES = ("1m", "5m", "15m")
LIMIT, TICKS = 128, 24
PKGS = {
    "jax": dict(ex=jex, bus=jbus, mon=jmon, an=jan, exe=jexe, llm=JLLM, tp=JTP, ohlcv=JOHLCV,
                journal=jjournal, kw={}),
    "port": dict(ex=tex, bus=tbus, mon=tmon, an=tan, exe=texe, llm=TLLM, tp=TTP, ohlcv=TOHLCV,
                 journal=tjournal, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _loop(pkg, journal_path):
    p = PKGS[pkg]
    clock = [1_000.0]
    series = {}
    for i, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=2_400, seed=7 + i)
        series[s] = p["ohlcv"](timestamp=np.arange(len(d["close"]), dtype=np.int64) * 60_000,
                               open=d["open"], high=d["high"], low=d["low"], close=d["close"],
                               volume=d["volume"] * 1000, symbol=s)
    ex = p["ex"].make_exchange("fake", resilient=True, series=series, resilient_opts={
        "now_fn": lambda: clock[0], "sleep": lambda s: clock.__setitem__(0, clock[0] + s)})
    ex.advance(steps=LIMIT * 15 + 10)
    bus = p["bus"].EventBus(now_fn=lambda: clock[0])
    sigs = bus.subscribe("trading_signals")
    mon = p["mon"].MarketMonitor(bus, ex, symbols=SYMBOLS, intervals=FRAMES, kline_limit=LIMIT,
                                 throttle_s=0.0, now_fn=lambda: clock[0], **p["kw"])
    an = p["an"].SignalAnalyzer(bus, trader=p["llm"](model_version="v"), analysis_interval_s=0.0,
                                now_fn=lambda: clock[0])
    journal = p["journal"].WriteAheadJournal(journal_path, now_fn=lambda: clock[0])
    exe = p["exe"].TradeExecutor(
        bus, ex, trading=p["tp"](ai_confidence_threshold=0.0, min_signal_strength=0.0,
                                 min_trade_amount=1.0),
        now_fn=lambda: clock[0], journal=journal, **p["kw"])
    decisions = []
    for _ in range(TICKS):
        ex.advance()
        clock[0] += 60.0
        await mon.poll()
        await an.run_once()
        decisions.append([(e["data"]["symbol"], e["data"]["decision"], e["data"]["confidence"])
                          for e in (sigs.get_nowait() for _ in range(sigs.qsize()))])
        await exe.run_once()
        for s in list(exe.active_trades):
            await exe.on_price(s, ex.get_ticker(s)["price"])
    journal.close()
    return {"decisions": decisions, "fills": ex.fills, "balances": ex.get_balances(),
            "open_orders": ex.list_open_orders(), "books": exe.snapshot_state(),
            "closed": exe.closed_trades}


def test_whole_loop_trades_equal_jax(tmp_path):
    with jtickpath.use(None), devprof.use(None), meshprof.use(None):
        ref = asyncio.run(_loop("jax", str(tmp_path / "jax.journal")))
    tp = ttickpath.TickPathScope()
    with ttickpath.use(tp):
        got = asyncio.run(_loop("port", str(tmp_path / "port.journal")))
    assert got["decisions"] == ref["decisions"]        # decisions agree first
    for k in ("fills", "balances", "open_orders", "books", "closed"):
        assert got[k] == ref[k], k
    with open(tmp_path / "port.journal", "rb") as a, open(tmp_path / "jax.journal", "rb") as b:
        assert a.read() == b.read()
    # the run traded: entries, protective orders, at least one closure
    assert sum(f["side"] == "BUY" for f in got["fills"]) >= 2 and got["closed"]
    # the port's tick engine fed the observatory a phase a poll
    st = tp.status()["phases"]
    assert st["host_read"]["count"] == TICKS and st["parse"]["count"] == TICKS
    assert st["publish"]["count"] == TICKS


def test_prediction_service_runs_on_the_ports_bus_with_spans():
    """A ported service on the port's own EventBus, traced: PredictionService
    trains and predicts under `model.*` spans carrying the build-vs-execute
    breakdown, and publishes on the port's bus."""
    from ai_crypto_trader_tpu_torch.models.service import PredictionService

    rng = np.random.default_rng(0)
    close = 100.0 * np.cumprod(1 + rng.normal(0, 0.003, 160))
    klines = [[i * 60_000, c * 0.999, c * 1.002, c * 0.997, c, 1000.0 + rng.uniform(0, 10)]
              for i, c in enumerate(close)]
    bus = tbus.EventBus(now_fn=lambda: 5_000.0)
    bus.set("historical_data_BTCUSDC_1m", klines)
    q = bus.subscribe("*")
    svc = PredictionService(bus, ["BTCUSDC"], intervals=("1m",), seq_len=24, epochs=2, units=8,
                            hpo_trials=2, now_fn=lambda: 5_000.0, device="cpu")
    ids = (f"{i:016x}" for i in itertools.count(1))
    tracer = ttracing.Tracer(now_fn=lambda: 5_000.0, id_fn=lambda: next(ids))
    with ttracing.use(tracer):
        asyncio.run(svc.run_once())
    names = [s.name for s in tracer.finished]
    assert "model.train" in names and any(n.startswith("model.predict") for n in names)
    train = next(s for s in tracer.finished if s.name == "model.train")
    assert train.attributes["symbol"] == "BTCUSDC" and "compile_s" in train.attributes
    assert bus.get("nn_prediction_BTCUSDC_1m") is not None
    assert any(e["channel"] == "neural_network_predictions" for e in
               (q.get_nowait() for _ in range(q.qsize())))
