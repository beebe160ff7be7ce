"""The port's signal analyzer, trade executor and journal recovery against
the JAX package's, on the CPU.

    market_updates → SignalAnalyzer.run_once (the rule backend, context,
    explanations) → trading_signals → TradeExecutor.handle_signal (gates,
    float32 sizing, SL/TP, social factors, protective orders, journal) →
    on_price (trailing stops, ratchets, closures) → recover_from_journal

Both executors get the same signal dicts on twin `FakeExchange`s.  The
JAX executor sizes in float32 (x64 off: the sizer's Python floats enter
its arrays rounded once); the port sizes in float32 tensors
(`shell.executor.position_plan`), so sizes, quantities, SL/TP and the
trailing stops are compared bit for bit, and so are the books, the fills
and the journal files.  A journal written by either executor, recovered by
the other, gives the same books and report.  Analyzer signals are
compared whole (the trader's ``model_version`` is fixed in both), and so
are the explanations but for their wall-clock ``generated_at``.
"""

import asyncio
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.backtest import signals as jsig  # noqa: E402
from ai_crypto_trader_tpu.config import TradingParams as JTP  # noqa: E402
from ai_crypto_trader_tpu.config import TrailingStopParams as JTSP  # noqa: E402
from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.risk.social import SocialSnapshot as JSocial  # noqa: E402
from ai_crypto_trader_tpu.shell import analyzer as jan  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import executor as jexe  # noqa: E402
from ai_crypto_trader_tpu.shell.llm import LLMTrader as JLLM  # noqa: E402
from ai_crypto_trader_tpu.utils import journal as jjournal  # noqa: E402
from ai_crypto_trader_tpu_torch.config import TradingParams as TTP  # noqa: E402
from ai_crypto_trader_tpu_torch.config import TrailingStopParams as TTSP  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV as TOHLCV  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.risk.social import SocialSnapshot as TSocial  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import analyzer as tan  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import executor as texe  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader as TLLM  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import journal as tjournal  # noqa: E402

SYMBOLS = ["BTCUSDC", "ETHUSDC", "SOLUSDC", "ADAUSDC"]
PKGS = {
    "jax": dict(ex=jex, bus=jbus, exe=jexe, an=jan, llm=JLLM, tp=JTP, tsp=JTSP, ohlcv=JOHLCV,
                social=JSocial, journal=jjournal, kw={}),
    "port": dict(ex=tex, bus=tbus, exe=texe, an=tan, llm=TLLM, tp=TTP, tsp=TTSP, ohlcv=TOHLCV,
                 social=TSocial, journal=tjournal, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with jtickpath.use(None), ttickpath.use(None):
        yield
    torch.set_num_threads(n)


def _bits(x: float) -> int:
    return int(np.float64(x).view(np.int64))


# --- the sizer --------------------------------------------------------------

def test_position_plan_is_the_jax_float32_sizing_bit_for_bit():
    rng = np.random.default_rng(11)
    n = 300
    balance = np.concatenate([rng.uniform(50.0, 50_000.0, n - 4), [40.0, 400.0, 9_999.99, 1e6]])
    vol = np.concatenate([rng.uniform(0.0, 0.04, n - 6),
                          [0.01, 0.02, np.nextafter(0.01, 1), np.nextafter(0.02, 0), 0.0, 0.3]])
    volume = np.concatenate([rng.uniform(0.0, 120_000.0, n - 3), [50_000.0, 0.0, 49_999.999]])
    rng.shuffle(vol)
    for b, v, w in zip(balance.tolist(), vol.tolist(), volume.tolist()):
        plan = jsig.position_size(b, v, w)
        want = [float(np.asarray(plan.size)), float(np.asarray(plan.stop_loss_pct)),
                float(np.asarray(plan.take_profit_pct))]
        got = texe.position_plan(b, v, w, torch.device("cpu"))
        assert [_bits(x) for x in got] == [_bits(x) for x in want], (b, v, w, got, want)


# --- the analyzer -----------------------------------------------------------

def _updates():
    """Market updates as the monitor publishes them (the port's monitor on
    the CPU, a small universe), with the social, news and pattern keys the
    analyzer folds into its context."""
    from test_torch_monitor import _run

    runs = _run("port", polls=4)
    return [u for poll in runs["payloads"] for u in poll]


def _analyze(pkg, updates):
    p = PKGS[pkg]
    clock = [10_000.0]
    bus = p["bus"].EventBus(now_fn=lambda: clock[0])
    q = bus.subscribe("trading_signals*")
    an = p["an"].SignalAnalyzer(bus, trader=p["llm"](model_version="v-test"),
                                analysis_interval_s=90.0, now_fn=lambda: clock[0])
    lane = p["an"].SignalAnalyzer(bus, trader=p["llm"](model_version="v-lane"),
                                  analysis_interval_s=0.0, now_fn=lambda: clock[0], lane="7")
    bus.set("social_metrics_BTCUSDC", {"social_sentiment": 0.8, "social_volume": 12})
    bus.set("news_analysis_ETHUSDC", {"sentiment": -0.2, "headline": "x"})
    bus.set("pattern_signals_BTCUSDC", {"pattern": "double_bottom", "confidence": 0.7})

    async def go():
        for u in updates:
            clock[0] += 20.0
            await bus.publish("market_updates", u)
            await an.run_once()
        await lane.handle_update(updates[-1])
        return [q.get_nowait() for _ in range(q.qsize())]

    sigs = asyncio.run(go())
    keys = {k: bus.get(k) for k in sorted(bus.keys("*"))}
    # an explanation's `generated_at` is the wall clock (strategy.explain)
    stamped = [v for k, v in keys.items() if k.startswith("explanation_")] + keys["explanations"]
    for e in {id(e): e for e in stamped}.values():         # one object may sit in both
        e.pop("generated_at")
    return sigs, keys


def test_analyzer_signals_and_explanations_match_jax():
    updates = _updates()
    got, ref = _analyze("port", updates), _analyze("jax", updates)
    assert got == ref
    sigs = got[0]
    assert sigs[-1]["channel"] == "trading_signals.7" and sigs[-1]["data"]["lane"] == "7"
    assert 0 < len(sigs) < len(updates)                # the interval gate held some
    assert "explanations" in got[1]


# --- the executor -----------------------------------------------------------

def _exchange(p):
    series = {}
    for i, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=600, seed=20 + i)
        scale = 1.0 / (1 + 3 * i)
        series[s] = p["ohlcv"](timestamp=np.arange(600, dtype=np.int64) * 60_000,
                               open=d["open"] * scale, high=d["high"] * scale,
                               low=d["low"] * scale, close=d["close"] * scale,
                               volume=d["volume"], symbol=s)
    ex = p["ex"].FakeExchange(series, fee_rate=0.001)
    ex.advance(steps=100)
    return ex


def _signals(rng, n_ticks=48):
    """A seeded stream of signal dicts: some executable, some gated."""
    out = []
    for t in range(n_ticks):
        row = []
        for s in SYMBOLS:
            if rng.random() < 0.35:
                row.append({"symbol": s, "signal": "BUY", "decision": "BUY",
                            "confidence": float(rng.uniform(0.6, 0.95)),
                            "signal_strength": float(rng.uniform(60.0, 100.0)),
                            "volatility": float(rng.uniform(0.002, 0.03)),
                            "avg_volume": float(rng.uniform(1_000.0, 90_000.0)),
                            "top_family": "trend_confirmation", "structure_version": 3,
                            "model_version": "m1", "decision_id": f"d{t}-{s}"})
        out.append(row)
    return out


async def _drive(pkg, strategy, journal_path, live_params=False):
    p = PKGS[pkg]
    clock = [20_000.0]
    ex = _exchange(p)
    bus = p["bus"].EventBus(now_fn=lambda: clock[0])
    journal = p["journal"].WriteAheadJournal(journal_path, now_fn=lambda: clock[0])
    exe = p["exe"].TradeExecutor(
        bus, ex, trading=p["tp"](max_positions=3),
        trailing=p["tsp"](strategy=strategy, activation_threshold_pct=0.3, trail_percent=0.4,
                          fixed_trail_amount=0.05),
        now_fn=lambda: clock[0], journal=journal, **p["kw"])
    rng = np.random.default_rng(5)
    bus.set("social_snapshot_ETHUSDC", p["social"](
        sentiments=np.asarray(rng.uniform(0.6, 0.9, (5, 4)), np.float32),
        age_hours=np.asarray(rng.uniform(0.0, 12.0, 5), np.float32),
        data_quality=np.float32(0.9)))
    bus.set("social_snapshot_SOLUSDC", {"position_size_factor": 0.8, "stop_loss_factor": 1.1,
                                        "take_profit_factor": 0.9})
    if live_params:
        bus.set("strategy_params", {"stop_loss": 1.25, "take_profit": 2.75})
    stops, sizes = [], []
    for row in _signals(rng):
        ex.advance()
        clock[0] += 60.0
        for s in SYMBOLS:
            c = ex.get_ticker(s)["price"]
            bus.set(f"market_data_{s}", {"atr": c * 0.004, "volatility": 0.003})
        for sig in row:
            sig = {**sig, "current_price": ex.get_ticker(sig["symbol"])["price"],
                   "timestamp": clock[0]}
            trade = await exe.handle_signal(sig)
            if trade is not None:
                sizes.append((trade.symbol, _bits(trade.quantity), _bits(trade.stop_loss_pct),
                              _bits(trade.take_profit_pct)))
        for s in list(exe.active_trades):
            await exe.on_price(s, ex.get_ticker(s)["price"])
            if s in exe.active_trades:
                stops.append((s, _bits(float(exe.active_trades[s].trailing_state.stop))))
    journal.flush()
    books = {"snapshot": exe.snapshot_state(), "closed": exe.closed_trades,
             "fills": ex.fills, "balances": ex.get_balances(),
             "open_orders": ex.list_open_orders(), "sizes": sizes, "stops": stops}
    journal.close()
    return books, ex


@pytest.mark.parametrize("strategy", ["percent_based", "atr_based", "volatility_based",
                                      "fixed_amount"])
def test_executor_books_match_jax_bit_for_bit(tmp_path, strategy):
    got = {pkg: asyncio.run(_drive(pkg, strategy, str(tmp_path / f"{pkg}.journal")))[0]
           for pkg in PKGS}
    assert got["port"] == got["jax"]
    with open(tmp_path / "port.journal", "rb") as a, open(tmp_path / "jax.journal", "rb") as b:
        assert a.read() == b.read()
    books = got["port"]
    assert len(books["sizes"]) >= 3 and books["stops"] and books["closed"]
    ratchets = {s for s, _ in books["stops"]}
    assert any(len({b for s2, b in books["stops"] if s2 == s}) > 1 for s in ratchets), \
        "no trailing stop ratcheted: the run is vacuous"


def test_live_params_override_the_sizer_exits(tmp_path):
    got = {pkg: asyncio.run(_drive(pkg, "percent_based", str(tmp_path / f"{pkg}.journal"),
                                   live_params=True))[0] for pkg in PKGS}
    assert got["port"] == got["jax"]
    pcts = {(t["stop_loss_pct"], t["take_profit_pct"])
            for t in got["port"]["snapshot"]["active"].values()}
    assert (1.25, 2.75) in pcts


async def _recover(pkg, journal_path, ex):
    p = PKGS[pkg]
    clock = [90_000.0]
    bus = p["bus"].EventBus(now_fn=lambda: clock[0])
    journal = p["journal"].WriteAheadJournal(journal_path, now_fn=lambda: clock[0])
    exe = p["exe"].TradeExecutor(bus, ex, trading=p["tp"](max_positions=3),
                                 now_fn=lambda: clock[0], journal=journal, **p["kw"])
    report = await exe.recover_from_journal()
    state = exe.snapshot_state()
    journal.close()
    return report, state, ex.fills, ex.list_open_orders()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_written_by_one_recovers_in_the_other(tmp_path, writer, reader):
    """A crash at the end of the run: the writer's journal gains an entry
    intent that never reached the venue and an exit intent in flight; the
    reader recovers it against its own twin of the venue, and its books
    equal the writer package's own recovery of the same journal."""
    path = str(tmp_path / "w.journal")
    books, _ = asyncio.run(_drive(writer, "percent_based", path))
    j = PKGS[writer]["journal"].WriteAheadJournal(path, now_fn=lambda: 80_000.0)
    j.append("entry_intent", {"symbol": "ADAUSDC", "client_order_id": "wj-ent-ADAUSDC-999",
                              "quantity": 1.0, "sl_pct": 2.0, "tp_pct": 4.0, "coid_seq": 999,
                              "source": None}, flush=True)
    j.close()
    out = {}
    for pkg in (reader, writer):
        copy = str(tmp_path / f"{pkg}-read.journal")
        shutil.copy(path, copy)
        _, ex = asyncio.run(_drive(writer if pkg == writer else reader, "percent_based",
                                   str(tmp_path / f"{pkg}-twin.journal")))
        out[pkg] = asyncio.run(_recover(pkg, copy, ex))
    assert out[reader] == out[writer]
    report, state = out[reader][0], out[reader][1]
    assert report["discarded"] >= 1 and report["replayed_records"] > 10
    assert state["active"] and state["closed_total_n"] == len(books["closed"])
