"""The port's flight recorder (`obs.flightrec`) against the JAX package's,
on the CPU: records, queries, status and metrics from the same calls; the
checksummed JSONL, written by either package and loaded by both;
`load_decisions` and `format_why`; and the recorder as the port's analyzer
and executor feed it on the live path.

Ids come from an injected ``id_fn`` and times from an injected clock, so
host records are held exactly.  On the live path the decision records
carry the tick engine's floats, held within tests/test_torch_tick.py's
bounds; everything else in them is held exactly.
"""

import asyncio
import itertools
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.config import TradingParams as JTP  # noqa: E402
from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import flightrec as jfr  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.shell import analyzer as jan  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import executor as jexe  # noqa: E402
from ai_crypto_trader_tpu.shell import monitor as jmon  # noqa: E402
from ai_crypto_trader_tpu.shell.llm import LLMTrader as JLLM  # noqa: E402
from ai_crypto_trader_tpu.utils import metrics as jmetrics  # noqa: E402
from ai_crypto_trader_tpu.utils import tracing as jtracing  # noqa: E402
from ai_crypto_trader_tpu_torch.config import TradingParams as TTP  # noqa: E402
from ai_crypto_trader_tpu_torch.data.ingest import OHLCV as TOHLCV  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import flightrec as tfr  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import analyzer as tan  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import executor as texe  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import monitor as tmon  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader as TLLM  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import tracing as ttracing  # noqa: E402

PKGS = {"jax": dict(fr=jfr, metrics=jmetrics, tracing=jtracing),
        "port": dict(fr=tfr, metrics=tmetrics, tracing=ttracing)}


class Clock:
    def __init__(self, t=1_700_000_000.0, step=7.25):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _ids(prefix="r"):
    it = (f"{prefix}{i:05d}" for i in itertools.count(1))
    return lambda: next(it)


def _recorder_script(fr, metrics, tracing, path=None, ring_size=4096):
    """Every public call of the recorder, in the order a live run makes
    them, with a ring small enough to evict in one variant."""
    reg = metrics.MetricsRegistry(now_fn=Clock())
    rec = fr.FlightRecorder(path=path, metrics=reg, now_fn=Clock(), ring_size=ring_size,
                            fsync_every=3, id_fn=_ids())
    tracer = tracing.Tracer(service="t", now_fn=Clock(), id_fn=_ids("s"))
    ids = []
    with tracing.use(tracer):
        with tracing.span("tick"):
            ids.append(rec.begin("AAAUSDC", features={"rsi": 28.5, "signal": "BUY"},
                                 predictions={"lstm:1m": {"predicted_price": 101.5}},
                                 verdict={"decision": "BUY", "confidence": 0.8},
                                 explanation={"narrative": "oversold"}, event_age_ms=12.5))
    ids.append(rec.begin("BBBUSDC", features={"rsi": 55.0}, lane=3))
    ids.append(rec.begin("AAAUSDC"))
    ids.append(rec.begin("CCCUSDC", verdict={"decision": "HOLD", "confidence": 0.4}))
    rec.set_verdict(ids[1], {"decision": "SELL", "confidence": 0.6},
                    explanation={"supporting_factors": ["macd"], "narrative": "bearish",
                                 "extra": 1})
    rec.set_verdict("missing", {"decision": "BUY"})
    rec.veto(ids[1], "not_buy")
    rec.veto(ids[1], "confidence_floor")           # first gate wins
    rec.veto(None, "nan_gate", symbol="DDDUSDC")
    rec.veto(None, "nan_gate")                     # nothing to attach to
    for _ in range(3):
        rec.throttled("AAAUSDC")
    rec.execution(ids[0], "wj-ent-AAAUSDC-1", symbol="AAAUSDC", quantity=0.5, price=100.0)
    rec.fill("wj-ent-AAAUSDC-1", 100.25, 0.5, symbol="AAAUSDC")
    rec.fill("unknown-coid", 1.0, 1.0)
    rec.veto(ids[3], "quarantine")
    rec.execution(ids[3], "wj-ent-CCCUSDC-2", symbol="CCCUSDC")   # supersedes the veto
    rec.execution("gone", "wj-ent-EEEUSDC-3", symbol="EEEUSDC")
    rec.closure("wj-ent-AAAUSDC-1", "AAAUSDC", 104.0, 1.875, "Take Profit")
    rec.closure("orphan-coid", "FFFUSDC", 50.0, -2.0, "Stop Loss")
    n_open = rec.mark_open("quarantine", detail="executor stage quarantined")
    rec.export()
    out = {"query": rec.query(limit=0), "by_symbol": rec.query(symbol="AAAUSDC", limit=2),
           "by_lane": rec.query(lane=3), "by_trace": rec.query(trace_id="s00001"),
           "why": rec.why("AAAUSDC", n=5), "status": {**rec.status(), "journal": None},
           "n_open": n_open, "counts": (rec.recorded, rec.vetoed, rec.executed, rec.closed),
           "exposition": reg.exposition()}
    rec.close()
    return out


@pytest.mark.parametrize("ring_size", [4096, 3])
def test_recorder_calls_match_jax(ring_size):
    got = _recorder_script(ring_size=ring_size, **PKGS["port"])
    ref = _recorder_script(ring_size=ring_size, **PKGS["jax"])
    assert got == ref
    if ring_size == 3:
        assert len(got["query"]) == 3
    else:
        assert {r["status"] for r in got["query"]} == {"closed", "vetoed", "executed"}
        assert got["by_trace"][0]["trace_id"] == "s00001"


def test_jsonl_is_byte_equal_and_loads_in_both_packages(tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in PKGS}
    for pkg, mods in PKGS.items():
        _recorder_script(path=paths[pkg], **mods)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    loaded = {(writer, reader): PKGS[reader]["fr"].load_decisions(paths[writer])
              for writer in PKGS for reader in PKGS}
    first = loaded[("jax", "jax")]
    assert all(v == first for v in loaded.values())
    records, stats = first
    assert stats["corrupt_records"] == 0 and not stats["torn_tail"]
    assert any(r.get("orphan_closure") for r in records)
    assert any(r["status"] == "closed" and r["fills"] for r in records)


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_middle"])
def test_damaged_jsonl_loads_alike(tmp_path, damage):
    path = str(tmp_path / "decisions.jsonl")
    _recorder_script(path=path, **PKGS["port"])
    with open(path) as f:
        lines = f.readlines()
    if damage == "torn_tail":
        lines[-1] = lines[-1][: len(lines[-1]) // 2]
    else:
        lines[2] = lines[2].replace('"gate"', '"GATE"', 1)
    with open(path, "w") as f:
        f.writelines(lines)
    got, ref = tfr.load_decisions(path), jfr.load_decisions(path)
    assert got == ref
    assert got[1]["torn_tail"] or got[1]["corrupt_records"]


def _why_records():
    rng = np.random.default_rng(4)
    recs = []
    for i in range(12):
        status = ("vetoed", "executed", "closed", "open")[i % 4]
        recs.append({
            "t": 1_700_000_000.0 + 61 * i if i != 5 else None, "symbol": "AAAUSDC",
            "lane": i if i % 3 == 0 else None, "status": status,
            "gate": "confidence_floor" if status == "vetoed" else None,
            "gate_detail": "0.31 < 0.7" if i % 8 == 0 else None,
            "exec": {"client_order_id": f"wj-ent-AAAUSDC-{i}"} if status != "vetoed" else None,
            "fills": ([{"quantity": float(rng.uniform(0, 1)), "price": float(rng.uniform(1e3, 5e4))}]
                      if status == "closed" or i == 1 else []),
            "closure": ({"reason": "Trailing Stop", "pnl": float(rng.normal(0, 50))}
                        if status == "closed" else None),
            "verdict": ({"decision": "BUY", "confidence": float(rng.uniform())}
                        if i % 2 == 0 else None),
            "explanation": {"narrative": f"because {i}"} if i % 5 else None})
    return recs


def test_format_why_matches_jax():
    recs = _why_records()
    assert tfr.format_why(recs) == jfr.format_why(recs)
    assert tfr.format_why([]) == []


# --- the live path feeding the recorder ------------------------------------

SYMBOLS = ["AAAUSDC", "BBBUSDC"]
FRAMES = ("1m", "5m")
LIMIT, TICKS = 64, 20
LIVE = {
    "jax": dict(ex=jex, bus=jbus, mon=jmon, an=jan, exe=jexe, llm=JLLM, tp=JTP, ohlcv=JOHLCV,
                fr=jfr, tickpath=jtickpath, kw={}),
    "port": dict(ex=tex, bus=tbus, mon=tmon, an=tan, exe=texe, llm=TLLM, tp=TTP, ohlcv=TOHLCV,
                 fr=tfr, tickpath=ttickpath, kw={"device": "cpu"}),
}


async def _live(pkg, path):
    p = LIVE[pkg]
    clock = [1_000.0]
    series = {}
    for i, s in enumerate(SYMBOLS):
        d = generate_ohlcv(n=LIMIT * 5 + TICKS + 40, seed=21 + i)
        series[s] = p["ohlcv"](timestamp=np.arange(len(d["close"]), dtype=np.int64) * 60_000,
                               open=d["open"], high=d["high"], low=d["low"], close=d["close"],
                               volume=d["volume"] * 1000, symbol=s)
    ex = p["ex"].make_exchange("fake", resilient=True, series=series, resilient_opts={
        "now_fn": lambda: clock[0], "sleep": lambda s: clock.__setitem__(0, clock[0] + s)})
    ex.advance(steps=LIMIT * 5 + 10)
    rec = p["fr"].FlightRecorder(path=path, now_fn=lambda: clock[0], id_fn=_ids("d"))
    bus = p["bus"].EventBus(now_fn=lambda: clock[0])
    mon = p["mon"].MarketMonitor(bus, ex, symbols=SYMBOLS, intervals=FRAMES, kline_limit=LIMIT,
                                 throttle_s=0.0, now_fn=lambda: clock[0], **p["kw"])
    an = p["an"].SignalAnalyzer(bus, trader=p["llm"](model_version="v"),
                                analysis_interval_s=90.0, now_fn=lambda: clock[0],
                                flightrec=rec)
    exe = p["exe"].TradeExecutor(
        bus, ex, trading=p["tp"](ai_confidence_threshold=0.5, min_signal_strength=0.0,
                                 min_trade_amount=1.0, max_positions=1),
        now_fn=lambda: clock[0], flightrec=rec, **p["kw"])
    an._queue()
    exe._queue()
    with p["tickpath"].use(p["tickpath"].TickPathScope()):
        for _ in range(TICKS):
            ex.advance()
            clock[0] += 60.0
            await mon.poll()
            await an.run_once()
            await exe.run_once()
            for s in list(exe.active_trades):
                await exe.on_price(s, ex.get_ticker(s)["price"])
    rec.close()
    return {"records": rec.query(limit=0), "status": {**rec.status(), "journal": None},
            "throttled": rec.throttled_counts, "why": {s: rec.why(s) for s in SYMBOLS},
            "closed": exe.closed_trades}


def _feature_tol(key, feats):
    close = abs(feats.get("current_price", 0.0))
    if key.startswith("macd"):
        return 2e-5, 1e-3 + 2e-6 * close
    if key == "signal_strength":
        return 1e-5, 1e-4 + (20 * (1e-3 + 2e-6 * close) if abs(feats.get("macd", 0)) < 1 else 0)
    if key in ("confluence", "top_family_score"):
        return 1e-5, 2e-3
    if key == "trend_strength":
        return 1e-5, 5e-5
    return 1e-5, 1e-6


def _same_records(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, rv in r.items():
            if k != "features":
                assert g[k] == rv, k
                continue
            assert set(g[k]) == set(rv)
            for f, v in rv.items():
                if isinstance(v, float):
                    rtol, atol = _feature_tol(f, rv)
                    assert abs(g[k][f] - v) <= atol + rtol * abs(v), (f, g[k][f], v)
                else:
                    assert g[k][f] == v, f


def test_live_path_feeds_the_recorder_as_jax(tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in LIVE}
    with ttickpath.use(None), jtickpath.use(None):
        ref = asyncio.run(_live("jax", paths["jax"]))
        got = asyncio.run(_live("port", paths["port"]))
    _same_records(got["records"], ref["records"])
    for k in ("status", "throttled", "why", "closed"):
        assert got[k] == ref[k], k
    gates = {r["gate"] for r in got["records"] if r["status"] == "vetoed"}
    assert {"position_open", "max_positions"} & gates
    assert got["status"]["executed"] >= 1 and got["throttled"]
    # the port's file, replayed by both packages, joins the same chains
    port_recs, _ = tfr.load_decisions(paths["port"])
    assert jfr.load_decisions(paths["port"])[0] == port_recs
    _same_records(port_recs, jfr.load_decisions(paths["jax"])[0])
    assert all(r["event_age_ms"] is not None for r in got["records"] if r["verdict"])
