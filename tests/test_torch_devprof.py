"""The port's device-runtime observatory (`utils.devprof`) against the JAX
package's, on the CPU.

Host code is held exactly: on one stream of latency observations the SLO
windows, burn rates, exported gauges (the metrics exposition) and the
alert rules they drive are the JAX module's.  The device-side instruments
are the port's own, so they are held to what they promise: the set of
programs carded after one tick-engine step, tenant decide, GA and sweep
is the JAX set; a card's argument/output/alias bytes are its tensors'
``nbytes``; ``temp_bytes`` is None on the CPU with a note saying why; the
tick engine's ring is updated in place (donation ok) and a program that
silently copies instead fails the check; kernel launches add their
reckoned operations and bytes to an open card; the memory watermark
reports nothing on a CPU host (no allocator statistics).
"""

import asyncio

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu.utils import alerts as jalerts  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof as jdevprof  # noqa: E402
from ai_crypto_trader_tpu.utils import meshprof as jmeshprof  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.utils.metrics import MetricsRegistry as JMetrics  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import alerts as talerts  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import devprof as tdevprof  # noqa: E402
from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry as TMetrics  # noqa: E402

SYMBOLS, FRAMES, WINDOW = ["AAAUSDC", "BBBUSDC"], ("1m", "5m"), 64


@pytest.fixture(autouse=True)
def _observatories_off():
    """Each test installs its own; none leaks into another test."""
    with jdevprof.use(None), jmeshprof.use(None), jtickpath.use(None), tdevprof.use(None):
        yield


def _stream(n=200, seed=0):
    """One observation stream: (slo, seconds), burning the tick budget at
    a few percent, with a host_read window below min_samples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(("tick", float(rng.choice([0.2, 0.5, 1.5], p=[0.6, 0.37, 0.03]))))
        out.append(("train_step", float(rng.uniform(0.1, 0.7))))
        if i % 10 == 0:
            out.append(("host_read", float(rng.uniform(0.01, 0.3))))
        out.append(("sim_sweep", float(rng.uniform(0.0, 2.0))))   # no target
    return out


def _fed(mod, metrics_cls, stream, **kw):
    dp = mod.DevProf(metrics=metrics_cls(now_fn=lambda: 0.0), window=64, **kw)
    for name, v in stream:
        dp.observe_latency(name, v)
    dp.export()
    return dp


@pytest.mark.parametrize("window_kw", [{}, {"min_samples": 8, "error_budget": 0.05}])
def test_slo_windows_burn_rates_and_gauges_equal_jax(window_kw):
    stream = _stream()
    j = _fed(jdevprof, JMetrics, stream, **window_kw)
    t = _fed(tdevprof, TMetrics, stream, **window_kw)
    assert t.burn_rates() == j.burn_rates()
    assert t.status()["slos"] == j.status()["slos"]
    assert t.status()["burn_rates"] == j.status()["burn_rates"]
    assert t.metrics.exposition() == j.metrics.exposition()
    assert tdevprof.DEFAULT_SLO_TARGETS == jdevprof.DEFAULT_SLO_TARGETS
    assert tdevprof.DEFAULT_ERROR_BUDGET == jdevprof.DEFAULT_ERROR_BUDGET


def test_percentile_and_sliding_quantiles_equal_jax():
    vals = [float(v) for v in np.random.default_rng(3).normal(size=301)]
    for q in (0, 1, 50, 90, 99, 100):
        assert tdevprof.percentile(vals, q) == jdevprof.percentile(vals, q)
    a, b = tdevprof.SlidingQuantiles(window=50), jdevprof.SlidingQuantiles(window=50)
    for v in vals:
        a.observe(v)
        b.observe(v)
    assert a.summary() == b.summary() and a.frac_over(0.5) == b.frac_over(0.5)


@pytest.mark.parametrize("case", ["burn", "donation", "quiet"])
def test_devprof_alert_rules_fire_as_jax(case):
    """The in-process rule engine fires the same alerts on the same
    devprof state (the launcher's `slo_burn_rates` / `donation_failures`
    inputs)."""
    stream = [("tick", 2.0)] * 40 if case == "burn" else [("tick", 0.1)] * 40
    states = {}
    for name, mod, metrics, al in (("jax", jdevprof, JMetrics, jalerts),
                                   ("port", tdevprof, TMetrics, talerts)):
        dp = _fed(mod, metrics, stream)
        if case == "donation":
            dp.donation_failures.append("tick_engine")
        mgr = al.AlertManager(now_fn=lambda: 0.0)
        fired = mgr.evaluate({"slo_burn_rates": dp.burn_rates(),
                              "donation_failures": list(dp.donation_failures)})
        states[name] = sorted(f["name"] for f in fired)
    assert states["port"] == states["jax"]
    assert bool(states["port"]) == (case != "quiet")


# --- cost cards ----------------------------------------------------------------

def _tape(n=WINDOW * 15 + 40, seed=5):
    from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv

    d = generate_ohlcv(n=n, seed=seed)
    ts = np.arange(n, dtype=np.int64) * 60_000
    return {s: [[int(ts[i]), float(d["open"][i] * (1 + k)), float(d["high"][i] * (1 + k)),
                 float(d["low"][i] * (1 + k)), float(d["close"][i] * (1 + k)),
                 float(d["volume"][i])] for i in range(n)] for k, s in enumerate(SYMBOLS)}


def _frame(rows, iv):
    step = {"1m": 1, "5m": 5}[iv]
    out = []
    for i in range(0, len(rows) - step + 1, step):
        chunk = rows[i:i + step]
        out.append([chunk[0][0], chunk[0][1], max(r[2] for r in chunk),
                    min(r[3] for r in chunk), chunk[-1][4], sum(r[5] for r in chunk)])
    return out[-WINDOW:]


def _tick_engines(**kw):
    from ai_crypto_trader_tpu.ops.tick_engine import TickEngine as JTick
    from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine as TTick

    tape = _tape()
    engines = {"jax": JTick(SYMBOLS, FRAMES, window=WINDOW, **kw),
               "port": TTick(SYMBOLS, FRAMES, window=WINDOW, device="cpu", **kw)}
    for eng in engines.values():
        for s in SYMBOLS:
            for iv in FRAMES:
                eng.ingest(s, iv, _frame(tape[s], iv))
    return engines


def _card_names(pkg):
    """One tick step, one tenant decide, one GA and one sweep under the
    package's devprof: the names of the programs it carded."""
    if pkg == "jax":
        from ai_crypto_trader_tpu import backtest as bt
        from ai_crypto_trader_tpu.config import GAParams
        from ai_crypto_trader_tpu.evolve import backtest_fitness, run_ga
        from ai_crypto_trader_tpu.ops import compute_indicators
        from ai_crypto_trader_tpu.ops.tenant_engine import TenantEngine
        import jax

        mod, kw, key = jdevprof, {}, jax.random.PRNGKey(0)
        dp_kw = {"memory_analysis": False}
    else:
        from ai_crypto_trader_tpu_torch import backtest as bt
        from ai_crypto_trader_tpu_torch.config import GAParams
        from ai_crypto_trader_tpu_torch.evolve import backtest_fitness, run_ga
        from ai_crypto_trader_tpu_torch.ops import compute_indicators
        from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine

        mod, kw, key = tdevprof, {"device": "cpu"}, torch.Generator().manual_seed(0)
        dp_kw = {}
    from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv

    eng = _tick_engines()[pkg]
    d = {k: v for k, v in generate_ohlcv(n=64, seed=2).items() if k != "regime"}
    with mod.use(mod.DevProf(**dp_kw)) as dp:
        out = eng.step()
        ten = TenantEngine(SYMBOLS, 2, **kw)
        ten.decide(ten.feats_from_tick(out, eng.last_valid))
        run_ga(key, backtest_fitness(d, **kw), GAParams(population_size=4, generations=1),
               **kw)
        inp = bt.prepare_inputs(compute_indicators(d, **kw), **kw)
        if pkg == "jax":
            params = bt.sample_params(jax.random.PRNGKey(1), 4)
        else:
            params = bt.sample_params(torch.Generator().manual_seed(1), 4, device="cpu")
        bt.sweep(inp, params, **kw)
        return set(dp.cards), dp


def test_card_names_after_tick_decide_ga_and_sweep_equal_jax():
    j, _ = _card_names("jax")
    t, dp = _card_names("port")
    assert t == j
    assert {"tick_engine", "tenant_engine", "ga_scan", "backtest_sweep"} <= t
    for name, card in dp.cards.items():
        assert card.error is None, (name, card.error)


def test_tick_engine_card_counts_its_tensors_and_the_ring_in_place():
    eng = _tick_engines()["port"]
    with tdevprof.use(tdevprof.DevProf()) as dp:
        eng.step()
        card = dp.cards["tick_engine"]
        ring = eng._bufs[0]
        args = (ring, *eng._dev_in, eng._drift_ref)
        assert card.argument_bytes == sum(t.untyped_storage().nbytes() for t in args)
        assert card.alias_bytes == ring.untyped_storage().nbytes()
        assert card.output_bytes > 0 and card.bytes_accessed > card.output_bytes
        assert card.temp_bytes is None and tdevprof.NOTE_CPU_TEMP in card.notes
        assert card.generated_code_bytes is None and tdevprof.NOTE_NO_CODE in card.notes
        assert card.donation_ok is True and dp.donation_failures == []
        eng.step()                                   # one-shot: the card stays
        assert dp.cards["tick_engine"] is card
        assert dp.status()["memory"] == {}           # no allocator statistics on the CPU
        assert dp.sample_memory() == {}


def test_donation_check_catches_a_silent_copy():
    """A program that replaces a buffer it promised to update in place
    breaks the promise: recorded on the card, the gauge and the alert
    input."""
    metrics = TMetrics(now_fn=lambda: 0.0)
    with tdevprof.use(tdevprof.DevProf(metrics=metrics)) as dp:
        buf = torch.zeros(16)
        promise = tdevprof.donated(inplace=[buf])
        buf.add_(1.0)                                 # in place: kept
        assert tdevprof.verify_donation("inplace", promise, after=[buf]) is True
        promise = tdevprof.donated(inplace=[buf])
        buf = buf + 1.0                               # a copy
        assert tdevprof.verify_donation("copied", promise, after=[buf]) is False
        old = {"s": torch.ones(4)}
        promise = tdevprof.donated(released=old)
        new = {"s": old["s"] * 2.0}
        old = None                                    # the caller drops it: released
        assert tdevprof.verify_donation("released", promise, after=new) is True
        assert dp.donation_failures == ["copied"]
        assert dp.cards["copied"].donation_ok is False
        assert 'program="copied"' in metrics.exposition()
    assert tdevprof.verify_donation("off", promise) is None


@pytest.mark.parametrize("pipelined", [False, True])
def test_tick_engine_donation_fails_when_the_program_updates_a_copy(pipelined, monkeypatch):
    """The ring's donation check looks at what the carded program wrote: a
    `_tick_program` that scatters into a copy of the ring leaves the ring
    itself unwritten, and the card says so."""
    from ai_crypto_trader_tpu_torch.ops import tick_engine

    program = tick_engine._tick_program
    monkeypatch.setattr(tick_engine, "_tick_program",
                        lambda ring, *a: program(ring.clone(), *a))
    eng = _tick_engines(pipelined=pipelined)["port"]
    with tdevprof.use(tdevprof.DevProf()) as dp:
        eng.step()
        assert dp.cards["tick_engine"].donation_ok is False
        assert dp.donation_failures == ["tick_engine"]


def test_kernel_cost_lands_on_the_open_card_only():
    with tdevprof.use(tdevprof.DevProf()) as dp:
        tdevprof.kernel_cost("fused_ewma", 10.0, 40.0)          # no card open
        assert tdevprof.cards_open() is False
        x = torch.ones(4)
        with tdevprof.carding("p", (x,)) as card:
            assert tdevprof.cards_open() is True
            tdevprof.kernel_cost("fused_ewma", 5 * 4, 4 * 8)
            tdevprof.kernel_cost("fused_ewma", 5 * 4, 4 * 8)
            card.result(x * 2.0)
        c = dp.cards["p"]
        assert c.kernels == {"fused_ewma": 2}
        assert c.flops == 40.0
        # the kernels' bytes plus the torch op's input and output
        assert c.bytes_accessed == 64.0 + 2 * x.nbytes
        with tdevprof.carding("p", (x,)) as again:   # carded already: the no-op
            assert again.result(1) == 1


def test_card_error_never_kills_the_dispatch():
    with tdevprof.use(tdevprof.DevProf()) as dp:
        with pytest.raises(ValueError):
            with tdevprof.carding("boom", (torch.ones(2),)):
                raise ValueError("the program's own failure")
        assert "ValueError" in dp.cards["boom"].error


def test_disabled_helpers_are_one_check():
    assert tdevprof.active() is None
    assert tdevprof.carding("x", (torch.ones(1),)) is tdevprof._NOOP_CARD
    assert tdevprof.donated(inplace=[torch.ones(1)]) is None
    assert tdevprof.has_card("x") is False
    tdevprof.observe_latency("tick", 1.0)
    tdevprof.kernel_cost("fused_ewma", 1.0, 1.0)
    assert tdevprof.cards_open() is False


def test_launcher_devprof_ticks_equal_and_fill_the_windows():
    """A CPU TradingSystem with devprof on: its tick and host_read windows
    fill, its tick-engine card is taken, and the status is that of the
    same ticks with devprof off."""
    from ai_crypto_trader_tpu_torch.data import from_dict, generate_ohlcv
    from ai_crypto_trader_tpu_torch.shell import FakeExchange
    from ai_crypto_trader_tpu_torch.shell.launcher import TradingSystem
    from ai_crypto_trader_tpu_torch.utils.health import EventLoopLagProbe

    def run(on):
        d = {k: v for k, v in generate_ohlcv(n=700, seed=4).items() if k != "regime"}
        ex = FakeExchange({"BTCUSDC": from_dict(d, symbol="BTCUSDC")})
        ex.advance(steps=640)
        clock = [0.0]
        s = TradingSystem(ex, ["BTCUSDC"], device="cpu", now_fn=lambda: clock[0],
                          enable_devprof=on, tick_budget_s=1e9)
        s.loop_lag = EventLoopLagProbe(clock=lambda: 0.0)
        try:
            for _ in range(4):
                ex.advance()
                clock[0] += 60.0
                asyncio.run(s.tick())
            return s.status(), (s.devprof.status() if on else None)
        finally:
            s.shutdown()

    on_status, st = run(True)
    off_status, _ = run(False)
    assert on_status == off_status
    assert st["slos"]["tick"]["count"] == 4 and st["slos"]["host_read"]["count"] >= 4
    assert "tick_engine" in st["cost_cards"]
    assert tdevprof.active() is None


def test_step_timer_feeds_its_histogram_and_slo_window():
    """`utils.profiling.StepTimer`: each step lands in the registry's
    histogram and, with the observatory on, in the SLO window of its name,
    with the JAX timer's count/window/p50/p99 summary."""
    from ai_crypto_trader_tpu.utils import profiling as jprofiling
    from ai_crypto_trader_tpu_torch.utils import profiling as tprofiling

    metrics = TMetrics(now_fn=lambda: 0.0)
    timer = tprofiling.StepTimer(metrics=metrics, name="train_step", window=4)
    with tdevprof.use(tdevprof.DevProf()) as dp:
        for _ in range(6):
            with timer.step() as s:
                s.block(torch.ones(8) * 2.0)
    assert timer.count == 6 and len(timer.history) == 4
    assert set(timer.summary()) == set(jprofiling.StepTimer().summary())
    assert dp.status()["slos"]["train_step"]["count"] == 6
    assert "train_step_count 6" in metrics.exposition().replace("crypto_trader_tpu_", "")
    with tprofiling.annotate("region"):
        torch.ones(2).sum()
