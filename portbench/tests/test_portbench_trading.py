"""The trading cells' yardstick on the CPU: the frozen kline frames against
the program's load generator, the reference decide against the port's, and
the readers of the host's tick times."""

import json

import numpy as np
import pytest

from portbench import run
from portbench.reference import decide as ref
from portbench.traffic.klines import Tape

INTERVALS = ("1m", "3m", "5m", "15m")


@pytest.mark.parametrize("seed", [0, 2**31 + 77])
def test_the_frozen_frames_are_the_programs(seed):
    from ai_crypto_trader_tpu_torch.shell.exchange import FakeExchange
    from ai_crypto_trader_tpu_torch.testing.chaos import kline_frames_for
    from ai_crypto_trader_tpu_torch.testing.loadgen import LoadConfig, _synthetic_series

    n, symbols = 1200, 6
    venue = FakeExchange(_synthetic_series(LoadConfig(symbols=symbols, seed=seed), n))
    tape = Tape(symbols, n, seed)
    venue.advance(steps=64 * 15)
    tape.advance(64 * 15)
    assert tape.symbols == sorted(venue.series)
    for _ in range(17):                   # every frame's bar across a boundary
        venue.advance(steps=1)
        tape.advance()
        assert tape.frames(INTERVALS) == kline_frames_for(venue, tape.symbols, INTERVALS)
    for iv in INTERVALS:
        assert tape.get_klines(tape.symbols[-1], iv, 64) == venue.get_klines(tape.symbols[-1], iv, 64)


def _features(rng, S):
    return {"price": rng.uniform(50, 150, S).astype(np.float32),
            "signal": rng.integers(-1, 2, S).astype(np.int32),
            "strength": rng.uniform(40, 100, S).astype(np.float32),
            "volatility": rng.uniform(0.0, 0.03, S).astype(np.float32),
            "avg_volume": rng.uniform(1e4, 2e5, S).astype(np.float32),
            "valid": rng.random(S) < 0.9}


def test_the_reference_decide_is_the_ports_bit_for_bit():
    from ai_crypto_trader_tpu_torch.config import TradingParams
    from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine

    config = json.loads((run.ROOT / "portbench/configs/trading_64x4x256.json").read_text())
    t = dict(config["tenant"], confidence_threshold=[0.3, 0.8], min_signal_strength=[30.0, 80.0])
    N, S = 16, 8
    rows = ref.draw_tenants(t, N, 11)
    engine = TenantEngine([f"S{i}" for i in range(S)], N,
                          trading=TradingParams(min_trade_amount=t["min_trade_amount"]),
                          confidence_scale=t["confidence_scale"], fee_rate=t["fee_rate"],
                          quarantine_cooldown=t["quarantine_cooldown"], device="cpu")
    for i in range(N):
        engine.set_tenant(i, balance=float(rows["balance"][i]),
                          **{k: rows[k][i] for k in ("conf_threshold", "min_strength",
                                                     "max_positions", "min_trade")})
    state, params = ref.initial_state(rows["balance"], S), ref.tenant_params(rows, t)
    rng = np.random.default_rng(3)
    executed = 0
    for _ in range(12):
        feats = _features(rng, S)
        got = engine.decide(feats)
        want, state = ref.decide(state, params, feats)
        executed += int((want["gate"] == ref.EXECUTABLE).sum())
        for k in ("gate", "confidence", "size", "equity"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert executed > 0
    for k in ("open", "balance", "peak_equity", "max_drawdown", "entry", "qty"):
        np.testing.assert_array_equal(engine._state_np[k], state[k], err_msg=k)


def test_the_host_readers_leave_out_the_profiled_ticks():
    host = [{"stream": 5.0, "tick": 3.0, "decide": 2.0, "total": 7.0, "profiled": False},
            {"stream": 9.0, "tick": 5.0, "decide": 4.0, "total": 13.0, "profiled": True},
            {"stream": 7.0, "tick": 3.0, "decide": 4.0, "total": 11.0, "profiled": False}]
    record = run.RunRecord({}, host, {}, {"busy_s": 1.0, "window_s": 4.0})
    assert run.load_reader("stream.ingest_ms")(record) == pytest.approx(3.0)
    assert run.load_reader("tick.step_ms")(record) == pytest.approx(3.0)
    assert run.load_reader("decide.ms")(record) == pytest.approx(3.0)
    assert run.load_reader("decide.tick_p95_ms")(record) == pytest.approx(7.0 + 0.95 * 4.0)
    assert run.load_reader("device.idle_pct.trading")(record) == pytest.approx(75.0)
    assert run.load_reader("tick.step_ms")(run.RunRecord({}, host[1:2], {}, None)) is None
