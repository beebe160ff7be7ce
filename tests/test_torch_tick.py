"""The port's live tick path against the JAX package, on the CPU.

    kline windows → TickEngine.ingest → TickEngine.step: the ring scatter,
    the windows, compute_indicators, signals, volume_profile,
    combined_indicators → combination_signal, drift, one host read

Inputs come from the JAX package's `generate_ohlcv` (seeded) through its
`FakeExchange`, as tests/test_tick_engine.py builds them; both engines see
the same kline tape.  Tolerances sit next to each assert.  The default is
JAX's own ring-delta tolerance (rtol 1e-5, atol 1e-6,
tests/test_tick_engine.py:343-352); a few fields carry MACD or the long
SMAs, whose rounding in the port differs from the jitted JAX program's by
a few ulps of the price (tests/test_torch_indicators.py), and get a bound
derived from that.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu import ops as jops  # noqa: E402
from ai_crypto_trader_tpu.data import ingest as jingest  # noqa: E402
from ai_crypto_trader_tpu.data.fetchers import SocialDaily as JSocialDaily  # noqa: E402
from ai_crypto_trader_tpu.data.ingest import OHLCV as JOHLCV  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.models.train_loop import _PRECISIONS as JAX_PRECISIONS  # noqa: E402
from ai_crypto_trader_tpu.obs import drift as jdrift  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath  # noqa: E402
from ai_crypto_trader_tpu.ops import combinations as jcomb  # noqa: E402
from ai_crypto_trader_tpu.ops.tick_engine import TickEngine as JTickEngine  # noqa: E402
from ai_crypto_trader_tpu.ops.volume_profile import volume_profile as jvolume_profile  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu.shell.exchange import FakeExchange  # noqa: E402
from ai_crypto_trader_tpu_torch import data as tdata  # noqa: E402
from ai_crypto_trader_tpu_torch.device import PRECISIONS  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import drift  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import (  # noqa: E402
    combination_signal, combined_indicators, volume_profile)
from ai_crypto_trader_tpu_torch.ops import tick_engine  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine  # noqa: E402

LIMIT = 128
SYMBOLS = ["BTCUSDC", "ETHUSDC", "SOLUSDC"]
FRAMES = ("1m", "5m", "15m")     # 15m stays warming: 128 × 15 > 700 candles
TICKS = 5                        # incremental ticks after the seed


def _series(n=900, seed=7, symbol="BTCUSDC"):
    d = generate_ohlcv(n=n, seed=seed)
    return JOHLCV(timestamp=np.arange(n, dtype=np.int64) * 60_000,
                  open=d["open"], high=d["high"], low=d["low"],
                  close=d["close"], volume=d["volume"] * 1000, symbol=symbol)


def _exchange(symbols=SYMBOLS, n=900, advance=700):
    ex = FakeExchange({s: _series(n=n, seed=7 + i, symbol=s)
                       for i, s in enumerate(symbols)})
    ex.advance(steps=advance)
    return ex


def _feed(engines, ex, symbols=SYMBOLS, frames=FRAMES):
    for s in symbols:
        for iv in frames:
            kl = ex.get_klines(s, iv, LIMIT)
            for eng in engines:
                eng.ingest(s, iv, kl)


def _windows(shape=(2, 3), T=256, seed=5):
    """[*shape, T] OHLCV windows cut from one seeded series."""
    n = int(np.prod(shape))
    d = generate_ohlcv(n=T * n, seed=seed)
    return {k: d[k].reshape((n, T))[:, :].reshape(shape + (T,)).astype(np.float32)
            for k in ("open", "high", "low", "close", "volume")}


def _flat(out):
    return {**{k: v for k, v in out.items() if k != "combo"},
            **{"combo." + k: v for k, v in out["combo"].items()}}


def _assert_tree_equal(a, b, where=""):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for k in b:
        if isinstance(b[k], dict):
            _assert_tree_equal(a[k], b[k], f"{where}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}/{k}")


# --- the building blocks ---------------------------------------------------

def test_volume_profile_matches_jax():
    w = _windows()
    ref = jvolume_profile(*(jnp.asarray(w[k]) for k in ("high", "low", "close", "volume")))
    got = volume_profile(*(torch.from_numpy(w[k]) for k in ("high", "low", "close", "volume")))
    assert set(got) == set(ref)
    for k, r in ref.items():
        r, g = np.asarray(r), got[k].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k in ("histogram", "total_volume"):
            # a one-hot mask times the volume summed over T (a fixed order on
            # the card) where XLA adds the bins' volumes in candle order
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=0.0, err_msg=k)
        else:
            # the bins, the POC and the value area are exactly JAX's
            np.testing.assert_array_equal(g, r, err_msg=k)


def test_volume_profile_one_series_and_flat_prices():
    w = _windows(shape=(1,), T=64)
    one = volume_profile(*(torch.from_numpy(w[k][0]) for k in ("high", "low", "close", "volume")))
    assert one["poc_price"].shape == () and one["histogram"].shape == (50,)
    flat = torch.full((64,), 100.0)
    vp = volume_profile(flat, flat, flat, torch.ones(64))
    ref = jvolume_profile(*(jnp.asarray(flat.numpy()),) * 3, jnp.ones(64))
    for k in ("poc_price", "value_area_low", "value_area_high", "total_volume"):
        np.testing.assert_array_equal(vp[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_combinations_match_jax_on_one_indicator_table():
    """Both packages' combinations on JAX's own indicator table: the 15
    families and the confluence agree at rtol 1e-5, atol 1e-6 (the fast RSI
    and the rolling statistics inside are each package's own)."""
    w = _windows()
    jind = jax.jit(jops.compute_indicators)({k: jnp.asarray(v) for k, v in w.items()})
    tind = {k: torch.from_numpy(np.array(v)) for k, v in jind.items()}
    ref, got = jcomb.combined_indicators(jind), combined_indicators(tind)
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(combination_signal(got).numpy(),
                               np.asarray(jcomb.combination_signal(ref)),
                               rtol=1e-5, atol=1e-6)
    weights = {"oscillator_consensus": 2.0, "trend_confirmation": 0.5}
    np.testing.assert_allclose(combination_signal(got, weights).numpy(),
                               np.asarray(jcomb.combination_signal(ref, weights)),
                               rtol=1e-5, atol=1e-6)


def test_drift_spec_equals_jax():
    assert (drift.N_BINS, drift.PSI_EPS, drift.PSI_ALERT_THRESHOLD, drift.DRIFT_FEATURES) \
        == (jdrift.N_BINS, jdrift.PSI_EPS, jdrift.PSI_ALERT_THRESHOLD, jdrift.DRIFT_FEATURES)
    assert drift.feature_names() == jdrift.feature_names()
    rng = np.random.default_rng(3)
    series = {"rsi": rng.uniform(-10, 110, 500), "stoch_k": rng.uniform(0, 100, 500),
              "macd_norm": np.r_[rng.normal(0, 0.01, 400), [np.nan] * 100],
              "volatility": np.full(10, np.inf)}
    ref = jdrift.reference_histogram(series)
    np.testing.assert_array_equal(drift.reference_histogram(series), ref)
    live = drift.reference_histogram({"rsi": rng.uniform(20, 80, 300)})
    np.testing.assert_array_equal(drift.psi(live, ref), jdrift.psi(live, ref))


def test_ingest_additions_equal_jax(tmp_path):
    d = generate_ohlcv(n=40, seed=2)
    klines = [[60_000 * i, float(d["open"][i]), float(d["high"][i]), float(d["low"][i]),
               float(d["close"][i]), float(d["volume"][i]), 0, 0.0, 0, 0.0, 0.0, 0]
              for i in range(40)]
    got = tdata.klines_to_arrays(klines, symbol="BTCUSDC", interval="5m")
    ref = jingest.klines_to_arrays(klines, symbol="BTCUSDC", interval="5m")
    for f in ("timestamp", "open", "high", "low", "close", "volume", "symbol", "interval"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    # CSVs either way round
    mine = tdata.save_csv(got, str(tmp_path / "port"))
    theirs = jingest.save_csv(ref, str(tmp_path / "jax"))
    assert open(mine).read() == open(theirs).read()
    back = tdata.load_csv(theirs, symbol="BTCUSDC", interval="5m")
    np.testing.assert_array_equal(back.close, ref.close)
    cols = {"galaxy_score": np.linspace(1, 9, 6, dtype=np.float32),
            "volume": np.arange(6, dtype=np.float32)}
    ts = np.arange(6, dtype=np.int64) * 86_400
    mine = tdata.save_social_csv(tdata.SocialDaily(ts, cols), "BTC", str(tmp_path / "port"))
    theirs = jingest.save_social_csv(JSocialDaily(ts, cols), "BTC", str(tmp_path / "jax"))
    assert open(mine).read() == open(theirs).read()
    a, b = tdata.load_social_csv(theirs), jingest.load_social_csv(mine)
    np.testing.assert_array_equal(a.timestamp, b.timestamp)
    assert a.columns.keys() == b.columns.keys() and len(a) == len(b) == 6
    for k in a.columns:
        np.testing.assert_array_equal(a.columns[k], b.columns[k], err_msg=k)
    empty = tmp_path / "empty.csv"
    empty.write_text("timestamp\n")
    assert len(tdata.load_social_csv(str(empty))) == 0


# --- the engine against the JAX engine -------------------------------------

@pytest.fixture(scope="module")
def tape():
    """Both engines over one tape: a seed step, then TICKS incremental
    steps of one candle each; a training-time drift reference installed on
    one lane before the second step."""
    ex = _exchange()
    jeng = JTickEngine(SYMBOLS, FRAMES, window=LIMIT)
    teng = TickEngine(SYMBOLS, FRAMES, window=LIMIT, device="cpu")
    ref_hist = jdrift.reference_histogram(
        {"rsi": np.linspace(20, 80, 200), "volatility": np.full(50, 0.004)})
    steps = []
    # none of the observatories either step feeds is active (another test
    # may have left one installed): last_stats then holds the keys both
    # steps set without them; each scope is put back afterwards
    with tickpath.use(None), devprof.use(None), meshprof.use(None), \
            ttickpath.use(None):
        for tick in range(TICKS + 1):
            if tick:
                ex.advance(steps=1)
            if tick == 1:
                for eng in (jeng, teng):
                    eng.set_drift_reference("ETHUSDC", "5m", ref_hist)
            _feed([jeng, teng], ex)
            j, t = jeng.step(), teng.step()
            steps.append({"jax": (j, dict(jeng.last_drift), dict(jeng.last_stats)),
                          "port": (t, dict(teng.last_drift), dict(teng.last_stats))})
    return steps


def _tolerance(key, ref):
    """(rtol, atol) of a field of the tick table against JAX (``ref``: the
    JAX table)."""
    close = np.asarray(ref["current_price"])
    if key == "signal_strength":
        # min(|macd|, 1)·20 is one term: 20 times the MACD bound below where
        # |macd| < 1 (tests/test_torch_slice.py holds the strength so)
        macd = np.abs(np.asarray(ref["macd"]))
        return 1e-5, 1e-4 + np.where(macd < 1.0, 20 * (1e-3 + 2e-6 * np.abs(close)), 0.0)
    if key == "macd":
        # tests/test_torch_indicators.py's MACD bound: 1e-3 + 2e-6·|close|
        return 2e-5, 1e-3 + 2e-6 * np.abs(close)
    if key in ("confluence", "combo.trend_confirmation", "combo.trend_strength_index",
               "combo.market_regime_indicator"):
        # each carries 0.5·tanh((macd - macd_signal)/close·1e3), which moves
        # by at most 0.5·1e3·(2·2e-6·close)/close = 2e-3 under that bound
        return 1e-5, 2e-3
    if key == "trend_strength":
        # 50·|(close - sma20)/sma20 + (close - sma50)/sma50|: the SMAs'
        # rounding (a few ulps, ≤ 5e-7 of the price) times 100
        return 1e-5, 5e-5
    return 1e-5, 1e-6


def test_engine_follows_jax_field_for_field(tape):
    for tick, step in enumerate(tape):
        (j, jd, _), (t, td, _) = step["jax"], step["port"]
        fj, ft = _flat(j), _flat(t)
        assert fj.keys() == ft.keys(), tick
        for k, r in fj.items():
            r, g = np.asarray(r), ft[k]
            assert g.dtype == r.dtype and g.shape == r.shape, (tick, k)
            if k in ("signal", "trend"):
                continue
            rtol, atol = _tolerance(k, fj)
            bad = ~(np.abs(g.astype(np.float64) - r) <= atol + rtol * np.abs(r)) \
                & ~(np.isnan(g) & np.isnan(r))
            assert not bad.any(), (tick, k, g[bad], r[bad])
        # signal and trend exactly: a difference is reported with its votes
        for k in ("signal", "trend"):
            diff = np.argwhere(ft[k] != np.asarray(fj[k]))
            votes = {tuple(ix): {c: (float(ft[c][tuple(ix)]), float(np.asarray(fj[c])[tuple(ix)]))
                                 for c in ("rsi", "stoch_k", "macd", "williams_r",
                                           "bb_position", "trend_strength")}
                     for ix in diff[:5]}
            assert diff.size == 0, (tick, k, votes)
        # last_drift: reference state exact; a histogram bin count may move
        # only by whole candles (1/T) where a series sits on a bin edge (at
        # most one histogram in 20); PSI at the default tolerance wherever
        # the live histogram and the reference are the same
        np.testing.assert_array_equal(td["ref_set"], jd["ref_set"])
        jh = np.asarray(jd["hist"])
        np.testing.assert_allclose(td["hist"], jh, rtol=0, atol=1.0 / LIMIT)
        moved = (td["hist"] != jh).any(-1)
        assert moved.sum() <= moved.size // 20, (tick, np.argwhere(moved))
        np.testing.assert_allclose(td["psi"][~moved], np.asarray(jd["psi"])[~moved],
                                   rtol=1e-5, atol=1e-6, err_msg=f"tick {tick} psi")
    # the tape exercised what it should: warm and warming lanes, a
    # reference that is not this window's, real signals
    last = tape[-1]["port"][0]
    valid = ~np.isnan(last["current_price"])
    assert valid.sum() == len(SYMBOLS) * 2 and not valid[:, 2].any()
    assert tape[-1]["port"][1]["ref_set"][1, 1]
    assert (last["signal"][valid] != 0).any()


def test_engine_stats_follow_jax(tape):
    counters = ("dispatches", "upload_rows", "full_seed", "lanes", "valid_lanes",
                "scatter_capacity")
    for step in tape:
        js, ts = step["jax"][2], step["port"][2]
        assert set(ts) == set(js)
        assert {k: ts[k] for k in counters} == {k: js[k] for k in counters}
    assert [s["port"][2]["full_seed"] for s in tape] == [True] + [False] * TICKS
    assert all(s["port"][2]["upload_rows"] > 0 for s in tape[1:])


def test_ring_delta_matches_fresh_seed_bit_for_bit():
    ex = _exchange()
    eng = TickEngine(SYMBOLS, FRAMES, window=LIMIT, device="cpu")
    for _ in range(5):
        _feed([eng], ex)
        eng.step()
        ex.advance(steps=1)
    fresh = TickEngine(SYMBOLS, FRAMES, window=LIMIT, device="cpu")
    _feed([eng, fresh], ex)
    out_inc, out_fresh = eng.step(), fresh.step()
    assert not eng.last_stats["full_seed"] and fresh.last_stats["full_seed"]
    # the same window contents through the same program: the same bits
    _assert_tree_equal(out_inc, out_fresh, "ring delta")


def test_gap_triggers_reseed_not_garbage():
    ex = _exchange(("BTCUSDC",))
    eng = TickEngine(["BTCUSDC"], ("1m",), window=LIMIT, max_new=4, device="cpu")
    eng.ingest("BTCUSDC", "1m", ex.get_klines("BTCUSDC", "1m", LIMIT))
    eng.step()
    seeds_before = eng.full_seeds
    ex.advance(steps=50)                    # >> max_new candles
    eng.ingest("BTCUSDC", "1m", ex.get_klines("BTCUSDC", "1m", LIMIT))
    out = eng.step()
    assert eng.full_seeds == seeds_before + 1 and eng.last_stats["full_seed"]
    c = ex.get_klines("BTCUSDC", "1m", 1)[-1][4]
    assert float(out["current_price"][0, 0]) == pytest.approx(c)


def test_ingest_row_streams_into_the_ring():
    """Streamed rows (the in-progress bar and the next candle) give the
    same table as a full-window ingest of the same klines; a gap refuses."""
    ex = _exchange(("BTCUSDC",))
    streamed = TickEngine(["BTCUSDC"], ("1m",), window=LIMIT, device="cpu")
    full = TickEngine(["BTCUSDC"], ("1m",), window=LIMIT, device="cpu")
    _feed([streamed, full], ex, ["BTCUSDC"], ("1m",))
    streamed.step(), full.step()
    assert streamed.lane_synced("BTCUSDC", "1m")
    ex.advance(steps=1)
    kl = ex.get_klines("BTCUSDC", "1m", LIMIT)
    assert streamed.ingest_row("BTCUSDC", "1m", kl[-1])
    full.ingest("BTCUSDC", "1m", kl)
    _assert_tree_equal(streamed.step(), full.step(), "ingest_row")
    assert not streamed.ingest_row("BTCUSDC", "1m", [kl[-1][0] + 5 * 60_000] + kl[-1][1:])
    assert not streamed.lane_synced("BTCUSDC", "1m")
    assert not streamed.ingest_row("NOPE", "1m", kl[-1])


def test_pipelined_matches_serial_shifted_one_tick():
    ex_s, ex_p = _exchange(), _exchange()
    serial = TickEngine(SYMBOLS, FRAMES, window=LIMIT, device="cpu")
    pipe = TickEngine(SYMBOLS, FRAMES, window=LIMIT, pipelined=True, device="cpu")
    serial_outs, pipe_outs = [], []
    for i in range(5):
        _feed([serial], ex_s)
        _feed([pipe], ex_p)
        serial_outs.append(serial.step())
        got = pipe.step()
        if i == 0:
            assert got is None and pipe.last_stats["inflight"]
        else:
            pipe_outs.append(got)
            # the drained stats describe the dispatch just collected
            assert pipe.last_stats["full_seed"] == (i == 1)
            assert pipe.last_stats["overlap_reclaimed_s"] >= 0.0
        ex_s.advance(steps=1)
        ex_p.advance(steps=1)
    pipe_outs.append(pipe.flush())
    assert pipe.flush() is None
    for i, (a, b) in enumerate(zip(pipe_outs, serial_outs)):
        _assert_tree_equal(a, b, f"tick{i}")
    assert serial.dispatch_count == pipe.dispatch_count == 5
    assert pipe.last_stats["scatter_capacity"] == 2 * serial.last_stats["scatter_capacity"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_one_host_read_per_step(monkeypatch, pipelined):
    ex = _exchange(SYMBOLS[:2])
    eng = TickEngine(SYMBOLS[:2], ("1m",), window=LIMIT, pipelined=pipelined, device="cpu")
    reads = {"n": 0}
    real = tick_engine.host_read

    def counting(readback):
        reads["n"] += 1
        return real(readback)

    monkeypatch.setattr(tick_engine, "host_read", counting)
    for tick in range(4):
        if tick:
            ex.advance(steps=1)
        _feed([eng], ex, SYMBOLS[:2], ("1m",))
        out = eng.step()
        # serial: one read per step; pipelined: the first step only fills
        assert reads["n"] == (tick + 1 if not pipelined else tick)
        assert (out is None) == (pipelined and tick == 0)
    if pipelined:
        eng.flush()
        assert reads["n"] == 4


def test_failed_drain_reseeds_not_wedges(monkeypatch):
    symbols, ivs = ["BTCUSDC"], ("1m",)
    ex_p, ex_s = _exchange(symbols), _exchange(symbols)
    eng = TickEngine(symbols, ivs, window=LIMIT, pipelined=True, device="cpu")
    oracle = TickEngine(symbols, ivs, window=LIMIT, device="cpu")
    _feed([eng], ex_p, symbols, ivs)
    _feed([oracle], ex_s, symbols, ivs)
    assert eng.step() is None
    oracle.step()
    real = tick_engine.host_read

    def dying(readback):
        raise RuntimeError("device wedged mid-readback")

    monkeypatch.setattr(tick_engine, "host_read", dying)
    for ex in (ex_p, ex_s):
        ex.advance(steps=1)
    _feed([eng], ex_p, symbols, ivs)
    _feed([oracle], ex_s, symbols, ivs)
    with pytest.raises(RuntimeError, match="wedged"):
        eng.step()                             # the drain of tick 1 dies
    # nothing in flight, both rings dropped, the next step re-seeds
    assert eng._inflight is None and eng._bufs == [None, None] and eng._need_seed
    assert eng._buf_pending == [{}, {}]
    monkeypatch.setattr(tick_engine, "host_read", real)
    oracle.step()
    assert eng.step() is None                  # re-seed + re-fill
    assert eng.last_stats["full_seed"]
    for ex in (ex_p, ex_s):
        ex.advance(steps=1)
    _feed([eng], ex_p, symbols, ivs)
    _feed([oracle], ex_s, symbols, ivs)
    serial_out = oracle.step()
    assert eng.step() is not None              # drains the re-seeded tick
    _assert_tree_equal(eng.flush(), serial_out, "post-recovery")


def test_precision_vocabulary_is_jax_and_unknown_raises():
    assert PRECISIONS == JAX_PRECISIONS
    with pytest.raises(ValueError):
        TickEngine(["BTCUSDC"], ["1m"], window=LIMIT, precision="fp8", device="cpu")
    # the tick program has no matrix product: the knob changes no value
    ex = _exchange(("BTCUSDC",))
    outs = []
    for precision in (None, "bf16"):
        eng = TickEngine(["BTCUSDC"], ("1m",), window=LIMIT, precision=precision,
                         device="cpu")
        _feed([eng], ex, ["BTCUSDC"], ("1m",))
        outs.append(eng.step())
    _assert_tree_equal(*outs, "precision")


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TickEngine(SYMBOLS, FRAMES, window=LIMIT)
