"""The port's tenant engine and fleet observatory against the JAX package,
on the CPU.

    feature dict → TenantEngine.decide: analyzer verdict, the executor's
    gates in VETO_ORDER, sizing on the (open count, balance) carry, lane
    containment, fleet aggregates, one host read

Both engines get the same seeded feature dicts and the same sequence of
calls.  The decide is elementwise float32 arithmetic, comparisons and
selects, and the port rounds the one fused multiply-add XLA forms in it
(the balance carry) once as XLA does, so gates, exec and every float of
the output, the state and the fleet aggregates must agree bit for bit.
The JAX engine runs with its observatories off (`tickpath`, `devprof`,
`meshprof`): another test file in the same worker may leave one
installed.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.config import TradingParams as JTradingParams  # noqa: E402
from ai_crypto_trader_tpu.obs import fleetscope as jfleetscope  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath  # noqa: E402
from ai_crypto_trader_tpu.ops import tenant_engine as jte  # noqa: E402
from ai_crypto_trader_tpu.ops.tick_engine import TickEngine as JTickEngine  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu.utils import journal as jjournal  # noqa: E402
from ai_crypto_trader_tpu_torch.config import TradingParams  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import fleetscope  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import tenant_engine  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.tenant_engine import (  # noqa: E402
    EXECUTABLE, GATE_ID, GATE_NAME, NO_DECISION, TenantEngine)
from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner, make_mesh  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import journal  # noqa: E402

SYMS = [f"P{i:03d}USDC" for i in range(4)]
PERMISSIVE = dict(ai_confidence_threshold=0.0, min_signal_strength=0.0,
                  min_trade_amount=1.0)
PARAM_GRID = [{}, dict(ai_confidence_threshold=0.5, min_signal_strength=50.0,
                       max_positions=2),
              dict(ai_confidence_threshold=0.3, min_signal_strength=20.0,
                   min_trade_amount=400.0)]


@pytest.fixture(autouse=True)
def _observatories_off():
    with tickpath.use(None), devprof.use(None), meshprof.use(None), \
            jfleetscope.use(None), fleetscope.use(None):
        yield


def _pair(symbols, n, trading=None, **kw):
    """A JAX engine and the port's, built alike."""
    trading = trading or {}
    return (jte.TenantEngine(symbols, n, trading=JTradingParams(**trading), **kw),
            TenantEngine(symbols, n, trading=TradingParams(**trading), device="cpu", **kw))


def _both(engines, fn):
    return [fn(e) for e in engines]


def _feats(S, price, signal, strength, vol, avol, valid=None):
    n = len(price)
    pad = lambda a, dt: np.asarray(list(a) + [0] * (S - n), dt)  # noqa: E731
    return {"price": pad(price, np.float32), "signal": pad(signal, np.int32),
            "strength": pad(strength, np.float32), "volatility": pad(vol, np.float32),
            "avg_volume": pad(avol, np.float32),
            "valid": pad(valid if valid is not None else [True] * n, bool)}


def _feat_stream(S, seed=5, ticks=6, n=len(SYMS)):
    """Prices drift so positions open and close across the run."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(50.0, 200.0, n)
    out = []
    for t in range(ticks):
        price = base * (1.0 + 0.02 * np.sin(0.7 * t + np.arange(n)))
        out.append(_feats(S, list(price), list(rng.integers(-1, 2, n)),
                          list(rng.uniform(40.0, 110.0, n)), [0.015] * n, [60_000.0] * n))
    return out


def _same(a, b, what=""):
    """Two host trees equal bit for bit, dtype and shape included."""
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}/{k}")


def _assert_engines_agree(jeng, teng, jout, tout, what=""):
    _same(tout, jout, f"{what} out")
    _same(teng._state_np, jeng._state_np, f"{what} state")
    _same(teng._params_np, jeng._params_np, f"{what} params")
    for k in ("dispatch_count", "full_seeds", "balance_resyncs", "quarantine_trips",
              "heals_total", "n_pad", "S"):
        assert getattr(teng, k) == getattr(jeng, k), (what, k)
    assert teng.veto_counts() == jeng.veto_counts()
    assert teng.executable() == jeng.executable()
    assert teng.quarantined_lanes() == jeng.quarantined_lanes()
    assert teng.heal_ready() == jeng.heal_ready()
    np.testing.assert_array_equal(teng.rolling_pnl(), jeng.rolling_pnl())
    np.testing.assert_array_equal(teng.balances(), jeng.balances())
    np.testing.assert_array_equal(teng.max_drawdowns(), jeng.max_drawdowns())
    assert set(teng.last_stats) == set(jeng.last_stats)


# --- vocabulary and layout --------------------------------------------------

def test_constants_and_params_equal_jax():
    assert (EXECUTABLE, NO_DECISION) == (jte.EXECUTABLE, jte.NO_DECISION)
    assert GATE_ID == jte.GATE_ID and GATE_NAME == jte.GATE_NAME
    assert tenant_engine.FEATURE_KEYS == jte.FEATURE_KEYS
    assert tenant_engine.DEFAULT_QUARANTINE_COOLDOWN == jte.DEFAULT_QUARANTINE_COOLDOWN
    _same(tenant_engine.tenant_params(5, TradingParams(max_positions=3), fee_rate=0.002),
          jte.tenant_params(5, JTradingParams(max_positions=3), fee_rate=0.002))
    jeng, teng = _pair([f"Q{i}USDC" for i in range(6)], 11)
    assert (teng.S, teng.n_pad) == (jeng.S, jeng.n_pad) == (8, 16)
    with pytest.raises(TypeError, match="not a partitioner"):
        TenantEngine(SYMS, 2, partitioner=object(), device="cpu")
    mesh = MeshPartitioner(make_mesh(2, devices=["cpu"] * 2))
    assert TenantEngine(SYMS, 2, partitioner=mesh, device="cpu").partitioner is mesh
    with pytest.raises(ValueError, match="precision"):
        TenantEngine(SYMS, 2, precision="fp8", device="cpu")
    assert TenantEngine(SYMS, 2, precision="bf16", device="cpu").precision == "bf16"


def test_feats_from_updates_equal_jax():
    jeng, teng = _pair(SYMS, 2)
    updates = {SYMS[1]: {"current_price": 12.5, "signal": "BUY", "signal_strength": 80.0,
                         "volatility": 0.012, "avg_volume": 7e4},
               SYMS[3]: {"current_price": 3.0, "signal": "SELL"}, "NOPEUSDC": {}}
    _same(teng.feats_from_updates(updates), jeng.feats_from_updates(updates))


# --- the randomized gate sweep ------------------------------------------------

def _random_features(rng):
    """One symbol's feature row, poisoned ~20 % of the time (the JAX
    package's gate-parity sweep, tests/test_tenant_engine.py)."""
    price = float(rng.choice([rng.uniform(10.0, 500.0), rng.uniform(10.0, 500.0),
                              rng.uniform(10.0, 500.0), rng.uniform(10.0, 500.0),
                              0.0, -5.0, np.nan]))
    strength = float(rng.choice([rng.uniform(0.0, 120.0), rng.uniform(0.0, 120.0),
                                 rng.uniform(0.0, 120.0), np.nan]))
    vol = float(rng.choice([rng.uniform(0.0, 0.05), rng.uniform(0.0, 0.05), np.nan]))
    avol = float(rng.choice([rng.uniform(0.0, 120_000.0), rng.uniform(0.0, 120_000.0),
                             np.nan]))
    sig = int(rng.choice([1, 1, -1, 0]))
    return price, sig, strength, vol, avol


def test_randomized_sweep_gate_for_gate():
    rng = np.random.default_rng(20260805)
    seen = set()
    for r in range(6):
        rows = [_random_features(rng) for _ in SYMS]
        jeng, teng = _pair(SYMS, 8)
        feats = _feats(teng.S, *zip(*rows))
        for i in range(8):
            trading = PARAM_GRID[int(rng.integers(len(PARAM_GRID)))]
            t = JTradingParams(**trading)
            balance = float(rng.uniform(50.0, 20_000.0))
            open_syms = [s for s in SYMS if rng.random() < 0.25]
            pending = [s for s in SYMS if s not in open_syms and rng.random() < 0.15]
            for e in (jeng, teng):
                e.set_tenant(i, balance=balance, open_symbols=open_syms,
                             pending_symbols=pending,
                             conf_threshold=t.ai_confidence_threshold,
                             min_strength=t.min_signal_strength,
                             max_positions=t.max_positions, min_trade=t.min_trade_amount)
        jout, tout = jeng.decide(feats), teng.decide(feats)
        _assert_engines_agree(jeng, teng, jout, tout, f"round {r}")
        seen |= set(np.unique(tout["gate"]).tolist())
    # the sweep reached most of the vocabulary, executable decisions included
    assert {EXECUTABLE, NO_DECISION, GATE_ID["nan_gate"]} <= seen
    assert len(seen - {EXECUTABLE, NO_DECISION}) >= 5, seen


def test_sequential_semantics_max_positions_and_balance():
    """Symbol k's entry is visible to symbol k + 1 in the same decide."""
    jeng, teng = _pair(SYMS, 1, dict(ai_confidence_threshold=0.5,
                                     min_signal_strength=50.0, max_positions=2))
    feats = _feats(teng.S, [100.0] * 4, [1] * 4, [90.0] * 4, [0.015] * 4, [60_000.0] * 4)
    jout, tout = jeng.decide(feats), teng.decide(feats)
    _assert_engines_agree(jeng, teng, jout, tout)
    gates = [int(g) for g in tout["gate"][0][:4]]
    assert gates[:2] == [EXECUTABLE, EXECUTABLE]
    assert [GATE_NAME[g] for g in gates[2:]] == ["max_positions", "max_positions"]
    spent = float(tout["size"][0, 0] + tout["size"][0, 1]) * 1.001
    assert teng.balances()[0] == pytest.approx(10_000.0 - spent, rel=1e-5)


# --- venue-truth corrections, overrides, cooldown -------------------------------

def test_venue_syncs_overrides_and_cooldown_follow_jax():
    """One scripted run through every host-side correction, both engines
    compared after every decide."""
    jeng, teng = _pair(SYMS, 6, PERMISSIVE, quarantine_cooldown=2)
    stream = _feat_stream(teng.S, ticks=9)
    script = {
        1: lambda e: e.revert_entry(0, SYMS[0]),
        2: lambda e: (e.sync_positions(1, [SYMS[2]]), e.sync_balance(1, 12_345.5),
                      e.sync_balance(2, float(e._state_np["balance"][2]) * (1 + 1e-7)),
                      e.sync_balance(3, 9_000.0, expected=True)),
        3: lambda e: e.set_live_overrides(stop_loss=1.5, take_profit=3.0),
        4: lambda e: e.set_live_overrides(stop_loss=1.5, take_profit=3.0),   # a no-op
        5: lambda e: (e.set_live_overrides(None, None),
                      e._state_np["balance"].__setitem__(4, np.nan),
                      e.__setattr__("_need_seed", True)),
        8: lambda e: e.heal_lane(4, balance=7_777.0, positions={SYMS[1]: (120.0, 2.0)}),
    }
    for k, feats in enumerate(stream):
        if k in script:
            _both((jeng, teng), script[k])
            assert teng._need_seed == jeng._need_seed, k
            assert teng._drift_pending == jeng._drift_pending, k
        jout, tout = jeng.decide(feats), teng.decide(feats)
        _assert_engines_agree(jeng, teng, jout, tout, f"decide {k}")
        assert teng.last_stats["full_seed"] == jeng.last_stats["full_seed"]
        if k == 3:
            ok = tout["exec"]
            assert ok.any() and (tout["sl_pct"] == np.float32(1.5)).all()
        if k == 5:
            assert teng.quarantined_lanes() == [{"lane": 4, "gate": "lane_quarantined",
                                                "cooldown": 2}]
        if k in (6, 7):
            # the poison persists: re-detected, but the edge counted once
            assert teng.quarantine_trips == 1
    assert teng.balance_resyncs == 2 and teng.heals_total == 1
    assert teng.quarantined_lanes() == []


# --- containment ------------------------------------------------------------------

def test_poisoned_lanes_are_contained_and_neighbours_bit_identical():
    """State and param poison on two lanes: they resolve to
    lane_quarantined; every other lane's outputs and state are the bits of
    a run without the poison; the JAX engine agrees throughout."""
    (jeng, teng), (_, twin) = _pair(SYMS, 12, PERMISSIVE), _pair(SYMS, 12, PERMISSIVE)
    stream = _feat_stream(teng.S, ticks=4)
    for e in (jeng, teng, twin):
        e.decide(stream[0])
    bad = [2, 11]
    for e in (jeng, teng):
        e._state_np["balance"][bad[0]] = np.nan
        e._params_np["min_strength"][bad[1]] = np.inf
        e._need_seed = True
    twin._need_seed = True            # the same re-seed, without the poison
    healthy = [i for i in range(12) if i not in bad]
    q = GATE_ID["lane_quarantined"]
    for feats in stream[1:]:
        jout, tout, wout = jeng.decide(feats), teng.decide(feats), twin.decide(feats)
        _assert_engines_agree(jeng, teng, jout, tout)
        for i in bad:
            decided = tout["gate"][i] != NO_DECISION
            assert decided.any() and (tout["gate"][i][decided] == q).all()
        assert not any(n in bad for n, _ in teng.executable())
        for k in tout:
            np.testing.assert_array_equal(tout[k][healthy], wout[k][healthy], err_msg=k)
        for k, v in teng._state_np.items():
            np.testing.assert_array_equal(v[healthy], twin._state_np[k][healthy], err_msg=k)
    assert sorted(v["lane"] for v in teng.quarantined_lanes()) == bad
    assert teng.quarantine_trips == 2


def test_containment_off_compiles_the_detector_out():
    jeng, teng = _pair(SYMS, 4, PERMISSIVE, containment=False)
    feats = _feat_stream(teng.S)[0]
    _both((jeng, teng), lambda e: e.decide(feats))
    for e in (jeng, teng):
        e._state_np["balance"][1] = np.nan
        e._need_seed = True
    jout, tout = jeng.decide(feats), teng.decide(feats)
    _assert_engines_agree(jeng, teng, jout, tout)
    assert (tout["gate"][1] != GATE_ID["lane_quarantined"]).all()
    assert teng.quarantined_lanes() == []


# --- the fleet observatory ---------------------------------------------------------

def _fleet_case(n, seed, n_active, quarantined=()):
    rng = np.random.default_rng(seed)
    gate = rng.integers(-2, len(GATE_ID) + 4, (n, 6)).astype(np.int8)
    pnl = rng.choice([-50.0, 0.0, 12.5, 30.0], n).astype(np.float32)   # ties
    noisy = rng.random(n) < 0.3
    pnl[noisy] = rng.normal(0.0, 100.0, int(noisy.sum()))
    bal = rng.uniform(100.0, 20_000.0, n).astype(np.float32)
    dd = rng.uniform(0.0, 500.0, n).astype(np.float32)
    active = np.zeros(n, bool)
    active[:n_active] = True
    q = np.zeros(n, bool)
    q[list(quarantined)] = True
    pnl[q] = np.nan
    return dict(gate=gate, pnl=pnl, balance=bal, max_drawdown=dd, active=active,
                quarantined=q)


@pytest.mark.parametrize("n,n_active,quarantined,k", [
    (16, 16, (), 8), (16, 11, (3, 7), 8), (8, 3, (1,), 8), (32, 20, (0,), 5), (4, 0, (), 8)])
def test_device_aggregates_follow_jax_ties_and_inf_tails(n, n_active, quarantined, k):
    """The torch reduction against the JAX one (top-k ties in index order,
    ±inf tail ranks beyond the healthy count) and both NumPy twins."""
    import torch

    case = _fleet_case(n, n + n_active, n_active, quarantined)
    got = fleetscope.device_aggregates(**{a: torch.from_numpy(v) for a, v in case.items()},
                                       k=k)
    ref = jfleetscope.device_aggregates(**{a: jnp.asarray(v) for a, v in case.items()}, k=k)
    got = {a: v.numpy() for a, v in got.items()}
    _same(got, {a: np.asarray(v) for a, v in ref.items()}, "device")
    for host in (fleetscope.host_aggregates(**case, k=k),
                 jfleetscope.host_aggregates(**case, k=k)):
        for a, v in host.items():
            np.testing.assert_array_equal(np.asarray(got[a], np.float64),
                                          np.asarray(v, np.float64), err_msg=a)
    if 0 < n_active - len(quarantined) < k:
        assert got["best_pnl"][-1] == -np.inf and got["worst_pnl"][-1] == np.inf


def test_fleet_aggregates_ride_the_decide_and_match_host_recompute():
    jeng, teng = _pair(SYMS[:3], 10, PERMISSIVE)
    stream = _feat_stream(teng.S, ticks=3, n=3)
    fj, ft = jfleetscope.FleetScope(top_k=4), fleetscope.FleetScope(top_k=4)
    with jfleetscope.use(fj), fleetscope.use(ft):
        for e in (jeng, teng):
            e.set_tenant(9, active=False)
            e.set_tenant(1, balance=500.0)
            e._state_np["qty"][5, 0] = np.nan
            e._need_seed = True
        for feats in stream:
            jout, tout = jeng.decide(feats), teng.decide(feats)
            _assert_engines_agree(jeng, teng, jout, tout)
            _same(teng.last_fleet, {a: np.asarray(v) for a, v in jeng.last_fleet.items()},
                  "fleet")
            st = teng._state_np
            host = fleetscope.host_aggregates(
                gate=np.pad(tout["gate"][:, :3], ((0, teng.n_pad - 10), (0, 0)),
                            constant_values=NO_DECISION),
                pnl=np.pad(teng.rolling_pnl(), (0, teng.n_pad - 10)),
                balance=st["balance"], max_drawdown=st["max_drawdown"],
                active=teng._params_np["active"], quarantined=st["quarantined"], k=4)
            for a, v in host.items():
                np.testing.assert_array_equal(np.asarray(teng.last_fleet[a], np.float64),
                                              np.asarray(v, np.float64), err_msg=a)
    assert ft.status()["gate_mix"] == fj.status()["gate_mix"]
    assert ft.last == fj.last and ft.alert_state() == fj.alert_state()
    assert fleetscope.bin_names() == jfleetscope.bin_names()
    assert [fleetscope.lane_sampled(i) for i in range(200)] == \
        [jfleetscope.lane_sampled(i) for i in range(200)]


# --- snapshots across packages ---------------------------------------------------------

def test_snapshot_written_by_either_package_restores_in_the_other():
    jeng, teng = _pair(SYMS, 6, PERMISSIVE)
    stream = _feat_stream(teng.S, ticks=3)
    for e in (jeng, teng):
        e.decide(stream[0])
        e.sync_balance(2, 4_321.0)
    for src, dst_cls in ((teng, jte.TenantEngine), (jeng, TenantEngine)):
        payload = json.loads(json.dumps(src.snapshot()))
        kw = {"device": "cpu"} if dst_cls is TenantEngine else {}
        dst = dst_cls(SYMS, 3, trading=src.trading, **kw)
        stats = dst.restore(payload)
        assert stats["lanes"] == 6 and dst.balance_resyncs == 1
        _same(dst._state_np, src._state_np, "restored state")
        _same(dst._params_np, src._params_np, "restored params")
    # the restored port engine decides as the JAX engine that wrote it
    restored = TenantEngine(SYMS, 6, device="cpu")
    restored.restore(json.loads(json.dumps(jeng.snapshot())))
    _same(restored.decide(stream[1]), jeng.decide(stream[1]), "after restore")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(jjournal.unpack_array(journal.pack_array(a)), a)
    assert journal.pack_array(a) == jjournal.pack_array(a)
    rec = journal.pack_array(a)
    rec["data"] = rec["data"][:-4] + "AAAA"
    with pytest.raises(ValueError, match="crc"):
        journal.unpack_array(rec)
    with pytest.raises(ValueError, match="universe"):
        TenantEngine(SYMS[:2], 2, device="cpu").restore(teng.snapshot())


# --- one host read a decide --------------------------------------------------------------

def test_one_host_read_per_decide(monkeypatch):
    reads = []
    real = tenant_engine.host_read

    def counting(readback):
        reads.append(1)
        return real(readback)

    monkeypatch.setattr(tenant_engine, "host_read", counting)
    eng = TenantEngine(SYMS, 5, trading=TradingParams(**PERMISSIVE), device="cpu")
    stream = _feat_stream(eng.S, ticks=4)
    with fleetscope.use(fleetscope.FleetScope()):
        for k, feats in enumerate(stream):
            if k == 2:
                eng.sync_balance(0, 1_000.0)
            eng.decide(feats)
            assert len(reads) == k + 1 and eng.dispatch_count == k + 1
    assert eng.last_fleet is not None
    assert [eng.last_stats["full_seed"]] == [False]
    assert eng.full_seeds == 2


# --- the chained path: tick engine → decide ------------------------------------------------

def _tick_tape():
    from ai_crypto_trader_tpu.data.ingest import OHLCV
    from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv
    from ai_crypto_trader_tpu.shell.exchange import FakeExchange

    symbols = SYMS[:3]
    series = {}
    for i, s in enumerate(symbols):
        d = generate_ohlcv(n=600, seed=21 + i)
        series[s] = OHLCV(timestamp=np.arange(600, dtype=np.int64) * 60_000,
                          open=d["open"], high=d["high"], low=d["low"], close=d["close"],
                          volume=d["volume"] * 1000, symbol=s)
    ex = FakeExchange(series)
    ex.advance(steps=400)
    return symbols, ex


def _near_threshold(feats, params, bound_strength):
    """Cells whose gate a last-ulps difference of the tick table may decide:
    the strength within its tick-test bound of the strength floor or of the
    strength at which the rounded confidence crosses its threshold, the
    volatility within 1e-5 of a sizer-ladder step."""
    s = feats["strength"][None, :]
    near_s = np.abs(s - params["min_strength"][:, None]) <= bound_strength
    conf_edge = (params["conf_threshold"][:, None] - 0.0005) / (0.009)
    near_c = np.abs(s - conf_edge) <= bound_strength + 1e-3
    v = feats["volatility"][None, :]
    near_v = (np.abs(v - 0.01) <= 1e-5 * 0.01 + 1e-6) | (np.abs(v - 0.02) <= 1e-5 * 0.02 + 1e-6)
    return near_s | near_c | near_v


def test_chained_tick_engine_feeds_the_decide():
    """The port's tick engine feeds the port's decide, JAX's tick engine
    JAX's decide, over 3 ticks: gates and exec agree exactly but where a
    deciding feature lies within the tick test's derived bound
    (tests/test_torch_tick.py) of a threshold; the port's decide on JAX's
    own tick table agrees everywhere, bit for bit."""
    symbols, ex = _tick_tape()
    jtick = JTickEngine(symbols, ("1m",), window=128)
    ttick = TickEngine(symbols, ("1m",), window=128, device="cpu")
    grid = dict(ai_confidence_threshold=0.3, min_signal_strength=20.0)
    jeng, teng = _pair(symbols, 8, grid)
    _, mirror = _pair(symbols, 8, grid)
    for i in range(8):
        for e in (jeng, teng, mirror):
            e.set_tenant(i, min_strength=10.0 * i, conf_threshold=0.1 * i,
                         balance=2_000.0 + 500 * i)
    flips = decided = execs = 0
    for tick in range(3):
        if tick:
            ex.advance(steps=1)
        for s in symbols:
            kl = ex.get_klines(s, "1m", 128)
            jtick.ingest(s, "1m", kl)
            ttick.ingest(s, "1m", kl)
        jtick.step()
        ttick.step()
        jf = jeng.feats_from_tick(jtick.last_out, jtick.last_valid)
        tf = teng.feats_from_tick(ttick.last_out, ttick.last_valid)
        jout, tout = jeng.decide(jf), teng.decide(tf)
        _same(mirror.decide({k: np.asarray(v) for k, v in jf.items()}), jout, "same feats")
        np.testing.assert_array_equal(tf["signal"], jf["signal"])
        np.testing.assert_array_equal(tf["valid"], jf["valid"])
        bound = 1e-4 + 1e-5 * np.abs(np.nan_to_num(jf["strength"])) \
            + np.where(np.abs(np.nan_to_num(np.asarray(jtick.last_out["macd"])[:teng.S, 0]))
                       < 1.0, 20 * (1e-3 + 2e-6 * np.abs(np.nan_to_num(jf["price"]))), 0.0)
        near = _near_threshold(jf, teng._params_np, bound[None, :])
        for k in ("gate", "exec"):
            diff = tout[k] != jout[k]
            assert not (diff & ~near[:8]).any(), (tick, k, np.argwhere(diff & ~near[:8]))
        flips += int((tout["gate"] != jout["gate"]).sum())
        decided += int((jout["gate"] != NO_DECISION).sum())
        execs += int(jout["exec"].sum())
    assert decided > 0 and execs > 0 and flips <= decided // 10, (flips, decided, execs)
