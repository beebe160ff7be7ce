"""The port's load harness (`testing.loadgen`) against the JAX package's,
on the CPU.

The classes of tests/test_loadgen.py and tests/test_fleet_containment.py's
harness parts, each run through both packages on the same synthetic
venue (2 symbols, a 64-candle window, a few ticks, the JAX tests' seeds):

  * a load point in both tenant modes: the published, analyzed and
    executed counts, zero REST kline calls in the steady state, the
    per-gate veto counters, every decide's gates and decisions exactly
    and its confidences and sizes within rtol 1e-5, the lanes' balances
    within rtol 1e-5 and their open / quarantine bits exactly, the lane
    venues' fills;
  * the ramp with an injected blocking lag (`analyzer_lag_s`,
    `engine_lag_s`) breaches at the same tenant count as JAX's and names
    the same stage; one harness serves the whole schedule, and a heavy
    step's tail does not bleed into the next;
  * the dispatch-degradation ladder and hand-back, the fleet snapshots
    through `run_load`, and the fleet soak: poisoned lanes, a per-lane
    venue outage, heal, and a kill and restart that restores the same
    lanes as JAX's;
  * `run_load` and `ramp` put the process-wide fleet scope back on every
    exit, a raising one included.

Latencies, duty cycles and loop lag are wall-clock readings and are not
compared, only the stages they name.  No test here is marked slow: the
JAX files' slow soaks have no twins.
"""

import asyncio
from dataclasses import replace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ai_crypto_trader_tpu import config as jconfig  # noqa: E402
from ai_crypto_trader_tpu.obs import fleetscope as jfleetscope  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.testing import chaos as jchaos  # noqa: E402
from ai_crypto_trader_tpu.testing import loadgen as jloadgen  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu.utils import journal as jjournal  # noqa: E402
from ai_crypto_trader_tpu.utils import metrics as jmetrics  # noqa: E402
from ai_crypto_trader_tpu_torch import config as tconfig  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import fleetscope as tfleetscope  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.testing import chaos as tchaos  # noqa: E402
from ai_crypto_trader_tpu_torch.testing import loadgen as tloadgen  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import journal as tjournal  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import metrics as tmetrics  # noqa: E402

PKGS = {
    "jax": dict(loadgen=jloadgen, config=jconfig, fleetscope=jfleetscope, chaos=jchaos,
                journal=jjournal, metrics=jmetrics, kw={}),
    "port": dict(loadgen=tloadgen, config=tconfig, fleetscope=tfleetscope, chaos=tchaos,
                 journal=tjournal, metrics=tmetrics, kw={"device": "cpu"}),
}
BOTH = ("jax", "port")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_scopes():
    """No observatory of either package is active when a test starts; the
    harness installs its own fleet scope.  Each scope is put back."""
    with jtickpath.use(None), devprof.use(None), meshprof.use(None), \
            jfleetscope.use(None), ttickpath.use(None), tfleetscope.use(None):
        yield
        assert tfleetscope.active() is None and jfleetscope.active() is None


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(P, **kw):
    """tests/test_loadgen.py's `_load_config` for ``P``."""
    base = dict(tenants=2, symbols=2, ticks=6, warmup_ticks=2, window=64,
                slo_p99_ms=250.0, min_samples=2, seed=3)
    base.update(kw)
    if isinstance(base.get("trading"), dict):
        base["trading"] = P["config"].TradingParams(**base["trading"])
    return P["loadgen"].LoadConfig(**base, **P["kw"])


PERMISSIVE = dict(ai_confidence_threshold=0.0, min_signal_strength=0.0, min_trade_amount=1.0)


def _soak_cfg(P, tmp_path=None, **kw):
    """tests/test_fleet_containment.py's `_soak_config` for ``P``."""
    base = dict(mode="vmapped", tenants=6, symbols=2, ticks=8, warmup_ticks=2, window=64,
                min_samples=2, seed=3, slo_p99_ms=30_000.0, trading=PERMISSIVE,
                fleet_snapshot_every=2)
    if tmp_path is not None:
        base["fleet_journal_path"] = str(tmp_path / f"{id(P)}.fleet.journal")
    base.update(kw)
    return _cfg(P, **base)


# wall-clock readings of a report
_WALL = ("p50_ms", "p99_ms", "max_ms", "stage_duty", "saturated_stages", "bottleneck_stage",
         "event_loop_lag_max_s", "capacity", "fleet")


def _record_decides(traffic) -> list:
    """Wrap the harness's tenant engine so each decide's output is kept."""
    outs = []
    eng = traffic.tenant_engine
    real = eng.decide

    def decide(feats):
        out = real(feats)
        outs.append({k: np.asarray(v).copy() for k, v in out.items()})
        return out

    eng.decide = decide
    return outs


def _venue_fills(lanes) -> list:
    out = []
    for n in sorted(lanes):
        venue = getattr(lanes[n].venue, "inner", lanes[n].venue)
        out.append((n, [{k: f[k] for k in ("symbol", "side", "price", "quantity",
                                            "client_order_id")}
                        for f in venue.fills]))
    return out


def _observe(P, traffic, rep, decides) -> dict:
    eng = traffic.tenant_engine
    lanes = traffic._vm_lanes if eng is not None else dict(enumerate(traffic.lanes))
    vetoes = {k: v for k, v in traffic.metrics.counters.items() if "decision_vetoes" in k}
    obs = {"report": {k: v for k, v in rep.items() if k not in _WALL}, "decides": decides,
           "vetoes": vetoes, "fills": _venue_fills(lanes),
           "balances": [float(lanes[n].venue.get_balances().get("USDC", 0.0))
                        for n in sorted(lanes)]}
    if eng is not None:
        obs["state"] = {k: np.asarray(v).copy() for k, v in eng._state_np.items()}
    if rep.get("fleet"):
        obs["gate_mix"] = rep["fleet"].get("gate_mix")
    return obs


def _load_point(P, **kw):
    cfg = _cfg(P, **kw)
    traffic = P["loadgen"].SyntheticTenantTraffic(cfg)
    decides = _record_decides(traffic) if traffic.tenant_engine is not None else []
    with P["loadgen"]._fleet_scope(traffic):
        try:
            rep = asyncio.run(traffic.run())
        finally:
            traffic.close()
    return _observe(P, traffic, rep, decides)


def _close(a, b, where):
    if isinstance(b, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in b:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=RTOL, abs=1e-6), (where, a, b)
    else:
        assert a == b, (where, a, b)


def assert_follows_jax(port, ref):
    """Counts, gates, decisions, bits and fills' sides exactly; floats
    within rtol 1e-5."""
    _close(port, ref, "load")


# --- load points in both modes ------------------------------------------------

@pytest.fixture(scope="module")
def points():
    out = {}
    for name in BOTH:
        P = PKGS[name]
        out[(name, "objects")] = _load_point(P)
        out[(name, "vmapped")] = _load_point(P, mode="vmapped", tenants=5)
        # seed 5: BUY signals inside the measured window, so lanes trade
        out[(name, "permissive")] = _load_point(P, mode="vmapped", tenants=6, ticks=8,
                                                trading=PERMISSIVE, seed=5)
        out[(name, "objects_permissive")] = _load_point(P, tenants=3, ticks=8,
                                                        trading=PERMISSIVE, seed=5)
    return out


class TestLoadHarness:
    def test_load_point_smoke_real_path_zero_rest(self, points):
        rep = points[("port", "objects")]["report"]
        assert (rep["ticks"], rep["lanes"], rep["published"], rep["analyzed"]) == \
            (6, 4, 12, 24)
        assert rep["rest_kline_calls_steady"] == 0 and rep["mode"] == "objects"

    @pytest.mark.parametrize("point", ["objects", "vmapped", "permissive", "objects_permissive"])
    def test_load_point_follows_jax(self, points, point):
        assert_follows_jax(points[("port", point)], points[("jax", point)])

    def test_permissive_points_trade(self, points):
        """The permissive points load the venue path: positions open, and
        the vmapped fleet's executable decisions reach lane executors."""
        vm, ob = points[("port", "permissive")], points[("port", "objects_permissive")]
        assert vm["report"]["executed"] > 0 and any(f for _, f in vm["fills"])
        assert ob["report"]["executed"] > 0 and any(f for _, f in ob["fills"])

    def test_tenant_lanes_are_independent(self):
        def go(P):
            traffic = P["loadgen"].SyntheticTenantTraffic(_cfg(P, tenants=3))

            async def run():
                for _ in range(3):
                    await traffic.tick(timed=False)

            asyncio.run(run())
            lanes = [lane.analyzer.lane for lane in traffic.lanes]
            same_lane = all(la.executor.lane == la.analyzer.lane for la in traffic.lanes)
            sig = traffic.bus.get("latest_signal_" + traffic.symbols[0])
            return lanes, same_lane, sig.get("lane") in lanes, traffic.analyzed

        out = {name: go(PKGS[name]) for name in BOTH}
        assert out["port"] == out["jax"]
        assert len(set(out["port"][0])) == 3 and out["port"][1] and out["port"][2]

    def test_vmapped_load_point_zero_rest_and_gauges(self):
        m = tmetrics.MetricsRegistry()
        rep = tloadgen.run_load(_cfg(PKGS["port"], mode="vmapped", tenants=5), metrics=m)
        assert rep["mode"] == "vmapped" and (rep["ticks"], rep["lanes"]) == (6, 10)
        assert rep["analyzed"] == 6 * 2 * 5 and rep["rest_kline_calls_steady"] == 0
        assert rep["capacity"]["tenant_mode"] == "vmapped" and rep["fleet"]["decides"] > 0
        text = m.exposition()
        assert 'crypto_trader_tpu_tenant_lanes{mode="vmapped"} 10' in text
        assert "crypto_trader_tpu_decision_vetoes_total{gate=" in text
        assert 'crypto_trader_tpu_stage_duty_cycle{stage="stream"}' in text


# --- the ramp -------------------------------------------------------------------

def _ramp(P, **kw):
    out = P["loadgen"].ramp(_cfg(P, **kw))
    return {"breach": out["breach"] and out["breach"]["tenants"],
            "max": out["max_sustainable"] and out["max_sustainable"]["tenants"],
            "tenants": [s["tenants"] for s in out["steps"]],
            "breached": [s["breached"] for s in out["steps"]],
            "saturated": sorted(out["saturated_stages"]),
            "bottleneck": out["bottleneck_stage"], "mode": out["mode"],
            "rest": [s["rest_kline_calls_steady"] for s in out["steps"]]}


class TestRamp:
    def test_ramp_breach_attributed_to_named_stage(self):
        """A second of blocking analyzer work a lane a tick, against a
        1.5 s SLO: one tenant sustains whatever the rest of the tick costs
        on a loaded host (up to 500 ms), two breach.  Both packages breach
        at 2 and name the analyzer."""
        kw = dict(tenants=4, ticks=3, warmup_ticks=1, slo_p99_ms=1500.0, analyzer_lag_s=1.0,
                  min_samples=2)
        out = {name: _ramp(PKGS[name], **kw) for name in BOTH}
        assert out["port"] == out["jax"]
        r = out["port"]
        assert (r["breach"], r["max"], r["tenants"]) == (2, 1, [1, 2])
        assert "analyzer" in r["saturated"] and r["bottleneck"] == "analyzer"
        assert r["rest"] == [0, 0]

    def test_vmapped_ramp_breach_attributed_to_engine_stage(self):
        """The vmapped twin: a blocking lag inside the tenant stage once a
        tick breaches at the first step in both packages, named
        tenant_engine."""
        kw = dict(mode="vmapped", tenants=4, ticks=3, warmup_ticks=1, slo_p99_ms=300.0,
                  engine_lag_s=0.5, min_samples=2)
        out = {name: _ramp(PKGS[name], **kw) for name in BOTH}
        assert out["port"] == out["jax"]
        r = out["port"]
        assert (r["breach"], r["max"], r["mode"]) == (1, None, "vmapped")
        assert "tenant_engine" in r["saturated"] and r["bottleneck"] == "tenant_engine"

    def test_ramp_reuses_one_harness(self, monkeypatch):
        built = []
        real = tloadgen.SyntheticTenantTraffic

        class Counting(real):
            def __init__(self, *a, **kw):
                built.append(1)
                super().__init__(*a, **kw)

        monkeypatch.setattr(tloadgen, "SyntheticTenantTraffic", Counting)
        out = tloadgen.ramp(_cfg(PKGS["port"], tenants=4, ticks=3, min_samples=2,
                                 slo_p99_ms=60_000.0))
        assert len(built) == 1 and [s["tenants"] for s in out["steps"]] == [1, 2, 4]
        assert out["breach"] is None and out["max_sustainable"]["tenants"] == 4

    def test_heavy_step_tail_does_not_bleed_into_next_step(self):
        """tests/test_loadgen.py's window isolation on the port, with a lag
        (a second a lane a tick) and an SLO (1 s) that leave the rest of
        the tick 750 ms on a loaded host before the clean step saturates."""
        base = _cfg(PKGS["port"], tenants=2, ticks=3, warmup_ticks=1, min_samples=2,
                    slo_p99_ms=1000.0)
        traffic = tloadgen.SyntheticTenantTraffic(base, points=3)
        asyncio.run(traffic.run())
        traffic.cfg = replace(traffic.cfg, analyzer_lag_s=1.0)
        heavy = asyncio.run(traffic.run())
        assert heavy["p99_ms"] > 1000.0 and "analyzer" in heavy["saturated_stages"]
        assert heavy["event_loop_lag_max_s"] >= 1.0
        traffic.cfg = replace(traffic.cfg, analyzer_lag_s=0.0)
        traffic.set_tenants(2)
        clean = asyncio.run(traffic.run())
        assert clean["ticks"] == 3 and len(traffic.latencies_ms) == 3
        assert clean["p99_ms"] < heavy["p99_ms"] / 2 and clean["saturated_stages"] == {}
        for stage, window in traffic.saturation._windows.items():
            assert len(window) == 3, stage

    @pytest.mark.parametrize("steps,want", [(1, [1]), (4, [1, 2, 4]), (6, [1, 2, 4, 6])])
    def test_default_tenant_steps_follow_jax(self, steps, want):
        assert tloadgen.default_tenant_steps(steps) == \
            jloadgen.default_tenant_steps(steps) == want


# --- degradation, snapshots, the fleet soak --------------------------------------

class TestDispatchDegradation:
    def test_failed_dispatch_trips_breaker_then_hands_back(self):
        def go(P):
            traffic = P["loadgen"].SyntheticTenantTraffic(_soak_cfg(P, ticks=6), points=1)
            eng = traffic.tenant_engine
            real = eng.decide

            def exploding(feats):
                raise RuntimeError("chaos: dispatch aborted")

            async def run():
                for _ in range(2):
                    await traffic.tick(timed=False)
                eng.decide = exploding
                await traffic.tick()
                trace = [(traffic.degraded_ticks, traffic.engine_breaker.failures,
                          traffic.engine_breaker.quarantined)]
                eng.decide = real
                for _ in range(5):
                    await traffic.tick()
                    trace.append((traffic.degraded_ticks, traffic.engine_breaker.failures,
                                  traffic.engine_breaker.quarantined))
                return trace

            with P["loadgen"]._fleet_scope(traffic):
                trace = asyncio.run(run())
                rep = traffic.report()
            traffic.close()
            return trace, rep["containment"]["degraded_ticks"], \
                rep["containment"]["engine_breaker"]["failures"], \
                traffic.metrics.counters.get("crypto_trader_tpu_fleet_degraded_ticks_total", 0)

        out = {name: go(PKGS[name]) for name in BOTH}
        assert out["port"] == out["jax"]
        trace, degraded, failures, counted = out["port"]
        assert trace[0][0] == 1 and trace[0][2] and not trace[-1][2]
        assert 1 < trace[-1][0] < 6 and failures == 0 and counted == degraded

    def test_report_and_snapshots_flow_through_run_load(self, tmp_path):
        def go(P):
            cfg = _soak_cfg(P, tmp_path)
            rep = P["loadgen"].run_load(cfg)
            payload, stats = P["journal"].load_snapshot(cfg.fleet_journal_path)
            return rep["containment"]["quarantined"], rep["containment"]["snapshots"], \
                payload["n_tenants"], stats["corrupt_records"]

        out = {name: go(PKGS[name]) for name in BOTH}
        assert out["port"] == out["jax"]
        assert out["port"][0] == [] and out["port"][1] >= 1 and out["port"][2] == 6


def _drive(traffic, ticks, poison_at=None, poison=()):
    async def go():
        for _ in range(traffic.cfg.warmup_ticks):
            await traffic.tick(timed=False)
        for i in range(ticks):
            if poison_at is not None and i == poison_at:
                for fn in poison:
                    fn(traffic)
            await traffic.tick()

    asyncio.run(go())


def _lane_ledger_conserved(traffic, P, quote0=10_000.0):
    for n, lane in traffic._vm_lanes.items():
        venue = getattr(lane.venue, "inner", lane.venue)
        coids = [f["client_order_id"] for f in venue.fills if f.get("client_order_id")]
        assert len(coids) == len(set(coids)), f"lane {n}: duplicate coid"
        assert all(P["chaos"].lane_of_coid(c) == n for c in coids)
        derived = {"USDC": quote0}
        for f in venue.fills:
            base, cost = f["symbol"][:-4], f["quantity"] * f["price"]
            sign = -1.0 if f["side"] == "BUY" else 1.0
            derived["USDC"] = derived.get("USDC", 0.0) + sign * cost - f.get("fee", 0.0)
            derived[base] = derived.get(base, 0.0) - sign * f["quantity"]
        for asset, v in venue.get_balances().items():
            np.testing.assert_allclose(v, derived.get(asset, 0.0), rtol=1e-9, atol=1e-5)


def _fleet_soak(P, tmp_path, n_tenants=6, ticks=8):
    """tests/test_fleet_containment.py's fleet soak for one package:
    poison one lane's state and another's params, take the first lane's
    venue down, heal, snapshot, kill, restore, trade on."""
    L = P["loadgen"]
    bad_state, bad_param = 2, n_tenants - 1
    cfg = _soak_cfg(P, tmp_path, tenants=n_tenants, ticks=ticks)
    traffic = L.SyntheticTenantTraffic(cfg, points=1)
    twin = L.SyntheticTenantTraffic(_soak_cfg(P, tenants=n_tenants, ticks=ticks), points=1)
    for t in (traffic, twin):
        t.tenant_engine._params_np["cooldown_ticks"][:] = 2
        t.tenant_engine._need_seed = True
    outage = P["chaos"].FaultSchedule(seed=1, rates={"error": 1.0})

    def corrupt(tr):
        P["chaos"].poison_lane_state(tr.tenant_engine, bad_state, "balance")
        P["chaos"].poison_lane_params(tr.tenant_engine, bad_param, "conf_threshold")
        lane = tr._vm_lane(bad_state)
        lane.venue = P["chaos"].ChaosExchange(lane.venue, outage, lane=bad_state)

    with L._fleet_scope(traffic):
        _drive(traffic, ticks, poison_at=2, poison=(corrupt,))
    with L._fleet_scope(twin):
        _drive(twin, ticks)
    eng, eng_t = traffic.tenant_engine, twin.tenant_engine
    quarantined = sorted(v["lane"] for v in eng.quarantined_lanes())
    healthy = [i for i in range(n_tenants) if i not in (bad_state, bad_param)]
    for k, v in eng._state_np.items():
        np.testing.assert_array_equal(np.asarray(v)[healthy],
                                      np.asarray(eng_t._state_np[k])[healthy], err_msg=k)
    _lane_ledger_conserved(traffic, P)
    traffic.fleet_journal.write(eng.snapshot())
    final = {k: np.asarray(v).copy() for k, v in eng._state_np.items()}
    counters = (eng.balance_resyncs, eng.quarantine_trips, eng.heals_total)
    traffic.fleet_journal.journal.simulate_crash()
    revived = L.SyntheticTenantTraffic(cfg, points=1)
    payload, stats = P["journal"].load_snapshot(cfg.fleet_journal_path)
    restored = revived.tenant_engine.restore(payload)
    for k, v in final.items():
        np.testing.assert_array_equal(revived.tenant_engine._state_np[k], v, err_msg=k)
    revived_counters = (revived.tenant_engine.balance_resyncs,
                        revived.tenant_engine.quarantine_trips,
                        revived.tenant_engine.heals_total)
    revived.tenant_engine._params_np["cooldown_ticks"][:] = 2
    revived.tenant_engine._need_seed = True
    with L._fleet_scope(revived):
        _drive(revived, 5)
    _lane_ledger_conserved(revived, P)
    after = (revived.tenant_engine.heals_total,
             sorted(v["lane"] for v in revived.tenant_engine.quarantined_lanes()))
    for t in (traffic, twin, revived):
        t.close()
    return {"quarantined": quarantined, "counters": counters, "restored": restored,
            "revived_counters": revived_counters, "after": after,
            "snapshot_corrupt": stats["corrupt_records"], "state": final,
            "fills": _venue_fills(traffic._vm_lanes)}


def test_fleet_chaos_soak_smoke(tmp_path):
    out = {name: _fleet_soak(PKGS[name], tmp_path) for name in BOTH}
    port, ref = out["port"], out["jax"]
    assert_follows_jax({k: v for k, v in port.items() if k != "restored"},
                       {k: v for k, v in ref.items() if k != "restored"})
    assert port["restored"]["lanes"] == ref["restored"]["lanes"] == 6
    assert port["restored"]["quarantined"] == ref["restored"]["quarantined"] == 1
    assert port["quarantined"] == [2] and port["snapshot_corrupt"] == 0
    assert port["revived_counters"] == port["counters"]
    trips, heals = port["counters"][1], port["counters"][2]
    assert trips >= 2 and heals >= 1
    assert port["after"][0] > heals and port["after"][1] == []


# --- the fleet scope is released on every exit -------------------------------------

class TestFleetScopeRelease:
    def test_run_load_restores_the_previous_scope(self):
        mine = tfleetscope.FleetScope()
        with tfleetscope.use(mine):
            tloadgen.run_load(_cfg(PKGS["port"], mode="vmapped", ticks=1, warmup_ticks=1))
            assert tfleetscope.active() is mine
        assert tfleetscope.active() is None

    @pytest.mark.parametrize("entry", ["run_load", "ramp"])
    def test_a_raising_run_releases_the_scope(self, monkeypatch, entry):
        seen = []

        async def boom(self):
            seen.append(tfleetscope.active())
            raise RuntimeError("load point failed")

        monkeypatch.setattr(tloadgen.SyntheticTenantTraffic, "run", boom)
        with pytest.raises(RuntimeError, match="load point failed"):
            getattr(tloadgen, entry)(_cfg(PKGS["port"], mode="vmapped"))
        assert seen and seen[0] is not None           # the run had a scope
        assert tfleetscope.active() is None           # and it is gone

    def test_objects_mode_installs_no_scope(self, monkeypatch):
        seen = []
        real = tloadgen.SyntheticTenantTraffic.run

        async def spy(self):
            seen.append(tfleetscope.active())
            return await real(self)

        monkeypatch.setattr(tloadgen.SyntheticTenantTraffic, "run", spy)
        tloadgen.run_load(_cfg(PKGS["port"], ticks=1, warmup_ticks=1))
        assert seen == [None]
