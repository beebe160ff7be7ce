"""The port's fault-injection harness (`testing.chaos`) against the JAX
package's, on the CPU.

  * `FaultSchedule`: the same seed, rates, script and outage windows give
    the same fault sequence in both packages, call for call;
  * `ChaosExchange` over each package's paper exchange: the same faults on
    the same calls (errors, latency, stale / partial / malformed klines,
    NaN poison, the mid-order crash, per-lane schedules routed by client
    order id), and every adapter method wired through the fault injector;
  * the bus faults (`inject_bus_faults`, `ChaosBus`), the frame-feed
    faults (`ChaosFrameSource`, both modes), `kline_frames_for`,
    `CountingKlines`, `poisoned_depth_records` and `torn_tail` — exactly;
  * the lane poisons on the port's `TenantEngine` quarantine the same
    lanes as on JAX's, the other lanes' decisions equal; the member
    poisons copy one member's rows of the port's RL fleet and leave the
    rest (and the input) untouched, and the next generation trips it;
  * tests/test_chaos.py's kill-and-restart smoke in both packages on one
    fault seed: the same injected faults, the same venue fills and closed
    trades, and the crash-safety invariants on the port's run.

The JAX package's full soak is marked slow; it has no twin here.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from ai_crypto_trader_tpu import config as jconfig  # noqa: E402
from ai_crypto_trader_tpu.data import ingest as jingest  # noqa: E402
from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.obs import fleetscope as jfleetscope  # noqa: E402
from ai_crypto_trader_tpu.obs import flightrec as jflightrec  # noqa: E402
from ai_crypto_trader_tpu.obs import tickpath as jtickpath  # noqa: E402
from ai_crypto_trader_tpu.ops import tenant_engine as jtenant  # noqa: E402
from ai_crypto_trader_tpu.rl import dqn as jdqn  # noqa: E402
from ai_crypto_trader_tpu.rl import population as jpop  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu.shell import exchange as jex  # noqa: E402
from ai_crypto_trader_tpu.shell import launcher as jlauncher  # noqa: E402
from ai_crypto_trader_tpu.testing import chaos as jchaos  # noqa: E402
from ai_crypto_trader_tpu.utils import devprof, meshprof  # noqa: E402
from ai_crypto_trader_tpu.utils import health as jhealth  # noqa: E402
from ai_crypto_trader_tpu_torch import config as tconfig  # noqa: E402
from ai_crypto_trader_tpu_torch import testing as ttesting  # noqa: E402
from ai_crypto_trader_tpu_torch.data import ingest as tingest  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import fleetscope as tfleetscope  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import flightrec as tflightrec  # noqa: E402
from ai_crypto_trader_tpu_torch.obs import tickpath as ttickpath  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import tenant_engine as ttenant  # noqa: E402
from ai_crypto_trader_tpu_torch.rl import dqn as tdqn  # noqa: E402
from ai_crypto_trader_tpu_torch.rl import population as tpop  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import exchange as tex  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import launcher as tlauncher  # noqa: E402
from ai_crypto_trader_tpu_torch.testing import chaos as tchaos  # noqa: E402
from ai_crypto_trader_tpu_torch.utils import health as thealth  # noqa: E402

PKGS = {
    "jax": dict(chaos=jchaos, ex=jex, bus=jbus, launcher=jlauncher, config=jconfig,
                ingest=jingest, health=jhealth, flightrec=jflightrec, tenant=jtenant,
                kw={}),
    "port": dict(chaos=tchaos, ex=tex, bus=tbus, launcher=tlauncher, config=tconfig,
                 ingest=tingest, health=thealth, flightrec=tflightrec, tenant=ttenant,
                 kw={"device": "cpu"}),
}
BOTH = ("jax", "port")


@pytest.fixture(autouse=True)
def _no_scopes():
    """No observatory of either package is active in a test; each scope
    is put back afterwards."""
    with jtickpath.use(None), devprof.use(None), meshprof.use(None), \
            jfleetscope.use(None), ttickpath.use(None), tfleetscope.use(None):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(scenario):
    out = {name: scenario(PKGS[name]) for name in BOTH}
    assert out["port"] == out["jax"]
    return out["port"]


def _series(P, symbols, n, seed=21):
    return {s: P["ingest"].from_dict({k: v for k, v in generate_ohlcv(n=n, seed=seed + i).items()
                                      if k != "regime"}, symbol=s)
            for i, s in enumerate(symbols)}


def _venue(P, symbols=("BTCUSDC",), n=800, advance=600, **kw):
    ex = P["ex"].FakeExchange(_series(P, list(symbols), n), quote_balance=10_000.0, **kw)
    ex.advance(steps=advance)
    return ex


def _outcome(fn):
    """A call's result, or the name of what it raised."""
    try:
        return ("ok", fn())
    except BaseException as e:                         # noqa: BLE001
        return ("raised", type(e).__name__, str(e))


def _nan_safe(x):
    """JSON text of ``x`` with NaN spelled out, so results with NaN
    compare equal."""
    return json.dumps(x, sort_keys=True, default=str)


# --- FaultSchedule -----------------------------------------------------------

SCHEDULES = [
    dict(seed=0, rates={"error": 0.2, "latency": 0.1, "stale": 0.1}),
    dict(seed=7, rates={"error": 0.04, "latency": 0.02, "stale": 0.02, "partial": 0.01,
                        "malformed": 0.01, "crash_after_order": 0.01, "bus_drop": 0.01,
                        "bus_dup": 0.01, "bus_delay": 0.01}),
    dict(seed=3, rates={"error": 0.5}, script={2: "latency", 5: "crash_after_order"},
         outages=((10, 14),)),
    dict(seed=13, rates={"fs_dup": 0.15, "fs_ooo": 0.15, "fs_malformed": 0.1,
                         "fs_stale": 0.1}),
]


@pytest.mark.parametrize("spec", range(len(SCHEDULES)))
def test_fault_schedule_sequence_follows_jax(spec):
    methods = [("get_klines", jchaos.READ_FAULTS), ("place_order", jchaos.ORDER_FAULTS),
               ("stream_frame", jchaos.STREAM_FAULTS), ("bus:x", jchaos.BUS_FAULTS),
               ("get_ticker", ("error", "latency", "poison"))]

    def go(P):
        s = P["chaos"].FaultSchedule(**SCHEDULES[spec])
        seq = [s.next_fault(m, e) for _ in range(80) for m, e in methods]
        return seq, s.injected, s.calls, s.rng.random()

    seq, injected, calls, _ = same(go)
    assert calls == 400 and len(injected) == sum(f is not None for f in seq) > 0


def test_vocabularies_equal_jax():
    names = ("READ_FAULTS", "ORDER_FAULTS", "POISON_FAULTS", "BUS_FAULTS", "STREAM_FAULTS",
             "FAULT_EXEMPT")
    same(lambda P: [getattr(P["chaos"], n) for n in names])
    assert set(ttesting.__all__ if hasattr(ttesting, "__all__") else dir(ttesting)) >= {
        "ChaosBus", "ChaosExchange", "FaultSchedule", "SimulatedCrash", "inject_bus_faults",
        "torn_tail"}


def test_simulated_crash_is_not_an_exception():
    assert issubclass(tchaos.SimulatedCrash, BaseException)
    assert not issubclass(tchaos.SimulatedCrash, Exception)


@pytest.mark.parametrize("coid,lane", [("ld7-ent-P000USDC-3", 7), ("ld123-x", 123),
                                       ("wj-ent-BTCUSDC-1", None), ("ldx-broken", None),
                                       (None, None), ("", None)])
def test_lane_of_coid_follows_jax(coid, lane):
    assert tchaos.lane_of_coid(coid) == jchaos.lane_of_coid(coid) == lane


# --- ChaosExchange -------------------------------------------------------------

def _exchange_script(P, seed, rates, lane_schedules=None):
    """One scripted session of adapter calls through a ChaosExchange:
    every outcome, the sleeps and the fault log."""
    ex = _venue(P, ("BTCUSDC", "ETHUSDC"))
    sleeps = []
    lanes = {k: P["chaos"].FaultSchedule(**v) for k, v in (lane_schedules or {}).items()}
    cx = P["chaos"].ChaosExchange(ex, P["chaos"].FaultSchedule(seed=seed, rates=rates),
                                  sleep=sleeps.append, latency_s=2.0, lane_schedules=lanes)
    out = []
    for i in range(40):
        sym = ("BTCUSDC", "ETHUSDC")[i % 2]
        out.append(_outcome(lambda: cx.get_klines(sym, "1m", 8)))
        out.append(_outcome(lambda: cx.get_ticker(sym)))
        out.append(_outcome(lambda: cx.get_balances()))
        out.append(_outcome(lambda: cx.get_order_book(sym, 5)))
        out.append(_outcome(lambda: cx.list_open_orders()))
        coid = f"ld{i % 3}-ent-{sym}-{i}"
        placed = _outcome(lambda: cx.place_order(sym, "BUY", "MARKET", 0.001,
                                                 client_order_id=coid))
        out.append(placed)
        out.append(_outcome(lambda: cx.find_order_by_client_id(sym, coid)))
        if placed[0] == "ok":
            oid = placed[1]["order_id"]
            out.append(_outcome(lambda: cx.order_is_open(sym, oid)))
            out.append(_outcome(lambda: cx.order_state(sym, oid, 0.001)))
            out.append(_outcome(lambda: cx.executed_qty(sym, oid, 0.001, False)))
            out.append(_outcome(lambda: cx.cancel_order(sym, oid)))
        out.append(_outcome(lambda: cx.list_symbols()))
        ex.advance()
    logs = {k: v.injected for k, v in lanes.items()}
    return _nan_safe([out, sleeps, cx.schedule.injected, logs, ex.fills])


@pytest.mark.parametrize("seed", [1, 4])
def test_chaos_exchange_session_follows_jax(seed):
    rates = {"error": 0.08, "latency": 0.05, "stale": 0.05, "partial": 0.05,
             "malformed": 0.05, "poison": 0.05, "crash_after_order": 0.05}
    text = same(lambda P: _exchange_script(P, seed, rates))
    for fault in ("ConnectionError", "SimulatedCrash", "NaN"):
        assert fault in text, fault


def test_per_lane_schedules_route_by_client_order_id():
    lanes = {1: dict(seed=2, rates={"error": 1.0}), 2: dict(seed=3, outages=((0, 1000),))}
    text = same(lambda P: _exchange_script(P, 5, {}, lane_schedules=lanes))
    assert "chaos: order lost before the venue" in text


def test_every_interface_method_is_fault_wired():
    """tests/test_fleet_containment.py's drift check on the port: every
    public ExchangeInterface method is overridden in ChaosExchange or
    listed in FAULT_EXEMPT."""
    import inspect

    surface = {n for n, _ in inspect.getmembers(tex.ExchangeInterface, predicate=callable)
               if not n.startswith("_")}
    wired = {n for n in vars(tchaos.ChaosExchange) if not n.startswith("_")}
    assert surface and not (surface - wired - tchaos.FAULT_EXEMPT)
    assert tchaos.FAULT_EXEMPT <= surface and "list_symbols" in wired


# --- bus and frame faults -------------------------------------------------------

def test_bus_faults_follow_jax():
    def go(P):
        sched = P["chaos"].FaultSchedule(seed=4, rates={"bus_drop": 0.2, "bus_dup": 0.2,
                                                        "bus_delay": 0.2})
        bus = P["chaos"].ChaosBus(now_fn=lambda: 0.0, schedule=sched)
        plain = P["bus"].EventBus(now_fn=lambda: 0.0)
        P["chaos"].inject_bus_faults(plain, P["chaos"].FaultSchedule(seed=9, rates={
            "bus_drop": 0.3}))
        qs = {ch: (bus.subscribe(ch), plain.subscribe(ch)) for ch in ("a", "alerts")}

        async def run():
            out = []
            for i in range(60):
                ch = "alerts" if i % 7 == 0 else "a"
                out.append((await bus.publish(ch, {"i": i}), await plain.publish(ch, {"i": i})))
            return out

        delivered = asyncio.run(run())
        got = {ch: [[q.get_nowait()["data"]["i"] for _ in range(q.qsize())] for q in pair]
               for ch, pair in qs.items()}
        return delivered, got, dict(bus.dropped_counts), dict(plain.dropped_counts), \
            sched.injected

    delivered, got, drops, _, injected = same(go)
    assert got["alerts"][0] == list(range(0, 60, 7))          # the exempt channel
    assert {f for _, _, f in injected} == {"bus_drop", "bus_dup", "bus_delay"}


@pytest.mark.parametrize("seed", [5, 13])
def test_frame_source_filter_follows_jax(seed):
    rates = {"fs_dup": 0.1, "fs_ooo": 0.1, "fs_malformed": 0.1, "fs_stale": 0.1,
             "fs_burst": 0.05, "fs_disconnect": 0.05, "fs_silence": 0.05}

    def go(P):
        ex = _venue(P, ("BTCUSDC", "ETHUSDC"), n=2400, advance=2200)
        src = P["chaos"].ChaosFrameSource(P["chaos"].FaultSchedule(seed=seed, rates=rates),
                                          silence_frames=3, burst=4)
        out = []
        for _ in range(20):
            ex.advance()
            frames = P["chaos"].kline_frames_for(ex, ["BTCUSDC", "ETHUSDC"],
                                                 ("1m", "3m", "5m", "15m"), event_ms=7)
            out.append(src.filter(frames))
        return out, src.disconnects, src.silenced, src.schedule.injected

    out, disconnects, silenced, injected = same(go)
    assert disconnects > 0 and silenced > 0


def test_frame_source_iterator_mode_follows_jax():
    def go(P):
        src = P["chaos"].ChaosFrameSource(P["chaos"].FaultSchedule(seed=2, script={5: "fs_dup",
                                                                                   9: "fs_ooo",
                                                                                   12: "fs_disconnect"}))

        async def inner():
            for i in range(20):
                yield json.dumps({"e": "kline", "E": i, "k": {"t": i}})

        async def run():
            got = []
            try:
                async for f in src.aiter(inner()):
                    got.append(f)
            except ConnectionError as e:
                got.append(str(e))
            return got

        return asyncio.run(run())

    got = same(go)
    assert got[-1] == "chaos: stream connection dropped"


def test_kline_frames_and_counting_follow_jax():
    def go(P):
        ex = _venue(P, ("BTCUSDC", "ETHUSDC"), n=2400, advance=2203)
        counting = P["chaos"].CountingKlines(ex)
        frames = [P["chaos"].kline_frames_for(counting, ["BTCUSDC", "ETHUSDC"],
                                              ("1m", "3m", "5m", "15m"), event_ms=e,
                                              combined=c) for e, c in ((None, False), (5, True))]
        return frames, counting.kline_calls, counting.get_balances()

    frames, calls, _ = same(go)
    assert calls == 2 * 2 * (1 + 4) and len(frames[0]) == 8
    # the x flag is honest: a 15m bar is final only with its last 1m in
    assert {json.loads(f)["k"]["x"] for f in frames[0]} == {True, False}


def test_poisoned_depth_records_and_torn_tail_follow_jax(tmp_path):
    for mode in ("nan_spread", "zero_depth", "crossed"):
        assert _nan_safe(tchaos.poisoned_depth_records(n=3, mode=mode)) == \
            _nan_safe(jchaos.poisoned_depth_records(n=3, mode=mode))
    for P in PKGS.values():
        with pytest.raises(ValueError, match="unknown poison mode"):
            P["chaos"].poisoned_depth_records(mode="bogus")
    body = b"".join(b'{"seq": %d, "data": "%s"}\n' % (i, b"x" * (10 + i)) for i in range(4))
    files = {}
    for name in BOTH:
        path = tmp_path / f"{name}.jsonl"
        path.write_bytes(body)
        PKGS[name]["chaos"].torn_tail(str(path), keep_bytes=9)
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"] and len(files["port"]) < len(body)


# --- the tenant engine's lane poisons ------------------------------------------------

def _tenant_feats(S, n_real=4, seed=0):
    """Features over the engine's padded symbol axis ``S``; the first
    ``n_real`` columns are real symbols."""
    rng = np.random.default_rng(seed)
    return {"price": (100.0 + rng.random(S) * 10).astype(np.float32),
            "signal": np.resize(np.array([1, 1, 0, -1], np.int32), S),
            "strength": np.full(S, 80.0, np.float32),
            "volatility": np.full(S, 0.01, np.float32),
            "avg_volume": np.full(S, 1e6, np.float32),
            "valid": np.arange(S) < n_real}


@pytest.mark.parametrize("poison", ["state", "params"])
def test_lane_poisons_quarantine_the_same_lanes(poison):
    symbols = [f"S{i}USDC" for i in range(4)]
    trading = {"ai_confidence_threshold": 0.0, "min_signal_strength": 0.0,
               "min_trade_amount": 1.0}

    def go(P):
        eng = P["tenant"].TenantEngine(symbols, 6, trading=P["config"].TradingParams(**trading),
                                       quarantine_cooldown=2, **P["kw"])
        feats = _tenant_feats(eng.S)
        outs = [eng.decide(feats)]
        if poison == "state":
            P["chaos"].poison_lane_state(eng, 2)
            P["chaos"].poison_lane_state(eng, 4, field="entry", value=float("inf"))
        else:
            P["chaos"].poison_lane_params(eng, 2)
            P["chaos"].poison_lane_params(eng, 4, field="conf_threshold", value=float("inf"))
        for _ in range(3):
            outs.append(eng.decide(feats))
        keys = ("decision", "gate", "confidence")
        return _nan_safe([{k: np.asarray(o[k]).tolist() for k in keys} for o in outs]), \
            eng.quarantined_lanes(), eng.quarantine_trips, eng.heal_ready()

    table, lanes, trips, ready = same(go)
    assert [r["lane"] for r in lanes] == [2, 4] and trips == 2


# --- the RL fleet's member poisons ------------------------------------------------

@pytest.fixture(scope="module")
def fleets():
    """One small port fleet (P = 4) on the LOB markets, and JAX's."""
    jp, _ = jpop.pbt_env_params(jax.random.PRNGKey(2), num_scenarios=2, steps=128,
                                episode_len=32)
    kw = dict(num_envs=2, rollout_len=2, hidden=(8,), replay_capacity=16, batch_size=4,
              learn_steps_per_iter=1, target_sync_every=3,
              state_size=int(jp.obs_table.shape[-1]) + 2)
    pkw = dict(population=4, generations=1, iters_per_generation=1, eval_steps=4)
    from ai_crypto_trader_tpu_torch import convert

    tp = convert.env_params_from_numpy(jp, device="cpu")
    tcfg, tpcfg = tdqn.DQNConfig(**kw), tpop.PBTConfig(**pkw)
    jcfg, jpcfg = jdqn.DQNConfig(**kw), jpop.PBTConfig(**pkw)
    return {"port": (tpop.pop_init(torch.Generator().manual_seed(0), tp, tcfg, tpcfg),
                     tp, tcfg, tpcfg),
            "jax": (jpop.pop_init(jax.random.PRNGKey(0), jp, jcfg, jpcfg), jp, jcfg, jpcfg)}


def _port_leaves(tree):
    out = []
    tchaos._tree_map(lambda x: out.append(x), tree)
    return out


@pytest.mark.parametrize("field", ["params", "opt_state", "replay", "target_params"])
def test_member_state_poison_touches_one_member(fleets, field):
    pop = fleets["port"][0]
    before = [x.clone() for x in _port_leaves(pop.members)]
    poisoned = tchaos.poison_member_state(pop, 2, field=field)
    for x, b in zip(_port_leaves(pop.members), before):           # the input is untouched
        assert torch.equal(x, b) or (x.is_floating_point() and torch.equal(x.isnan(), b.isnan()))
    hit = 0
    for new, old in zip(_port_leaves(getattr(poisoned.members, field)),
                        _port_leaves(getattr(pop.members, field))):
        if new.is_floating_point():
            hit += 1
            assert torch.isnan(new[2]).all()
            keep = torch.arange(new.shape[0]) != 2
            assert torch.equal(new[keep], old[keep])
        else:
            assert new is old
    # as many float leaves as the JAX package's tree map poisons
    jleaves = jax.tree.leaves(getattr(jchaos.poison_member_state(fleets["jax"][0], 2,
                                                                 field=field).members, field))
    assert hit == sum(jax.numpy.issubdtype(x.dtype, jax.numpy.inexact) for x in jleaves) > 0
    others = [f for f in pop.members._fields if f not in (field, "draws")]
    for f in others:
        assert getattr(poisoned.members, f) is getattr(pop.members, f)


def test_member_hypers_poison_and_the_generation_trips_it(fleets):
    pop, env, cfg, pcfg = fleets["port"]
    poisoned = tchaos.poison_member_hypers(pop, 1, value=float("nan"))
    lr = poisoned.hypers.learning_rate
    assert torch.isnan(lr[1]) and torch.equal(lr[[0, 2, 3]], pop.hypers.learning_rate[[0, 2, 3]])
    assert not torch.isnan(pop.hypers.learning_rate).any()
    jlr = jchaos.poison_member_hypers(fleets["jax"][0], 1).hypers.learning_rate
    np.testing.assert_array_equal(np.isnan(np.asarray(jlr)), torch.isnan(lr).numpy())
    state = tchaos.poison_member_state(pop, 3)
    assert tdqn.poisoned_members(state.members).tolist() == [False, False, False, True]
    res = tpop.train_pbt(None, env, cfg, pcfg, init_pop=state)
    assert res.history[0]["n_tripped"] == 1 and res.history[0]["quarantined"][3]


# --- the kill-and-restart smoke in both packages ---------------------------------

QUOTE0 = 100_000.0
SMOKE_RATES = {"error": 0.04, "latency": 0.02, "stale": 0.02, "partial": 0.01,
               "malformed": 0.01, "crash_after_order": 0.01, "bus_drop": 0.01,
               "bus_dup": 0.01, "bus_delay": 0.01}


class SoakRig:
    """tests/test_chaos.py's rig for one package: one venue and one fault
    schedule surviving any number of processes; deterministic ids and a
    pinned loop-lag clock so both packages make the same calls."""

    def __init__(self, P, tmp_path, symbols, ticks, rates, seed):
        self.P = P
        self.symbols = list(symbols)
        self.clock = {"t": 0.0}
        self.inner = P["ex"].FakeExchange(_series(P, self.symbols, ticks + 720),
                                          quote_balance=QUOTE0, fee_rate=0.0)
        self.inner.advance(steps=600)
        self.schedule = P["chaos"].FaultSchedule(seed=seed, rates=rates)
        self.chaos = P["chaos"].ChaosExchange(self.inner, self.schedule, sleep=self._sleep,
                                              latency_s=2.0)
        self.journal_path = str(tmp_path / f"{id(self)}.journal")
        self.flightrec_path = str(tmp_path / f"{id(self)}.decisions.jsonl")
        self.closed_durable: set = set()
        self.restarts = 0
        self.systems = []
        self.system = self._build()

    def _sleep(self, s):
        self.clock["t"] += s

    def _now(self):
        return self.clock["t"]

    def _build(self):
        P = self.P
        ex = P["ex"].ResilientExchange(self.chaos, now_fn=self._now, sleep=self._sleep,
                                       max_read_retries=1, failure_threshold=3,
                                       reset_timeout_s=120.0, max_block_s=30.0)
        system = P["launcher"].TradingSystem(ex, self.symbols, now_fn=self._now,
                                             journal_path=self.journal_path,
                                             flightrec_path=self.flightrec_path,
                                             stage_backoff_s=0.0, stage_quarantine_s=300.0,
                                             tick_budget_s=1e9, **P["kw"])
        self.systems.append(system)
        system.loop_lag = P["health"].EventLoopLagProbe(clock=lambda: 0.0)
        system.monitor.fused = False
        system.executor.trading = P["config"].TradingParams(
            ai_confidence_threshold=0.0, min_signal_strength=0.0, min_trade_amount=1.0,
            max_positions=len(self.symbols))
        P["chaos"].inject_bus_faults(system.bus, self.schedule)
        return system

    def kill(self):
        self.closed_durable |= {(r["symbol"], r["opened_at"])
                                for r in self.system.executor.closed_trades}
        self.system.journal.simulate_crash()
        self.system.flightrec.journal.simulate_crash()
        self.restarts += 1

    async def restart_and_recover(self):
        for _ in range(30):
            self.system = self._build()
            try:
                return await self.system.recover()
            except (self.P["ex"].ExchangeUnavailable, self.P["chaos"].SimulatedCrash):
                self.system.journal.simulate_crash()
                self.clock["t"] += 150.0
        raise AssertionError("recovery never completed under chaos")

    async def run(self, ticks, kill_at=()):
        for i in range(ticks):
            self.inner.advance()
            self.clock["t"] += 60.0
            if i in kill_at:
                self.kill()
                await self.restart_and_recover()
            try:
                await self.system.tick()
            except self.P["chaos"].SimulatedCrash:
                self.kill()
                await self.restart_and_recover()

    async def drain(self, ticks=8):
        self.schedule.rates = {}
        self.clock["t"] += 310.0
        last = None
        for _ in range(ticks):
            self.inner.advance()
            self.clock["t"] += 60.0
            last = await self.system.tick()
        return last

    def shutdown(self):
        for s in self.systems:
            s.shutdown()


def check_invariants(rig, final_tick):
    """tests/test_chaos.py's crash-safety invariants on one rig."""
    inner, system = rig.inner, rig.system
    executor = system.executor
    ent_fills = [f for f in inner.fills
                 if (f.get("client_order_id") or "").startswith("wj-ent-")]
    coids = [f["client_order_id"] for f in ent_fills]
    assert len(coids) == len(set(coids)), "duplicate entry fill"
    assert all(f.get("client_order_id") for f in inner.fills if f["side"] == "BUY")
    derived = {"USDC": QUOTE0}
    for f in inner.fills:
        base, cost = f["symbol"][:-4], f["quantity"] * f["price"]
        sign = -1.0 if f["side"] == "BUY" else 1.0
        derived["USDC"] = derived.get("USDC", 0.0) + sign * cost
        derived[base] = derived.get(base, 0.0) - sign * f["quantity"]
    for asset, v in inner.get_balances().items():
        np.testing.assert_allclose(v, derived.get(asset, 0.0), rtol=1e-9, atol=1e-5)
    assert rig.closed_durable <= {(r["symbol"], r["opened_at"]) for r in executor.closed_trades}
    referenced = {oid for t in executor.active_trades.values()
                  for oid in (t.stop_order_id, t.tp_order_id) if oid is not None}
    for o in inner.list_open_orders():
        if (o.get("client_order_id") or "").startswith("wj-"):
            assert o["order_id"] in referenced, f"orphaned protection: {o}"
    for sym, t in executor.active_trades.items():
        assert inner.order_is_open(sym, t.stop_order_id)
        assert inner.order_is_open(sym, t.tp_order_id)
    system.flightrec.close()
    decisions, _ = rig.P["flightrec"].load_decisions(rig.flightrec_path)
    by_coid = {(r.get("exec") or {}).get("client_order_id"): r
               for r in decisions if r.get("exec")}
    for f in ent_fills:
        rec = by_coid.get(f["client_order_id"])
        assert rec is not None and rec.get("fills"), f["client_order_id"]
    assert all(r.get("gate") for r in decisions if r.get("status") == "vetoed")
    assert "skipped" not in final_tick
    assert not any(b.quarantined for b in system.stage_breakers.values())
    for stage in ("monitor", "analyzer", "executor"):
        assert rig.clock["t"] - system.heartbeats.beats[stage] <= 60.0
    assert executor.pending_intents == {} and rig.restarts >= 2


def _trade_view(rig):
    fills = [{k: v for k, v in f.items() if k != "order_id"} for f in rig.inner.fills]
    closed = [{k: r[k] for k in ("symbol", "opened_at", "entry_price", "exit_price", "pnl",
                                 "reason") if k in r}
              for r in rig.system.executor.closed_trades]
    return fills, closed


def test_chaos_smoke_kill_restart_follows_jax(tmp_path):
    """tests/test_chaos.py's tier-1 smoke (one symbol, the per-symbol
    monitor path, 100 ticks, two scripted kills and the schedule's
    mid-order crashes) in both packages on seed 7."""
    rigs = {}
    try:
        for name in BOTH:
            os.makedirs(tmp_path / name, exist_ok=True)
            rig = rigs[name] = SoakRig(PKGS[name], tmp_path / name, ["BTCUSDC"], ticks=100,
                                       rates=SMOKE_RATES, seed=7)

            async def go(rig=rig):
                await rig.run(100, kill_at={33, 66})
                return await rig.drain()

            rig.final = asyncio.run(go())
        port, ref = rigs["port"], rigs["jax"]
        assert port.schedule.injected == ref.schedule.injected
        assert port.restarts == ref.restarts >= 2
        pf, pc = _trade_view(port)
        jf, jc = _trade_view(ref)
        assert len(pf) == len(jf) and len(pc) == len(jc)
        for a, b in zip(pf + pc, jf + jc):
            assert set(a) == set(b)
            for k, v in b.items():
                if isinstance(v, float):
                    assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-9), (k, a, b)
                else:
                    assert a[k] == v, (k, a, b)
        check_invariants(port, port.final)
        assert len({f for _, _, f in port.schedule.injected}) >= 3
    finally:
        for rig in rigs.values():
            rig.shutdown()


def test_chaos_torn_journal_still_recovers(tmp_path):
    """tests/test_chaos.py's torn-journal restart on the port: a kill that
    tears the journal mid-record still recovers to a consistent book."""
    rig = SoakRig(PKGS["port"], tmp_path, ["BTCUSDC"], ticks=60, rates=SMOKE_RATES, seed=11)
    try:
        async def go():
            await rig.run(30)
            rig.kill()
            tchaos.torn_tail(rig.journal_path)
            await rig.restart_and_recover()
            rig.restarts += 1
            await rig.run(20)
            return await rig.drain()

        check_invariants(rig, asyncio.run(go()))
    finally:
        rig.shutdown()
