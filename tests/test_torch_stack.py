"""The port's full-service assembly (shell/stack.py) against the JAX
package's, on the CPU.

  * The adapters, as tests/test_stack.py pins them for the JAX package:
    the evolver's cadence, history gate and dropped partial bar, its seeding
    from the hot-swap surface, and the regime cadence's per-symbol gating.
  * `build_full_stack`: the nine services in the JAX package's order with
    their heartbeats expected up front, every service on the system's
    device; the pattern recognizer's three sources (a checkpoint, startup
    training, a random initialisation marked untrained) and the checkpoints
    that fall through to training with a warning (the JAX package's format,
    a damaged one, a mismatched one); a ``"stream"`` cadence, an unknown
    monitor override and a mesh partitioner refused.
  * Eight ticks of a 3-symbol trading system with the roster (the nn
    service and the structure search off; the evolver's GA shrunk to 8 × 2
    and fed the JAX package's draws; the JAX package's untrained pattern
    weights carried across) against the JAX package's: the same bus keys,
    tick returns, status and books, the social, news, regime and grid
    state exactly; the sizes and stops within rtol 1e-5 (the executor's
    social factors come from float32 sums of another order,
    tests/test_torch_social_service.py), and the evolver's hot-swapped
    params too (the GA's parity rule, tests/test_torch_ga.py).
"""

import asyncio
import logging
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_launcher import PKGS, build, drive  # noqa: E402
from test_torch_strategy_eval import _jax_draws  # noqa: E402

from ai_crypto_trader_tpu.shell import stack as jstack  # noqa: E402
from ai_crypto_trader_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import get_partitioner  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import stack as tstack  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.bus import EventBus  # noqa: E402
from ai_crypto_trader_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

ROSTER = ["social", "news", "patterns", "regime", "nn", "evolver", "generator", "grid", "dca"]
TICKS = 8
QUICK = {"patterns": {"checkpoint": None, "train_on_start": False}}


@pytest.fixture
def systems():
    built = []
    yield built
    for s in built:
        s.shutdown()


def _klines(n=300, base=100.0):
    return [[i * 60_000.0, base, base + 1, base - 1, base + 0.5, 10.0] for i in range(n)]


class StubEvolver:
    def __init__(self):
        self.calls = []

    async def evolve(self, ohlcv, current=None, metrics=None, regime="ranging",
                     history_length=0):
        self.calls.append({"n": len(ohlcv["close"]), "current": current,
                           "metrics": metrics, "regime": regime})
        return {"evolved": True, "method": "stub", "version": "v1"}


# --- the adapters (tests/test_stack.py's cases) -----------------------------

def test_evolver_cadence_history_gate_and_partial_bar():
    bus, stub, clock = EventBus(), StubEvolver(), {"t": 0.0}
    svc = tstack.EvolverService(bus, stub, interval_s=600.0, min_candles=128,
                                now_fn=lambda: clock["t"], device="cpu")
    assert asyncio.run(svc.run_once())["ran"] is False      # no history: slot kept
    bus.set("historical_data_BTCUSDC_1m", _klines(256))
    out = asyncio.run(svc.run_once())
    assert out["ran"] and out["evolved"]
    assert stub.calls[0]["n"] == 255                         # in-progress bar dropped
    assert asyncio.run(svc.run_once())["ran"] is False
    clock["t"] = 600.0
    assert asyncio.run(svc.run_once())["ran"] is True
    assert [h["method"] for h in svc.history] == ["stub", "stub"]


def test_evolver_seeds_from_hot_swapped_params_and_regime():
    from ai_crypto_trader_tpu.shell.bus import EventBus as JEventBus

    calls = {}
    for pkg, mod, bus in (("jax", jstack, JEventBus()), ("port", tstack, EventBus())):
        stub = StubEvolver()
        kw = {"device": "cpu"} if pkg == "port" else {}
        svc = mod.EvolverService(bus, stub, interval_s=1.0, min_candles=64,
                                 now_fn=lambda: 0.0, **kw)
        bus.set("historical_data_BTCUSDC_1m", _klines(256))
        bus.set("strategy_params", {"stop_loss": 4.5, "take_profit": 99.0, "bogus_key": 1.0,
                                    "rsi_period": 13.6})
        bus.set("market_regime_BTCUSDC", {"regime": "volatile"})
        asyncio.run(svc.run_once())
        calls[pkg] = stub.calls[0]
    got, ref = calls["port"]["current"], calls["jax"]["current"]
    assert got.stop_loss.device.type == "cpu"
    for f in ref._fields:
        assert float(getattr(got, f)) == float(getattr(ref, f)), f
    assert float(got.stop_loss) == 4.5
    assert calls["port"]["regime"] == calls["jax"]["regime"] == "volatile"


def test_regime_cadence_per_symbol_gating():
    class StubRegime:
        def __init__(self):
            self.updates = []

        async def update(self, symbol):
            self.updates.append(symbol)

    clock, stub = {"t": 0.0}, StubRegime()
    cad = tstack.RegimeCadence(stub, ["A", "B"], interval_s=300.0, now_fn=lambda: clock["t"])
    assert asyncio.run(cad.run_once())["updated"] == 2
    assert asyncio.run(cad.run_once())["updated"] == 0
    clock["t"] = 300.0
    assert asyncio.run(cad.run_once())["updated"] == 2
    assert stub.updates == ["A", "B", "A", "B"]


# --- build_full_stack --------------------------------------------------------

def test_roster_and_heartbeats(systems):
    system, _, _ = build("port", systems=systems, hist=600, ticks=0)
    services = tstack.build_full_stack(system, grid_symbol="AAAUSDC", dca_symbol="BBBUSDC",
                                       cadences=QUICK)
    names = [s.name for s in services]
    assert names == ROSTER
    assert system.extra_services == services
    assert set(ROSTER) <= set(system.heartbeats.expected)
    patterns = services[ROSTER.index("patterns")]
    assert patterns.recognizer.trained is False
    for svc in services:
        dev = getattr(svc, "device", None) or getattr(getattr(svc, "svc", None), "device", None)
        if dev is not None:
            assert dev == system.device == torch.device("cpu"), svc.name
    evolver = services[ROSTER.index("evolver")]
    assert evolver.evolver.device == system.device
    assert evolver.evolver.partitioner == get_partitioner()
    # the JAX package registers the same roster
    jsys, _, _ = build("jax", systems=systems, hist=600, ticks=0)
    jnames = [s.name for s in jstack.build_full_stack(
        jsys, grid_symbol="AAAUSDC", dca_symbol="BBBUSDC", cadences=QUICK)]
    assert jnames == names


@pytest.mark.parametrize("flags", [dict(nn=False), dict(generator=False, evolver=False),
                                   dict(grid_symbol=None, dca_symbol=None)])
def test_optional_services(systems, flags):
    kw = {"grid_symbol": "AAAUSDC", "dca_symbol": "AAAUSDC", **flags}
    names = {}
    for pkg, mod in (("jax", jstack), ("port", tstack)):
        system, _, _ = build(pkg, systems=systems, hist=600, ticks=0)
        names[pkg] = [s.name for s in mod.build_full_stack(system, cadences=QUICK, **kw)]
    assert names["port"] == names["jax"]


def test_stream_cadence_is_refused(systems):
    """A ``"stream"`` cadence attaches the streamed market path with its
    keys split between MarketStream and StreamSupervisor by field name, as
    JAX's does; an unknown key is refused (it refused the whole cadence
    before shell/stream was ported)."""
    system, _, _ = build("port", systems=systems, hist=600, ticks=0)
    with pytest.raises(TypeError, match="unknown stream override"):
        tstack.build_full_stack(system, cadences={**QUICK, "stream": {"bogus": 1}})
    assert system.stream is None
    # "enabled": False attaches nothing
    assert len(tstack.build_full_stack(system, cadences={**QUICK, "stream": {"enabled": False}},
                                       nn=False, generator=False)) == 5
    assert system.stream is None
    names = {}
    for pkg, mod in (("jax", jstack), ("port", tstack)):
        s, _, _ = build(pkg, systems=systems, hist=600, ticks=0)
        mod.build_full_stack(s, cadences={**QUICK, "stream": {
            "batch_size": 7, "queue_max": 9, "stale_after_s": 12.0}}, nn=False,
            generator=False)
        names[pkg] = (type(s.stream).__name__, s.stream.stream.batch_size, s.stream.queue_max,
                      s.stream.stale_after_s, s.stream.stream.monitor is s.monitor,
                      "stream" in s.stage_breakers)
    assert names["port"] == names["jax"] == ("StreamSupervisor", 7, 9, 12.0, True, True)


def test_monitor_overrides(systems):
    system, _, _ = build("port", systems=systems, hist=600, ticks=0)
    with pytest.raises(TypeError, match="unknown monitor override 'poll'"):
        tstack.build_full_stack(system, cadences={**QUICK, "monitor": {"poll": 1}})
    with pytest.raises(TypeError, match="unknown monitor override"):
        tstack.build_full_stack(system, cadences={**QUICK, "monitor": {"_engine": None}})
    tstack.build_full_stack(system, cadences={**QUICK, "monitor": {"throttle_s": 7.5}},
                            nn=False, generator=False)
    assert system.monitor.throttle_s == 7.5


def test_mesh_partitioner_is_refused(systems):
    from ai_crypto_trader_tpu.parallel.partitioner import MeshPartitioner

    system, _, _ = build("port", systems=systems, hist=600, ticks=0)
    mesh = MeshPartitioner(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))
    for foreign in (mesh, object()):
        with pytest.raises(NotImplementedError, match="ROADMAP item 15"):
            tstack.build_full_stack(system, cadences={**QUICK, "partitioner": foreign})
    services = tstack.build_full_stack(system, cadences={**QUICK,
                                                         "partitioner": get_partitioner()})
    assert services[ROSTER.index("generator")].partitioner == get_partitioner()


# --- the pattern recognizer's sources --------------------------------------

TRAIN = {"epochs": 1, "n_per_class": 2}


def test_pattern_recognizer_trains_saves_and_loads(tmp_path):
    ckpt = str(tmp_path / "pattern_cnn")
    trained = tstack._pattern_recognizer(30, {"checkpoint": ckpt, "train_kwargs": TRAIN},
                                         torch.device("cpu"))
    assert trained.trained and len(trained.history) == 1
    assert os.path.isfile(os.path.join(ckpt, "tensors.npz"))
    loaded = tstack._pattern_recognizer(30, {"checkpoint": ckpt}, torch.device("cpu"))
    assert loaded.trained and loaded.model_type == "cnn" and loaded.history == []
    assert loaded.params.keys() == trained.params.keys()
    for k in trained.params:
        assert torch.equal(loaded.params[k], trained.params[k]), k
    # the same draws give the same training
    again = tstack._pattern_recognizer(30, {"checkpoint": None, "train_kwargs": TRAIN},
                                       torch.device("cpu"))
    assert again.history == trained.history


def test_pattern_recognizer_untrained_matches_jax_flag():
    got = tstack._pattern_recognizer(60, {"checkpoint": None, "train_on_start": False},
                                     torch.device("cpu"))
    ref = jstack._pattern_recognizer(60, {"checkpoint": None, "train_on_start": False})
    assert got.trained is ref.trained is False and got.model_type == ref.model_type
    from ai_crypto_trader_tpu_torch.patterns.model import _build

    want = {k: v.shape for k, v in _build("cnn", device="cpu").named_parameters()}
    assert {k: v.shape for k, v in got.params.items()} == want


def _jax_checkpoint(path):
    import jax.numpy as jnp

    from ai_crypto_trader_tpu.patterns.model import _build

    tree = _build("cnn").init(jax.random.PRNGKey(0), jnp.zeros((2, 30, 5), jnp.float32), False)
    jcheckpoint.save_checkpoint(path, tree, metadata={"model_type": "cnn", "seq_len": 30})


def _damaged(path):
    os.makedirs(path)
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{not json")


def _wrong_seq_len(path):
    rec = tstack._pattern_recognizer(40, {"checkpoint": None, "train_on_start": False},
                                     torch.device("cpu"))
    save_checkpoint(path, rec.params, metadata={"model_type": "cnn", "seq_len": 40})


def _wrong_shapes(path):
    rec = tstack._pattern_recognizer(40, {"checkpoint": None, "train_on_start": False},
                                     torch.device("cpu"))
    save_checkpoint(path, rec.params, metadata={"model_type": "cnn"})


def _wrong_model(path):
    save_checkpoint(path, {"w": torch.zeros(3)}, metadata={"model_type": "transformer"})


@pytest.mark.parametrize("make", [_jax_checkpoint, _damaged, _wrong_seq_len, _wrong_shapes,
                                  _wrong_model])
def test_unusable_checkpoint_falls_through_to_training(tmp_path, caplog, make):
    ckpt = str(tmp_path / "pattern_cnn")
    make(ckpt)
    with caplog.at_level(logging.WARNING):
        rec = tstack._pattern_recognizer(30, {"checkpoint": ckpt, "train_kwargs": TRAIN},
                                         torch.device("cpu"))
    assert rec.trained and len(rec.history) == 1
    assert "unusable" in caplog.text and "falling back to startup training" in caplog.text
    # the port's checkpoint replaced it: the next start loads it
    again = tstack._pattern_recognizer(30, {"checkpoint": ckpt, "train_on_start": False},
                                       torch.device("cpu"))
    assert again.trained
    for k in rec.params:
        assert torch.equal(again.params[k], rec.params[k])


def test_untrained_service_tags_match_jax(systems):
    """The untrained branch's recognizer, as both packages' services publish
    it: every analysis tagged `model_status: "untrained"`."""
    statuses = {}
    for pkg, mod in (("jax", jstack), ("port", tstack)):
        system, ex, clock = build(pkg, systems=systems, hist=900, ticks=2)
        services = mod.build_full_stack(system, cadences=QUICK, nn=False, generator=False,
                                        evolver=False)
        asyncio.run(drive(system, ex, clock, 2))
        patterns = services[2]
        statuses[pkg] = sorted({a.get("model_status") for a in patterns.pattern_data.values()})
    assert statuses["port"] == statuses["jax"] == ["untrained"]


# --- a few ticks of the full stack against the JAX package's ---------------

def _cadences(pkg):
    cfg = PKGS[pkg]["config"]
    return {
        "patterns": {"checkpoint": None, "train_on_start": False},
        "social": {"cache_ttl_s": 120.0},
        "news": {"poll_interval_s": 180.0},
        "regime": {"interval_s": 240.0},
        "evolver": {"interval_s": 10_000.0, "min_candles": 128},
        "evolution_cfg": cfg.EvolutionParams(method="ga",
                                             ga=cfg.GAParams(population_size=8, generations=2)),
        "grid": {"order_size": 150.0, "lookback": 200},
        "dca": {"base_amount": 120.0, "interval_s": 240.0},
    }


def _full_stack_run(pkg, systems, jax_patterns=None):
    system, ex, clock = build(pkg, systems=systems)
    mod = jstack if pkg == "jax" else tstack
    services = mod.build_full_stack(system, grid_symbol="AAAUSDC", dca_symbol="BBBUSDC",
                                    nn=False, generator=False, cadences=_cadences(pkg))
    if pkg == "port":
        # the JAX package's random pattern weights, and its GA draws
        services[2].recognizer = convert.recognizer_from_flax(
            "cnn", jax_patterns.params, trained=False, device="cpu")
        services[4].evolver.draws = _jax_draws
    returns = asyncio.run(drive(system, ex, clock, TICKS))
    bus = system.bus
    return {"returns": returns, "status": system.status(), "keys": sorted(bus.keys("*")),
            "names": [s.name for s in services], "services": services,
            "fills": ex.fills, "balances": ex.get_balances(),
            "open_orders": ex.list_open_orders(),
            "closed": system.executor.closed_trades,
            "active": system.executor.snapshot_state()["active"],
            "heartbeats": sorted(system.heartbeats.health()),
            "grid": (bus.get("grid_orders_AAAUSDC"), bus.get("grid_profit_AAAUSDC")),
            "strategy_params": bus.get("strategy_params"),
            "social": [bus.get(f"social_history_{s}") for s in system.symbols],
            "news": [bus.get(f"news_analysis_{s}") for s in system.symbols],
            "regimes": [(bus.get(f"market_regime_{s}") or {}).get("regime")
                        for s in system.symbols]}


def _close(got, ref, path="", rtol=1e-5):
    """Equal, but floats within rtol (sizes, quantities, stops)."""
    if isinstance(ref, float) and isinstance(got, float):
        assert abs(got - ref) <= rtol * abs(ref) + 1e-9, (path, got, ref)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}", rtol)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{path}[{i}]", rtol)
    else:
        assert got == ref, (path, got, ref)


def test_full_stack_ticks_equal_jax(systems):
    ref = _full_stack_run("jax", systems)
    got = _full_stack_run("port", systems, jax_patterns=ref["services"][2].recognizer)
    assert got["names"] == ref["names"] == [n for n in ROSTER if n not in ("nn", "generator")]
    assert got["keys"] == ref["keys"]
    assert got["heartbeats"] == ref["heartbeats"]
    for k in ("social", "news", "regimes", "grid"):
        assert got[k] == ref[k], k
    for k in ("strategy_params", "returns", "status", "fills", "balances", "open_orders",
              "closed", "active"):
        _close(got[k], ref[k], k)
    evolver = ref["services"][4]
    assert [h["method"] for h in evolver.history] == ["ga"]
    assert got["services"][4].history == evolver.history
    assert ref["status"]["channels"].get("dca_purchases", 0) >= 1
    assert any(f["side"] == "BUY" for f in ref["fills"])
