"""The port's strategy evaluation, evolution and improvement
(strategy/evaluation.py, evolution.py, improver.py) against the JAX
package's, on the CPU.

Tolerances, and why:

  * `trade_metrics` and `adjust_for_regime` compute the same operations in
    the same precision (float64 NumPy; float32 on one value): exactly equal;
  * `cross_validate` and `compare_strategies`: regime labels and rankings
    equal; metrics within rtol 1e-5 — the folds' indicator tables round
    their EMAs as the port's `compute_indicators` does, a couple of ulps
    from the JAX package's, and the replay reads them;
  * the evolver's GA path on the JAX package's GA draws (`JaxDraws` of
    tests/test_torch_ga.py): the same best genome, history within rtol 1e-5
    (the GA's own parity rule, test_torch_ga.py);
  * its RL path on the JAX package's DQN draws (`JaxDraws` of
    tests/test_torch_rl.py): the action fractions within RL_FRAC_ATOL of
    JAX's — each package trains on its own indicator table, so a greedy
    action may differ at a near-tie of two Q values — and the nudged
    params within the float32 rounding that difference carries;
  * its LLM path (a fake backend, and the regime-table fallback) and the
    improver's history: equal payloads, metrics within rtol 1e-5.
"""

import asyncio
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ai_crypto_trader_tpu.backtest import strategy as jst  # noqa: E402
from ai_crypto_trader_tpu.config import EvolutionParams as JaxEvolutionParams  # noqa: E402
from ai_crypto_trader_tpu.config import GAParams as JaxGAParams  # noqa: E402
from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.shell.bus import EventBus  # noqa: E402
from ai_crypto_trader_tpu.shell.llm import LLMTrader as JaxLLMTrader  # noqa: E402
from ai_crypto_trader_tpu.strategy import evaluation as jev  # noqa: E402
from ai_crypto_trader_tpu.strategy import evolution as jevo  # noqa: E402
from ai_crypto_trader_tpu.strategy import improver as jimp  # noqa: E402
from ai_crypto_trader_tpu.strategy.registry import ModelRegistry as JaxRegistry  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import default_params  # noqa: E402
from ai_crypto_trader_tpu_torch.config import EvolutionParams, GAParams  # noqa: E402
from ai_crypto_trader_tpu_torch.rl import DQNConfig  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import evaluation as pev  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import evolution as pevo  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import improver as pimp  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry  # noqa: E402
from test_torch_ga import JaxDraws as JaxGADraws  # noqa: E402
from test_torch_rl import JaxDraws as JaxRLDraws  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
RL_FRAC_ATOL = 0.01


@pytest.fixture(scope="module")
def ohlcv():
    return {k: v for k, v in generate_ohlcv(n=4_000, seed=11).items() if k != "regime"}


def _trades(seed, n):
    rng = np.random.default_rng(seed)
    return [{"pnl": float(p), "symbol": s}
            for p, s in zip(rng.normal(5.0, 60.0, n), rng.choice(["A", "B", "C"], n))]


@pytest.mark.parametrize("n", [0, 1, 2, 40])
def test_trade_metrics_exactly_equal(n):
    trades = _trades(n, n)
    if n == 2:
        trades = [{"pnl": 10.0}, {"pnl": -4.0}]          # no symbol: "?"
    assert pev.trade_metrics(trades) == jev.trade_metrics(trades)
    assert pev.trade_metrics(trades, 5_000.0, 365.0) == jev.trade_metrics(trades, 5_000.0, 365.0)


def _close_metrics(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_cross_validate_against_jax(ohlcv, monkeypatch):
    params = jst.default_params()
    ref = jev.cross_validate(ohlcv, params, k=3)
    reads, real = [], pev.host_read
    monkeypatch.setattr(pev, "host_read", lambda t: reads.append(1) or real(t))
    got = pev.cross_validate(ohlcv, default_params(device="cpu"), k=3, device="cpu")
    assert len(reads) == 1
    assert [f["regime"] for f in got["folds"]] == [f["regime"] for f in ref["folds"]]
    assert [f["fold"] for f in got["folds"]] == [0, 1, 2]
    for g, r in zip(got["folds"], ref["folds"]):
        _close_metrics(g["metrics"], r["metrics"])
        assert g["metrics"]["total_trades"] == r["metrics"]["total_trades"]
    for k in ("mean_sharpe", "std_sharpe"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)
    assert got["regime_sharpe"].keys() == ref["regime_sharpe"].keys()
    assert any(f["metrics"]["total_trades"] > 0 for f in got["folds"])


def test_compare_strategies_against_jax(ohlcv, monkeypatch):
    pop = jst.sample_params(jax.random.PRNGKey(5), 6)
    named_j = {f"s{i}": jax.tree.map(lambda x, i=i: x[i], pop) for i in range(6)}
    named_j["default"] = jst.default_params()
    arrays = {k: v[:2_000] for k, v in ohlcv.items()}
    ref = jev.compare_strategies({k: jax.numpy.asarray(v) for k, v in arrays.items()}, named_j)
    named_p = {k: convert.params_from_numpy(jax.tree.map(np.asarray, v), device="cpu")
               for k, v in named_j.items()}
    reads, real = [], pev.host_read
    monkeypatch.setattr(pev, "host_read", lambda t: reads.append(1) or real(t))
    got = pev.compare_strategies(arrays, named_p, device="cpu")
    assert len(reads) == 1
    assert got["ranked"] == ref["ranked"] and got["best"] == ref["best"]
    for name in named_j:
        _close_metrics(got["table"][name], ref["table"][name])


@pytest.mark.parametrize("regime", ["bull", "bear", "ranging", "volatile", "unknown"])
def test_adjust_for_regime_exactly_equal(regime):
    pj = jst.sample_params(jax.random.PRNGKey(9), 4)
    ref = jevo.adjust_for_regime(pj, regime)
    got = pevo.adjust_for_regime(convert.params_from_numpy(jax.tree.map(np.asarray, pj),
                                                           device="cpu"), regime)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert pevo.REGIME_ADJUSTMENTS == jevo.REGIME_ADJUSTMENTS


def _evolvers(tmp_path, llm=None, draws=None):
    jcfg = JaxEvolutionParams(ga=JaxGAParams(population_size=6, generations=2))
    pcfg = EvolutionParams(ga=GAParams(population_size=6, generations=2))
    clock = lambda: 123.0  # noqa: E731
    buses = {"jax": EventBus(), "port": EventBus()}
    regs = {"jax": JaxRegistry(path=str(tmp_path / "j.json")),
            "port": ModelRegistry(path=str(tmp_path / "p.json"))}
    j = jevo.StrategyEvolver(buses["jax"], cfg=jcfg, registry=regs["jax"], now_fn=clock,
                             seed=2, **({"llm": llm("jax")} if llm else {}))
    p = pevo.StrategyEvolver(buses["port"], cfg=pcfg, registry=regs["port"], now_fn=clock,
                             seed=2, device="cpu", draws=draws,
                             **({"llm": llm("port")} if llm else {}))
    return j, p, buses, regs


def _jax_draws(method, seed):
    key = jax.random.PRNGKey(seed)
    if method == "ga":
        return JaxGADraws(key)
    return JaxRLDraws(key, DQNConfig(num_envs=16, rollout_len=8, learn_steps_per_iter=2), False)


def test_evolver_ga_path_on_jax_draws(ohlcv, tmp_path):
    """regime 'bear' dispatches to the GA: the same best genome (then the
    bear adjustment), the history within rtol, the same registry payload
    and hot-swap message, one device devices count."""
    arrays = {k: v[:1_500] for k, v in ohlcv.items()}
    j, p, buses, regs = _evolvers(tmp_path, draws=_jax_draws)
    qs = {k: b.subscribe("strategy_update") for k, b in buses.items()}
    ref = asyncio.run(j.evolve(arrays, regime="bear"))
    got = asyncio.run(p.evolve(arrays, regime="bear"))
    assert got["method"] == ref["method"] == "ga"
    assert got["detail"]["devices"] == 1
    for f in ref["params"]._fields:
        assert float(getattr(got["params"], f)) == float(getattr(ref["params"], f)), f
    for hg, hr in zip(got["detail"]["history"], ref["detail"]["history"]):
        for k in ("best_fitness", "mean_fitness", "diversity"):
            np.testing.assert_allclose(hg[k], hr[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert regs["port"].entries[got["version"]]["payload"] == \
        regs["jax"].entries[ref["version"]]["payload"]
    mg, mr = qs["port"].get_nowait()["data"], qs["jax"].get_nowait()["data"]
    assert {k: v for k, v in mg.items() if k != "version"} == \
        {k: v for k, v in mr.items() if k != "version"}
    assert buses["port"].get("strategy_params") == buses["jax"].get("strategy_params")


def test_evolver_rl_path_on_jax_draws(ohlcv, tmp_path, monkeypatch):
    """regime 'volatile' dispatches to the RL path: a DQN trained on the
    JAX package's draws, the greedy action census within RL_FRAC_ATOL, the
    nudged (then volatile-adjusted) params within what that carries; one
    read of the actions."""
    arrays = {k: v[:600] for k, v in ohlcv.items()}
    j, p, _, _ = _evolvers(tmp_path, draws=_jax_draws)
    ref = asyncio.run(j.evolve(arrays, regime="volatile"))
    reads, real = [], pevo.host_read
    monkeypatch.setattr(pevo, "host_read", lambda t: reads.append(1) or real(t))
    got = asyncio.run(p.evolve(arrays, regime="volatile"))
    assert got["method"] == ref["method"] == "rl" and len(reads) == 1
    for k in ("buy_frac", "sell_frac"):
        assert abs(got["detail"][k] - ref["detail"][k]) <= RL_FRAC_ATOL, k
    for f in ref["params"]._fields:
        np.testing.assert_allclose(float(getattr(got["params"], f)),
                                   float(getattr(ref["params"], f)), rtol=0.02, err_msg=f)


class _ParamsLLM:
    def __init__(self, reply):
        self.reply = reply

    def complete(self, prompt):
        assert "MARKET_DATA:" in prompt
        return self.reply


@pytest.mark.parametrize("reply", [
    json.dumps({"params": {"rsi_period": 17.4, "stop_loss": 99.0, "bogus": 1.0,
                           "take_profit": "x"}}),
    json.dumps({"decision": "HOLD"}),                  # no params: the regime table
    "not json",
])
def test_evolver_llm_path_against_jax(tmp_path, reply):
    """regime 'ranging' dispatches to the LLM: proposals clamped, or the
    regime-table fallback, then the ranging adjustment — exactly JAX's."""
    llm = lambda key: (JaxLLMTrader if key == "jax" else LLMTrader)(  # noqa: E731
        backend=_ParamsLLM(reply))
    j, p, buses, regs = _evolvers(tmp_path, llm=llm)
    ref = asyncio.run(j.evolve({}, regime="ranging"))
    got = asyncio.run(p.evolve({}, regime="ranging"))
    assert got["method"] == ref["method"] == "llm"
    assert got["detail"] == ref["detail"]
    for f in ref["params"]._fields:
        assert float(getattr(got["params"], f)) == float(getattr(ref["params"], f)), f
    assert buses["port"].get("strategy_params") == buses["jax"].get("strategy_params")


def test_evolver_default_llm_falls_back_and_gates(tmp_path):
    """The default `LLMTrader` (the deterministic backend) proposes no
    params: the regime table; good metrics skip the evolution."""
    _, p, buses, _ = _evolvers(tmp_path)
    j = jevo.StrategyEvolver(EventBus(), now_fn=lambda: 123.0)
    ref = asyncio.run(j.evolve({}, regime="ranging"))
    got = asyncio.run(p.evolve({}, regime="ranging"))
    assert got["detail"] == ref["detail"] == {"method": "llm", "fallback": "regime_table"}
    good = {"sharpe_ratio": 2.0, "max_drawdown_pct": 1.0, "win_rate": 60.0,
            "profit_factor": 2.0}
    assert asyncio.run(p.evolve({}, metrics=good)) == asyncio.run(j.evolve({}, metrics=good))
    for regime, hist in (("volatile", 0), ("bull", 5), ("bull", 20), ("bear", 0),
                         ("ranging", 50)):
        assert p.pick_method(regime, hist) == j.pick_method(regime, hist)
    for m in ({}, good, {"sharpe_ratio": 2.0, "max_drawdown_pct": 40.0}):
        assert p.needs_improvement(m) == j.needs_improvement(m)


def test_systematic_improver_history_against_jax(ohlcv, tmp_path):
    """Two iterations through the GA path ('bear') on JAX's draws: the same
    methods and iterations, evaluations within rtol, the same report."""
    arrays = {k: v[:1_500] for k, v in ohlcv.items()}
    j, p, _, _ = _evolvers(tmp_path, draws=_jax_draws)
    ji = jimp.SystematicImprover(j, cv_folds=2, max_iterations=2, target_sharpe=50.0)
    pi = pimp.SystematicImprover(p, cv_folds=2, max_iterations=2, target_sharpe=50.0)
    ref = asyncio.run(ji.improve(arrays, regime="bear"))
    got = asyncio.run(pi.improve(arrays, regime="bear"))
    assert got["iterations"] == ref["iterations"] == 2
    assert got["converged"] == ref["converged"]
    assert p.seed == j.seed == 2
    assert [h["method"] for h in pi.history] == [h["method"] for h in ji.history]
    for hg, hr in zip(pi.history, ji.history):
        for k in ("mean_sharpe", "std_sharpe"):
            np.testing.assert_allclose(hg["eval"][k], hr["eval"][k], rtol=RTOL, atol=ATOL)
        assert hg["eval"]["passes"] == hr["eval"]["passes"]
    for f in ref["params"]._fields:
        np.testing.assert_allclose(float(getattr(got["params"], f)),
                                   float(getattr(ref["params"], f)), rtol=RTOL, err_msg=f)
    rg, rr = pi.report(), ji.report()
    assert rg.keys() == rr.keys() and rg["methods_used"] == rr["methods_used"]


def test_evolver_refuses_a_mesh_partitioner(ohlcv):
    """JAX's MeshPartitioner is refused; the port's own (4 CPU shards)
    runs the GA, bit for bit as the single device on the same seed."""
    from ai_crypto_trader_tpu.parallel.partitioner import MeshPartitioner
    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner as PortMesh
    from ai_crypto_trader_tpu_torch.parallel import make_mesh

    window = {k: v[:400] for k, v in ohlcv.items()}
    mesh = MeshPartitioner(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))
    p = pevo.StrategyEvolver(EventBus(), partitioner=mesh, device="cpu")
    with pytest.raises(TypeError, match="not a partitioner"):
        p.optimize_with_ga(window, default_params(device="cpu"))
    runs = []
    for part in (None, PortMesh(make_mesh(4, devices=["cpu"] * 4))):
        ev = pevo.StrategyEvolver(EventBus(), partitioner=part, device="cpu")
        runs.append(ev.optimize_with_ga(window, default_params(device="cpu")))
    (b1, i1), (bm, im) = runs
    assert im["devices"] == 4 and i1["devices"] == 1 and im["history"] == i1["history"]
    for a, b in zip(bm, b1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _strategies():
    rng = np.random.default_rng(12)
    out = []
    for i, arch in enumerate(["trend_following", "mean_reversion", "breakout", "grid", "dca"]):
        trades = [{"pnl": float(p), "closed_at": float(c)}
                  for p, c in zip(rng.normal(1.0, 5.0, 40), rng.uniform(0, 86_400 * 3, 40))]
        out.append({"id": f"s{i}", "archetype": arch, "trades": trades,
                    "metrics": {"sharpe_ratio": float(rng.normal(1, 1)),
                                "max_drawdown_pct": float(rng.uniform(0, 40))},
                    "params": {"atr_multiplier": float(rng.uniform(1, 4))},
                    "avg_trades_per_hour": float(rng.uniform(0, 30))})
    return out


@pytest.mark.parametrize("hour", [None, 3, 15, 23])
def test_strategy_selector_equal(hour):
    """The host copy of `StrategySelector`: the same scores, selection and
    cooldown-guarded switching as the JAX package's."""
    from ai_crypto_trader_tpu.strategy.selection import StrategySelector as JaxSelector
    from ai_crypto_trader_tpu_torch.strategy import StrategySelector

    ctx = dict(regime="volatile", volatility=0.03, social_sentiment=0.7, hour_of_day=hour)
    clock = [1_000.0]
    sel = {"jax": JaxSelector(now_fn=lambda: clock[0]), "port": StrategySelector(
        now_fn=lambda: clock[0])}
    picks = {k: s.select(_strategies(), **ctx) for k, s in sel.items()}
    strip = lambda d: {k: v for k, v in d.items() if k != "_hourly_cache"}  # noqa: E731
    assert strip(picks["port"]) == strip(picks["jax"])
    for s in _strategies():
        assert sel["port"].score_strategy(s, **ctx) == sel["jax"].score_strategy(s, **ctx)
    for s in sel.values():
        s.record_switch("s0")
    clock[0] += 10.0
    assert sel["port"].should_switch(0.2, 0.9) == sel["jax"].should_switch(0.2, 0.9) is False
    clock[0] += 7_200.0
    assert sel["port"].should_switch(0.2, 0.9) == sel["jax"].should_switch(0.2, 0.9) is True


@pytest.mark.parametrize("decision", ["BUY", "SELL", "HOLD"])
def test_explain_signal_equal(decision, tmp_path):
    from ai_crypto_trader_tpu.strategy.explain import explain_signal as jax_explain
    from ai_crypto_trader_tpu_torch.strategy import explain_signal

    signal = {"symbol": "BTCUSDC", "decision": decision, "confidence": 0.8, "rsi": 31.0,
              "stoch_k": 85.0, "macd": 1.5, "avg_volume": 2e5, "trend": "uptrend",
              "trend_strength": 22.0}
    got = explain_signal(signal, out_dir=str(tmp_path / "port"))
    ref = jax_explain(signal)
    drop = lambda d: {k: v for k, v in d.items() if k not in ("generated_at", "artifact")}  # noqa: E731
    assert drop(got) == drop(ref)
    with open(got["artifact"]) as f:
        assert drop(json.load(f)) == drop(ref)
