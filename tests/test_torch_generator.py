"""The port's strategy-structure search (strategy/generator.py) against the
JAX package's, on the CPU.

Tolerances, and why:

  * structures, payloads, weight vectors, mutations and the LLM proposer's
    parsing are host code: exactly equal;
  * `fold_features`: close and avg_volume exactly; volatility (ATR/close)
    within 1e-6 of its scale; the score stack within STACK_ATOL = 5e-4 —
    its MACD, RSI and ATR terms inherit the indicator table's EMA rounding
    (a couple of ulps of a 40,000 price, up to ~1.1e-4 through
    tanh(MACD/close · 1e3) · 0.5 at these sizes);
  * `evaluate_structures` on the JAX package's own fold features: a signal
    may differ only where JAX's blend lies within FLIP_ULPS = 8 ulps of a
    threshold (its blend is a dot product, the port's 15 multiply-adds in
    rule order); a candidate with no such flip has the same trade count on
    every fold and its Sharpe within rtol 1e-5 (the replay's float32
    rounding; both read the same candles); -inf where JAX has -inf;
  * a whole `StrategyGenerator.generate`, `GeneratorService.run_once` and
    `cli generate`: the same history (sources, adopted flags, payloads),
    versions and JSON keys; scores within rtol 1e-5.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.shell.bus import EventBus  # noqa: E402
from ai_crypto_trader_tpu.shell.llm import LLMTrader as JaxLLMTrader  # noqa: E402
from ai_crypto_trader_tpu.strategy import generator as J  # noqa: E402
from ai_crypto_trader_tpu.strategy.registry import ModelRegistry as JaxRegistry  # noqa: E402
from ai_crypto_trader_tpu_torch.shell.llm import LLMTrader  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy import generator as P  # noqa: E402
from ai_crypto_trader_tpu_torch.strategy.registry import ModelRegistry  # noqa: E402

STACK_ATOL = 5e-4
FLIP_ULPS = 8
SHARPE_RTOL, SHARPE_ATOL = 1e-5, 1e-6
FIELDS = ("rules", "buy_threshold", "sell_threshold", "stop_loss", "take_profit", "name")


@pytest.fixture(scope="module")
def ohlcv():
    return generate_ohlcv(n=4_000, seed=11)


@pytest.fixture(scope="module")
def arrays(ohlcv):
    return {k: np.asarray(v) for k, v in ohlcv.items() if k != "regime"}


@pytest.fixture(scope="module")
def jax_folds(arrays):
    return [J.fold_features({k: v[i * 1_400:(i + 1) * 1_400] for k, v in arrays.items()})
            for i in range(2)]


def _port(s):
    return P.StrategyStructure(**{f: getattr(s, f) for f in FIELDS})


def _weak(mod):
    return mod.StrategyStructure(rules=(("divergence_detector", 0.2),),
                                 buy_threshold=0.6, sell_threshold=0.6, name="weak_seed")


_PAYLOADS = [
    {"rules": {"oscillator_consensus": 1.5, "trend_confirmation": -0.5},
     "buy_threshold": 0.25, "stop_loss": 3.0},
    {"rules": {"no_such_rule": 1.0, "stoch_rsi": 99.0}, "buy_threshold": 5.0,
     "stop_loss": -3.0},
    {"rules": [{"name": "double_rsi", "weight": 0.7}, {"name": "stoch_rsi"}, "junk"]},
    {"rules": {"bogus": 1.0}},
    {"rules": "garbage"},
    {"rules": {"double_rsi": float("nan"), "divergence_detector": 0.3},
     "take_profit": "high", "sell_threshold": float("nan"), "name": "x" * 80},
]


@pytest.mark.parametrize("payload", _PAYLOADS, ids=range(len(_PAYLOADS)))
def test_structure_payload_validation_and_weights(payload):
    ref, got = J.StrategyStructure.from_payload(payload), P.StrategyStructure.from_payload(payload)
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert got == _port(ref)
    assert got.to_payload() == ref.to_payload()
    assert P.StrategyStructure.from_payload(got.to_payload()).to_payload() == got.to_payload()
    np.testing.assert_array_equal(got.weight_vector(), ref.weight_vector())
    assert P.RULE_NAMES == J.RULE_NAMES and P._CENTERED == J._CENTERED
    assert P.default_seed() == _port(J.default_seed())


def test_fold_features_against_jax(arrays):
    fold = {k: v[:1_400] for k, v in arrays.items()}
    ref = J.fold_features(fold)
    got = P.fold_features(fold, device="cpu")
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["close"].numpy(), np.asarray(ref["close"]))
    assert got["avg_volume"].dtype == torch.float32 and got["avg_volume"].shape == ()
    assert float(got["avg_volume"]) == float(ref["avg_volume"])
    np.testing.assert_allclose(got["volatility"].numpy(), np.asarray(ref["volatility"]),
                               rtol=1e-6, atol=1e-9)
    assert got["stack"].shape == (15, 1_400)
    np.testing.assert_allclose(got["stack"].numpy(), np.asarray(ref["stack"]),
                               rtol=0, atol=STACK_ATOL)


def _structures():
    rng = np.random.default_rng(0)
    out = [J.default_seed()] + [J.mutate(rng, J.default_seed(), 1) for _ in range(5)]
    # never trades: a blend in [-1, 1] cannot reach a 2.0 threshold
    out.append(J.StrategyStructure(rules=(("trend_confirmation", 1.0),),
                                   buy_threshold=2.0, sell_threshold=2.0))
    out.append(J.StrategyStructure(rules=(("triple_moving_average", -1.0),),
                                   buy_threshold=0.1, sell_threshold=0.1))
    return out


def test_evaluate_structures_on_jax_folds(jax_folds, monkeypatch):
    """Per fold: signals against JAX's blend (flips only within FLIP_ULPS of
    a threshold), trades equal and Sharpe within rtol where nothing
    flipped; the call's mean Sharpe, -inf included; one host read."""
    structures = _structures()
    reads = []
    real = P.host_read
    monkeypatch.setattr(P, "host_read", lambda t: reads.append(1) or real(t))
    folds_np = [{k: np.asarray(v) for k, v in f.items()} for f in jax_folds]
    got = P.evaluate_structures(folds_np, [_port(s) for s in structures], device="cpu")
    assert len(reads) == 1
    ref = J.evaluate_structures(jax_folds, structures)
    assert got.dtype == ref.dtype and got.shape == ref.shape

    W = jnp.asarray(np.stack([s.weight_vector() for s in structures]))
    flipped = np.zeros(len(structures), bool)
    cand = P._candidates([_port(s) for s in structures], torch.device("cpu"))
    for f in jax_folds:
        blend_j = np.asarray(jax.jit(jax.vmap(
            lambda w: (w @ f["stack"]) / jnp.maximum(jnp.sum(jnp.abs(w)), 1e-9)))(W))
        _, sig_p, _ = P.blend_signals(torch.from_numpy(np.array(f["stack"]))[None], *cand[:4])
        for i, s in enumerate(structures):
            sig_j = np.where(blend_j[i] >= np.float32(s.buy_threshold), 1,
                             np.where(blend_j[i] <= -np.float32(s.sell_threshold), -1, 0))
            diff = np.flatnonzero(sig_j != sig_p[0, i].numpy())
            thr = np.asarray([s.buy_threshold, -s.sell_threshold], np.float32)
            for t in diff:
                margin = np.abs(blend_j[i, t] - thr).min()
                assert margin <= FLIP_ULPS * np.spacing(np.abs(thr).max()), (i, t, margin)
            flipped[i] |= len(diff) > 0
        sh_j, tr_j = (np.asarray(x) for x in J._eval_batch(
            f["stack"], f["close"], f["volatility"], f["avg_volume"], W,
            *(jnp.asarray([getattr(s, k) for s in structures], jnp.float32)
              for k in ("buy_threshold", "sell_threshold", "stop_loss", "take_profit"))))
        sh_p, tr_p = P._eval_lanes([{k: torch.from_numpy(np.array(v)) for k, v in f.items()}],
                                   cand)
        ok = ~flipped
        np.testing.assert_array_equal(tr_p[0].numpy()[ok], tr_j[ok])
        np.testing.assert_allclose(sh_p[0].numpy()[ok], sh_j[ok], rtol=SHARPE_RTOL,
                                   atol=SHARPE_ATOL)
    ok = ~flipped
    assert ok.sum() >= len(structures) - 2, "too many candidates flipped to hold them"
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    assert got[6] == ref[6] == -np.inf
    np.testing.assert_allclose(got[ok], ref[ok], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)


def test_evaluate_structures_folds_of_two_lengths(jax_folds):
    """Folds of different lengths replay in one loop per length, and the
    scores land where each fold belongs."""
    structures = [_port(s) for s in _structures()[:3]]
    short = {k: (np.asarray(v)[..., :700] if k != "avg_volume" else np.asarray(v))
             for k, v in jax_folds[1].items()}
    folds = [jax_folds[0], short, jax_folds[1]]
    folds = [{k: np.asarray(v) for k, v in f.items()} for f in folds]
    both = P.evaluate_structures(folds, structures, device="cpu")
    parts = [P.evaluate_structures([f], structures, device="cpu") for f in folds]
    np.testing.assert_allclose(both, np.mean(parts, axis=0, dtype=np.float32),
                               rtol=1e-6)


def test_replay_carry_takes_every_streams_leading_shape(jax_folds):
    """`engine.replay` with no params, a shared [T] close and [F, N, T]
    signals: the carry is [F, N] from the first candle (the equity curve
    too), and each lane equals its own one-lane replay."""
    from ai_crypto_trader_tpu_torch.backtest.engine import BacktestInputs, replay

    structures = [_port(s) for s in _structures()[:4]]
    f = {k: torch.from_numpy(np.array(v)) for k, v in jax_folds[0].items()}
    cand = P._candidates(structures, torch.device("cpu"))
    _, signal, strength = P.blend_signals(f["stack"][None], *cand[:4])
    T = f["close"].shape[-1]
    ones = torch.ones(T)

    def inputs(sig, st, sl, tp):
        return BacktestInputs(close=f["close"], signal=sig, strength=st,
                              volatility=f["volatility"], volume=ones * f["avg_volume"],
                              confidence=ones, decision=sig, sl_pct=sl, tp_pct=tp)

    kw = dict(min_signal_strength=0.0, warmup=50, sell_exits=True, return_curve=True)
    sl, tp = cand[4][:, None].expand(-1, T), cand[5][:, None].expand(-1, T)
    stats, curve = replay(inputs(signal, strength, sl, tp), **kw)
    assert stats.final_balance.shape == (1, 4) and curve.shape == (1, 4, T)
    for i in range(4):
        one, one_curve = replay(inputs(signal[0, i], strength[0, i], sl[i], tp[i]), **kw)
        for name, v in one._asdict().items():
            assert torch.equal(getattr(stats, name)[0, i], v), name
        assert torch.equal(curve[0, i], one_curve)
    assert int(stats.total_trades.sum()) > 0


def test_blend_signal_agrees_with_the_batched_path(arrays):
    """`blend_signal` (the host's scalar twin, rounding the blend to 4
    decimals) against the batched blend on the same candles: the blends
    within half a unit of the 4th decimal, the signals equal wherever the
    batched blend is farther than that from a threshold; and equal to the
    JAX package's `blend_signal`."""
    from ai_crypto_trader_tpu_torch.ops import combined_indicators, compute_indicators

    fold = {k: v[:600] for k, v in arrays.items()}
    combos = combined_indicators(compute_indicators(fold, device="cpu"))
    stack = P.fold_features(fold, device="cpu")["stack"]
    structures = [_port(s) for s in _structures()[:6]]
    cand = P._candidates(structures, torch.device("cpu"))
    blend, signal, _ = P.blend_signals(stack[None], *cand[:4])
    names = {1: "BUY", -1: "SELL", 0: "NEUTRAL"}
    jax_structures = _structures()[:6]
    for t in range(60, 600, 7):
        scores = {n: float(combos[n][t]) for n in P.RULE_NAMES}
        for i, s in enumerate(structures):
            b, name = s.blend_signal(scores)
            assert (b, name) == jax_structures[i].blend_signal(scores)
            assert abs(b - float(blend[0, i, t])) <= 5e-5 + 1e-7
            far = min(abs(float(blend[0, i, t]) - s.buy_threshold),
                      abs(float(blend[0, i, t]) + s.sell_threshold)) > 1e-4
            if far:
                assert name == names[int(signal[0, i, t])], (t, i)


def test_mutate_equal_on_the_same_seed():
    rj, rp = np.random.default_rng(7), np.random.default_rng(7)
    bj, bp = J.default_seed(), P.default_seed()
    for r in range(40):
        mj, mp = J.mutate(rj, bj, r), P.mutate(rp, bp, r)
        assert mp == _port(mj)
        bj, bp = (mj, mp) if r % 3 == 0 else (bj, bp)


class _Canned:
    def __init__(self, reply):
        self.reply, self.prompts = reply, []

    def complete(self, prompt):
        self.prompts.append(prompt)
        if isinstance(self.reply, Exception):
            raise self.reply
        return self.reply


_REPLIES = {
    "two_structures": json.dumps({"structures": [
        {"rules": {"stoch_rsi": 1.2, "bogus_rule": 3.0}, "buy_threshold": 0.2,
         "stop_loss": 1.5},
        {"rules": {}}]}),
    "five_of_four": json.dumps({"structures": [
        {"rules": {"double_rsi": 0.1 * i}, "take_profit": 30.0} for i in range(1, 6)]}),
    "not_json": "sure! here you go",
    "structures_null": json.dumps({"structures": None}),
    "structures_dict": json.dumps({"structures": {"rules": {"stoch_rsi": 1.0}}}),
    "items_not_dicts": json.dumps({"structures": [1, "x", None, {"rules": {"stoch_rsi": 1}}]}),
    "backend_down": RuntimeError("down"),
}


@pytest.mark.parametrize("case", sorted(_REPLIES))
def test_llm_proposer_against_jax(case):
    """The same prompt, and the same structures (names included) parsed
    from canned and malformed replies; a failing backend gives []."""
    outs, prompts = {}, {}
    for key, trader, mod in (("jax", JaxLLMTrader, J), ("port", LLMTrader, P)):
        backend = _Canned(_REPLIES[case])
        proposer = mod.LLMStructureProposer(llm=trader(backend=backend))
        outs[key] = asyncio.run(proposer.propose(mod.default_seed(), {"cv_sharpe": 0.1}, 2))
        prompts[key] = backend.prompts
    assert prompts["port"] == prompts["jax"]
    assert outs["port"] == [_port(s) for s in outs["jax"]]
    if case == "two_structures":
        assert [s.name for s in outs["port"]] == ["llm_r2_0"]


def _same_history(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            if k == "cv_sharpe":
                np.testing.assert_allclose(g[k], r[k], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)
            else:
                assert g[k] == r[k], k


def test_generate_whole_run_against_jax(ohlcv, tmp_path):
    """One whole search from a weak seed: the same rounds, pools, adopted
    flags and payloads, scores within rtol, the same registered versions
    (the port's registry file loads in the JAX package's registry)."""
    runs = {}
    for key, mod, reg, kw in (("jax", J, JaxRegistry, {}),
                              ("port", P, ModelRegistry, {"device": "cpu"})):
        registry = reg(path=str(tmp_path / f"{key}.json"))
        gen = mod.StrategyGenerator(registry=registry, cv_folds=2, pool_size=5, max_rounds=2,
                                    patience=2, seed=3, **kw)
        runs[key] = (asyncio.run(gen.generate(ohlcv, seed_structure=_weak(mod))), gen, registry)
    (out, gen, reg), (ref, jgen, jreg) = runs["port"], runs["jax"]
    _same_history(gen.history, jgen.history)
    assert out["structure"] == _port(ref["structure"])
    assert out["rounds"] == ref["rounds"] >= 1
    for k in ("cv_sharpe", "seed_cv_sharpe", "holdout_sharpe_seed", "holdout_sharpe_best"):
        np.testing.assert_allclose(out[k], ref[k], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)
    assert len(out["versions"]) == len(ref["versions"]) >= 2
    loaded = JaxRegistry(path=str(tmp_path / "port.json"))
    assert [loaded.entries[v]["payload"] for v in out["versions"]] == \
        [jreg.entries[v]["payload"] for v in ref["versions"]]
    assert gen.report().keys() == jgen.report().keys()
    assert gen.report()["sources"] == jgen.report()["sources"]


def test_generate_refuses_a_mesh_partitioner():
    """JAX's MeshPartitioner is refused; the port's (3 CPU shards) scores
    the pool as the single device does."""
    from ai_crypto_trader_tpu.parallel.partitioner import MeshPartitioner
    from ai_crypto_trader_tpu_torch.parallel import MeshPartitioner as PortMesh
    from ai_crypto_trader_tpu_torch.parallel import make_mesh

    mesh = MeshPartitioner(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))
    folds = [{k: np.zeros(64 if k != "stack" else (15, 64), np.float32)
              for k in ("stack", "close", "volatility")} | {"avg_volume": np.float32(1)}]
    with pytest.raises(TypeError, match="not a partitioner"):
        P.evaluate_structures(folds, [P.default_seed()], partitioner=mesh, device="cpu")
    pool = [_port(s) for s in _structures()]
    port = PortMesh(make_mesh(3, devices=["cpu"] * 3))
    np.testing.assert_array_equal(
        P.evaluate_structures(folds, pool, partitioner=port, device="cpu"),
        P.evaluate_structures(folds, pool, device="cpu"))


def _klines(d):
    ts = np.arange(len(d["close"])) * 60_000.0
    return [[float(t), float(o), float(h), float(lo), float(c), float(v)]
            for t, o, h, lo, c, v in zip(ts, d["open"], d["high"], d["low"],
                                         d["close"], d["volume"])]


def test_generator_service_on_the_jax_bus(ohlcv, tmp_path):
    """`GeneratorService` on the JAX package's EventBus: the insufficient-
    history and interval gates, then a scheduled run that adopts, with both
    hot-swap surfaces (the structure, the live params' exits) and their
    published messages as the JAX service makes them."""
    outs = {}
    for key, mod, reg, kw in (("jax", J, JaxRegistry, {}),
                              ("port", P, ModelRegistry, {"device": "cpu"})):
        bus, clock = EventBus(), {"t": 0.0}
        rows = _klines(ohlcv)
        bus.set("strategy_params", {"stop_loss": 9.0, "take_profit": 9.0, "risk": 1})
        registry = reg(path=str(tmp_path / f"svc_{key}.json"))
        svc = mod.GeneratorService(bus, "BTCUSDC", registry=registry, interval_s=3600.0,
                                   min_candles=1_333, cv_folds=2, pool_size=5, max_rounds=2,
                                   seed=3, now_fn=lambda c=clock: c["t"],
                                   current=_weak(mod), **kw)
        queues = {ch: bus.subscribe(ch) for ch in ("strategy_structure_update",
                                                    "strategy_update")}
        bus.set("historical_data_BTCUSDC_1m", rows[:1_000])
        gated = [asyncio.run(svc.run_once())]
        bus.set("historical_data_BTCUSDC_1m", rows)
        ran = asyncio.run(svc.run_once())
        gated.append(asyncio.run(svc.run_once()))
        msgs = {ch: q.get_nowait()["data"] for ch, q in queues.items()}
        outs[key] = (gated, ran, bus, registry, msgs, svc)
    (gated, ran, bus, reg, msgs, svc), (jgated, jran, jbus, jreg, jmsgs, jsvc) = \
        outs["port"], outs["jax"]
    assert gated == jgated == [{"ran": False, "reason": "insufficient_history"},
                               {"ran": False, "reason": "interval_gate"}]
    assert ran["ran"] and ran["adopted"] and jran["adopted"]
    assert reg.entries[ran["version"]]["status"] == "active"
    assert reg.entries[ran["version"]]["payload"] == jreg.entries[jran["version"]]["payload"]
    strip = lambda d: {k: v for k, v in d.items() if k != "version"}  # noqa: E731
    assert strip(bus.get("strategy_structure")) == strip(jbus.get("strategy_structure"))
    assert bus.get("strategy_structure")["version"] == ran["version"]
    assert bus.get("strategy_params") == jbus.get("strategy_params")
    assert bus.get("strategy_params")["risk"] == 1
    assert strip(msgs["strategy_update"]) == strip(jmsgs["strategy_update"])
    assert msgs["strategy_structure_update"]["structure"] == \
        jmsgs["strategy_structure_update"]["structure"]
    np.testing.assert_allclose(msgs["strategy_structure_update"]["holdout_sharpe"],
                               jmsgs["strategy_structure_update"]["holdout_sharpe"],
                               rtol=SHARPE_RTOL)
    assert svc.current == _port(jsvc.current)
    assert len(svc._history) == len(jsvc._history) == len(ohlcv["close"]) - 1


def test_cli_generate_against_jax(tmp_path, capsys):
    """`cli generate --device cpu` prints the JAX package's JSON keys and
    values (scores within rtol) for the same arguments."""
    from ai_crypto_trader_tpu import cli as jcli
    from ai_crypto_trader_tpu_torch import cli

    argv = ["generate", "--days", "2", "--folds", "2", "--pool", "4", "--rounds", "1"]
    # the parsed command alone: `jcli.main` would switch on the persistent
    # compilation cache for the whole test process
    args = jcli.build_parser().parse_args(argv + ["--registry", str(tmp_path / "j.json")])
    args.fn(args)
    ref = json.loads(capsys.readouterr().out)
    cli.main(argv + ["--registry", str(tmp_path / "p.json"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out.keys() == ref.keys()
    assert out["best_structure"] == ref["best_structure"]
    assert out["rounds"] == ref["rounds"] and len(out["versions"]) == len(ref["versions"])
    for k in ("cv_sharpe", "seed_cv_sharpe", "holdout_sharpe_seed", "holdout_sharpe_best"):
        assert (out[k] is None) == (ref[k] is None), k
        if ref[k] is not None:
            np.testing.assert_allclose(out[k], ref[k], rtol=SHARPE_RTOL, atol=SHARPE_ATOL)
