"""The port's strategy-vs-market rollout, sweep and stress backtest against
the JAX package, on the CPU.

    rollout_candles ↔ sim.engine.rollout_candles (and FakeExchange);
    sweep ↔ sim.engine.sweep on JAX's GBM draws, handed over;
    backtest_under_stress ↔ sim.engine.backtest_under_stress, both
    dynamics, with and without a strategy population.

Tolerances.
  * The rollout on the same candles and knobs is bit for bit: fills, fill
    counts, the summary and the equity curve.  Two patterns are rounded
    once, as the fused multiply-adds XLA's CPU program forms: the EMA
    updates ``ema + α·(close − ema)`` and the protective prices
    ``entry·(1 ± pct·0.01)`` (XLA divides by the constant 100 as a
    multiply by float32(0.01) and fuses 1 ± that product).  The test's
    SL/TP are drawn so that one rounding, a true division, or an unfused
    reciprocal product each give another price: the knobs discriminate.
  * Against FakeExchange (a float64 host oracle driven through the same
    decisions), the JAX package's own bounds (tests/test_sim.py:364-406):
    times and sides equal, quantity rtol 1e-4, price 1e-5, fee 1e-3, final
    equity 1e-4.
  * `sweep` on handed-over draws: its candles within the GBM bound of
    tests/test_torch_sim.py (the two packages' ``exp`` and cumulative sums
    differ by ulps); its rollout bit for bit against JAX's
    `rollout_candles` on the sweep's own candles.
  * `backtest_under_stress` from the same candles (both packages'
    generators patched to give JAX's): signals equal, integer stats equal,
    float stats within rtol 1e-5, atol 1e-6 (`assert_stats_equal`'s
    tolerance, tests/test_torch_backtest.py: the indicator table's
    tolerances carried through the replay), the summary's quantiles within
    rtol 1e-5 of the final balances they are taken of.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.backtest import sample_params as jax_sample_params  # noqa: E402
from ai_crypto_trader_tpu.sim import engine as jengine  # noqa: E402
from ai_crypto_trader_tpu.sim import paths as jpaths  # noqa: E402
from ai_crypto_trader_tpu.sim import scenarios as jsc  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import engine as tbe  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import replay  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import engine  # noqa: E402
from test_sim import _oracle_run  # noqa: E402
from test_torch_sim import U, JaxMarketDraws  # noqa: E402

f32 = np.float32
PRESETS = jsc.preset_names()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _discriminating(rng, sign):
    """A percentage x in [0.5, 5) whose ``1 ± x/100`` comes out three ways
    in float32: rounded once from x·float32(0.01) (XLA's), from a true
    division, from an unfused product."""
    r = np.float64(f32(0.01))
    while True:
        x = f32(rng.uniform(0.5, 5.0))
        fused = f32(1.0 + sign * np.float64(x) * r)
        if fused != f32(1) + f32(sign) * (x / f32(100)) and \
                fused != f32(1) + f32(sign) * (x * f32(0.01)):
            return float(x)


_RNG = np.random.default_rng(4)
SL, TP = _discriminating(_RNG, -1), _discriminating(_RNG, 1)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_rollout_equal(got, ref):
    for k, v in ref["summary"].items():
        np.testing.assert_array_equal(_bits(got["summary"][k]), _bits(v), err_msg=k)
    np.testing.assert_array_equal(_bits(got["fills"]), _bits(ref["fills"]))
    np.testing.assert_array_equal(_bits(got["equity_curve"]), _bits(ref["equity_curve"]))


@pytest.mark.parametrize("preset", PRESETS)
def test_rollout_candles_bit_for_bit(preset):
    B, T = 8, 256
    sched = jsc.compile_schedules(preset, B, T, seed=3)
    candles = {k: np.asarray(v) for k, v in
               jpaths.gbm_candles(jax.random.PRNGKey(3), sched).items()}
    strat = jengine.default_strategy(sl_pct=SL, tp_pct=TP)
    fp = jengine.fill_params(max_fill_base=0.02)
    ref = jengine.rollout_candles(candles, schedule=sched, strategy=strat, fills_params=fp)
    got = engine.rollout_candles(candles, schedule=sched,
                                 strategy=convert.sim_strategy_from_jax(strat, device="cpu"),
                                 fills_params=convert.fill_params_from_jax(fp, device="cpu"),
                                 device="cpu")
    _assert_rollout_equal(got, ref)
    n = ref["summary"]["n_fills"]
    assert n.sum() >= 8 and ref["summary"]["entries"].sum() >= 4, "the rollout barely trades"
    stop_or_tp = ref["fills"][..., 1] > 0
    assert stop_or_tp.any(), "no protective order filled: the SL/TP prices are unchecked"


@pytest.mark.parametrize("preset,seed", [("vol_regime_shift", 5), ("liquidity_hole", 9)])
def test_rollout_matches_fake_exchange_trade_by_trade(preset, seed):
    T = 768
    sched = jsc.compile_schedules(preset, 1, T, seed=seed)
    candles = {k: np.asarray(v) for k, v in
               jpaths.gbm_candles(jax.random.PRNGKey(seed), sched).items()}
    strat = jengine.default_strategy(sl_pct=1.0, tp_pct=1.5)
    fee, cap, q0 = 0.001, 0.02, 10_000.0
    out = engine.rollout_candles(
        candles, schedule=sched, strategy=convert.sim_strategy_from_jax(strat, device="cpu"),
        fills_params=engine.fill_params(fee_rate=fee, max_fill_base=cap, device="cpu"),
        quote_balance=q0, device="cpu")
    s = out["summary"]
    n = int(s["n_fills"][0])
    assert s["dropped_fills"][0] == 0 and n >= 4
    oracle, oracle_eq, oracle_fees = _oracle_run(
        {k: candles[k][0] for k in candles}, np.asarray(sched.liquidity_mult[0]), fee, cap,
        q0, T, strat)
    assert n == len(oracle)
    for srow, orow in zip(out["fills"][0][:n], oracle):
        t_s, _tag, side_s, qty_s, price_s, fee_s = map(float, srow)
        t_o, side_o, qty_o, price_o, fee_o = orow
        assert (t_s, side_s) == (t_o, side_o), (srow, orow)
        np.testing.assert_allclose(qty_s, qty_o, rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(price_s, price_o, rtol=1e-5)
        np.testing.assert_allclose(fee_s, fee_o, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(s["fees"][0]), oracle_fees, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(s["final_equity"][0]), oracle_eq, rtol=1e-4)


@pytest.mark.parametrize("scenario,return_fills", [
    ("mixed", False), (["calm", "flash_crash", "liquidity_hole"], True), ("black_swan", False)])
def test_sweep_on_jax_draws(monkeypatch, scenario, return_fills):
    """One host read; labels and stats as JAX's; the candles within the GBM
    bound of JAX's on the same draws; the rollout over those candles bit
    for bit against JAX's `rollout_candles` on them."""
    B, T = 12, 256
    key = jax.random.PRNGKey(8)
    strat = jengine.default_strategy(sl_pct=SL, tp_pct=TP)
    kw = dict(scenario=scenario, num_scenarios=B, steps=T, seed=2)
    ref = jengine.sweep(key, strategy=strat, **kw)
    reads = []
    real = engine.host_read
    monkeypatch.setattr(engine, "host_read", lambda rb: reads.append(1) or real(rb))
    got = engine.sweep(JaxMarketDraws(key), strategy=convert.sim_strategy_from_jax(
        strat, device="cpu"), return_fills=return_fills, device="cpu", **kw)
    assert len(reads) == 1
    assert got["labels"] == ref["labels"]
    assert {k: v for k, v in got["stats"].items() if k != "wall_s"} == \
        {k: v for k, v in ref["stats"].items() if k != "wall_s"}
    assert set(got["summary"]) == set(ref["summary"])
    assert ("fills" in got) == return_fills and ("fills" in got["device"]) != return_fills

    # the candles: the GBM generator's bound (tests/test_torch_sim.py)
    cg = {k: v.numpy() for k, v in got["device"]["candles"].items()}
    cr = {k: np.asarray(v) for k, v in ref["device"]["candles"].items()}
    assert set(cg) == set(cr)
    sched, _ = engine.resolve_schedule(scenario, B, T, 2)
    rets = np.diff(np.log(cr["close"].astype(np.float64)), axis=-1, prepend=np.log(40_000.0))
    bound = (8.0 + (np.arange(T) + 1) * np.cumsum(np.abs(rets), axis=-1)) * U
    for k in ("open", "high", "low", "close"):
        rel = np.abs(cg[k].astype(np.float64) - cr[k]) / np.abs(cr[k])
        assert (rel <= bound).all(), (k, float((rel / bound).max()))

    # the rollout on the sweep's own candles: JAX's bit for bit
    jr = jengine.rollout_candles(cg, schedule=sched, strategy=strat)
    for k, v in jr["summary"].items():
        np.testing.assert_array_equal(_bits(got["summary"][k]), _bits(v), err_msg=k)
    np.testing.assert_array_equal(_bits(got["device"]["equity_curve"].numpy()),
                                  _bits(jr["equity_curve"]))
    fills = got["fills"] if return_fills else got["device"]["fills"].numpy()
    np.testing.assert_array_equal(_bits(fills), _bits(jr["fills"]))
    assert got["summary"]["n_fills"].sum() > 0


def _same_candles(monkeypatch, key, B, T, dynamics):
    """Both packages' stress generators patched to JAX's candles for this
    key: the port's backtest then runs on exactly JAX's markets."""
    sched, _ = jsc.mixed_schedules(None, B, T, seed=0)
    candles = {k: np.asarray(v) for k, v in
               jengine._stress_candles(key, sched, dynamics, None).items()}
    monkeypatch.setattr(engine, "_stress_candles", lambda *a, **k: {
        c: torch.from_numpy(v.copy()) for c, v in candles.items()})
    return candles


@pytest.mark.parametrize("dynamics,mode", [("gbm", "ladder"), ("gbm", "population"),
                                           ("lob", "ladder"), ("lob", "population"),
                                           ("gbm", "one")])
def test_backtest_under_stress_matches_jax(monkeypatch, dynamics, mode):
    B, T, P = 4, 320, 5
    key = jax.random.PRNGKey(20)
    jparams = None
    if mode == "population":
        jparams = jax_sample_params(jax.random.PRNGKey(0), P)
    elif mode == "one":
        jparams = jax.tree.map(lambda x: x[0], jax_sample_params(jax.random.PRNGKey(1), 2))
    kw = dict(scenario="mixed", num_scenarios=B, steps=T, dynamics=dynamics)
    jstats, jsum = jengine.backtest_under_stress(key, params=jparams, **kw)
    _same_candles(monkeypatch, key, B, T, dynamics)
    tparams = None if jparams is None else convert.params_from_numpy(jparams, device="cpu")
    reads = []
    real = engine.host_read
    monkeypatch.setattr(engine, "host_read", lambda rb: reads.append(1) or real(rb))
    stats, summary = engine.backtest_under_stress(JaxMarketDraws(key), params=tparams,
                                                  device="cpu", **kw)
    assert len(reads) == 1
    shape = (B, P) if mode == "population" else (B,)
    for f in jstats._fields:
        g, r = getattr(stats, f).numpy(), np.asarray(getattr(jstats, f))
        assert g.shape == r.shape == shape, f
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=f)
    assert int(np.asarray(jstats.total_trades).sum()) > 0, "no trades: the comparison is vacuous"
    assert summary["labels"] == jsum["labels"]
    for k, v in jsum.items():
        if k != "labels":
            np.testing.assert_allclose(summary[k], v, rtol=1e-5, err_msg=k)


def test_stress_signals_equal_jax(monkeypatch):
    """The stress program's inputs — the reference signal over the [B, T]
    indicator table — equal JAX's on the same candles."""
    from ai_crypto_trader_tpu import ops as jops
    from ai_crypto_trader_tpu.backtest import signals as jsig

    B, T = 4, 320
    candles = _same_candles(monkeypatch, jax.random.PRNGKey(20), B, T, "gbm")
    ohlcv = {k: candles[k] for k in ("open", "high", "low", "close", "volume")}
    jfeats = jsig.compute_signal_features(jops.compute_indicators(
        {k: jnp.asarray(v) for k, v in ohlcv.items()}))
    jsignal, _ = jsig.reference_signal(jfeats)
    inp = engine.stress_inputs({k: torch.from_numpy(v.copy()) for k, v in ohlcv.items()},
                               device="cpu")
    np.testing.assert_array_equal(inp.signal.numpy(), np.asarray(jsignal))
    assert (inp.signal.numpy() == 1).sum() > 0 and torch.isnan(inp.sl_pct).all()


@pytest.mark.parametrize("mode", ["population", "one"])
def test_stress_k1_is_one_launch_per_scenario(monkeypatch, mode):
    """Routed through `run_backtest`'s launching branch (the `launches_kernel`
    seam) to a stub kernel on the CPU: one call per scenario, each with the
    P strategies as its rows — never B·P calls — and the stats equal to the
    plain loop's over the whole [B, P] at once."""
    B, T, P = 5, 256, 3
    g = torch.Generator().manual_seed(0)
    from ai_crypto_trader_tpu_torch.backtest import sample_params
    from ai_crypto_trader_tpu_torch.data import generate_ohlcv

    d = generate_ohlcv(n=T, seed=list(range(30, 30 + B)))
    inputs = engine.stress_inputs({k: torch.from_numpy(d[k]) for k in
                                   ("open", "high", "low", "close", "volume")}, device="cpu")
    params = sample_params(g, P, device="cpu")
    if mode == "one":
        params = type(params)(*(x[0] for x in params))
    plain = engine.stress_backtest(inputs, params, device="cpu")
    calls = []

    def stub(rows, p, return_curve=False, device=None, **kw):
        assert rows.close.ndim == 1 and rows.volume.ndim == 1
        calls.append(tuple(p.stop_loss.shape))
        return tbe.sweep(rows, p, device="cpu", **kw)

    monkeypatch.setattr(tbe, "launches_kernel", lambda dev: True)
    monkeypatch.setattr(replay, "sweep_kernel", stub)
    routed = engine.stress_backtest(inputs, params, device="cpu")
    assert calls == [(P,) if mode == "population" else (1,)] * B
    for f in plain._fields:
        np.testing.assert_array_equal(getattr(routed, f).numpy(), getattr(plain, f).numpy(),
                                      err_msg=f)
    assert int(plain.total_trades.sum()) > 0
