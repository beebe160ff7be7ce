"""The port's simulated markets against the JAX package, on the CPU.

    regime_chain ↔ sim.paths.regime_chain (exact);  gbm_candles ↔ the JAX
    generator on its own draws, handed over;  flow_step and lob_candles ↔
    sim.lob on the same draws;  scenario_env_params ↔ sim.engine's, for
    both dynamics.

Tolerances, all derived from float32's unit roundoff u = 2^-24:
  * GBM prices: relative (4 + (t + 1)·S_t)·u at candle t, S_t the sum of
    |log-return| so far — the cumulative sum's worst-case reordering error
    (JAX sums as `lax.associative_scan`'s tree) plus ``exp``'s ulp in each
    package and the product's rounding; volume 8u relative (one ``exp`` and
    two products each side);
  * the order-flow book: the mid path (open, close) relative 4·(t + 1)·u at
    step t (each step an ``exp`` that may differ by an ulp in each package
    and the product's rounding), over the whole run.  The grid roll ``m =
    round((mid'/mid − 1)/tick)`` may flip by a tick where that ratio is
    within a few ulps of a half tick: every flip is reported, and each must
    be within 4 ulps of the ratio (4·2^-23/tick ≈ 4.8e-3 ticks) of a half
    tick.  Up to a scenario's first flip: high and low within the mid's
    bound plus 4u; volume and the touch depth within L·u·D absolute, D the
    steady book's total depth (one 32-level cumulative sum's worst-case
    reordering error); the spread bit for bit;
  * one `flow_step`: 1e-6 relative (sizes: 1e-6 of the steady depth), the
    roll ``m`` equal;
  * the env table built from the same candles: the columns no indicator
    feeds bit for bit, the indicator columns within the indicator table's
    tolerances (tests/test_torch_indicators.py) carried through each
    column's scale, and the Bollinger position within the std's rounding
    (derived in the test).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.ops import compute_indicators as jax_indicators  # noqa: E402
from ai_crypto_trader_tpu.rl import env as jenv  # noqa: E402
from ai_crypto_trader_tpu.sim import engine as jengine  # noqa: E402
from ai_crypto_trader_tpu.sim import lob as jlob  # noqa: E402
from ai_crypto_trader_tpu.sim import paths as jpaths  # noqa: E402
from ai_crypto_trader_tpu.sim import scenarios as jsc  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import engine, lob, paths  # noqa: E402

U = 2.0 ** -24
L = lob.DEFAULT_LEVELS
TICK = np.float32(1e-4)
FLIP_TICKS = 4 * 2.0 ** -23 / 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flow_draws(key, B, T):
    """`lob_candles`' per-step draws of the JAX program: scenario b's step
    keys ``split(fold_in(key, b), T)``, each split into (mid, arrivals,
    cancels, market) and the market key into (buy, sell, buy size, sell
    size)."""
    def one(b):
        def step(kt):
            k_mid, k_arr, k_can, k_mkt = jax.random.split(kt, 4)
            k_b, k_s, k_bs, k_ss = jax.random.split(k_mkt, 4)
            return (jax.random.normal(k_mid), jax.random.normal(k_arr, (2, L)),
                    jax.random.uniform(k_can, (2, L)), jax.random.uniform(k_b),
                    jax.random.uniform(k_s), jax.random.normal(k_bs), jax.random.normal(k_ss))
        return jax.vmap(step)(jax.random.split(jax.random.fold_in(key, b), T))
    out = jax.jit(jax.vmap(one))(jnp.arange(B))
    return lob.FlowDraws(*(_t(x).transpose(0, 1).contiguous() for x in out))


class JaxMarketDraws:
    """The market generators' draws from a JAX key, as the JAX programs
    draw them."""

    def __init__(self, key):
        self.key = key

    def gbm(self, B, T):
        ks = jax.random.split(self.key, 5)
        return paths.GbmDraws(_t(jax.random.uniform(ks[0], (B, T))),
                              _t(jax.random.randint(ks[1], (B, T), 0, 3)).long(),
                              _t(jax.random.normal(ks[2], (B, T))),
                              _t(jax.random.normal(ks[3], (2, B, T))),
                              _t(jax.random.normal(ks[4], (B, T))))

    def flow(self, B, T, levels):
        assert levels == L
        return _flow_draws(self.key, B, T)


def _steady_total():
    return float((2.0 * np.exp(-0.12 * np.arange(L, dtype=np.float64)) / 0.08).sum())


def lob_flips(got: dict, ref: dict, tick=TICK):
    """Every grid-roll flip (scenario, step, distance of JAX's ratio from a
    half tick) and each scenario's first flip step (T if none)."""
    rj = (ref["close"] / ref["open"] - np.float32(1)) / tick
    rt = (got["close"] / got["open"] - np.float32(1)) / tick
    flips = np.argwhere(np.round(rj) != np.round(rt))
    dist = [abs(abs(rj[b, t] - np.trunc(rj[b, t])) - 0.5) for b, t in flips]
    B, T = ref["close"].shape
    first = [int(flips[flips[:, 0] == b, 1].min()) if (flips[:, 0] == b).any() else T
             for b in range(B)]
    return flips, dist, first


def assert_lob_follows(got: dict, ref: dict):
    """`lob_candles`' outputs held to the module docstring's bounds; returns
    the flips."""
    B, T = ref["close"].shape
    step_bound = 4.0 * (np.arange(T) + 1) * U
    for k in ("open", "close"):
        rel = np.abs(got[k].astype(np.float64) - ref[k]) / np.abs(ref[k])
        assert (rel <= step_bound).all(), (k, float((rel / step_bound).max()))
    flips, dist, first = lob_flips(got, ref)
    assert all(d <= FLIP_TICKS for d in dist), (flips.tolist(), dist)
    atol = L * U * _steady_total()
    for b in range(B):
        f = first[b]
        for k in ("high", "low"):
            rel = np.abs(got[k][b, :f].astype(np.float64) - ref[k][b, :f]) / ref[k][b, :f]
            assert (rel <= step_bound[:f] + 4 * U).all(), (k, b)
        for k in ("volume", "cap"):
            assert np.abs(got[k][b, :f] - ref[k][b, :f]).max(initial=0.0) <= atol, (k, b)
        np.testing.assert_array_equal(got["spread"][b, :f], ref["spread"][b, :f])
    np.testing.assert_array_equal(got["regime"], np.asarray(ref["regime"]))
    return flips, dist


def test_regime_chain_is_exact():
    rng = np.random.default_rng(0)
    sw = rng.uniform(size=(5, 300)) < 0.05
    ch = rng.integers(0, 3, (5, 300))
    ref = np.asarray(jpaths.regime_chain(jnp.asarray(sw), jnp.asarray(ch, jnp.int32)))
    got = paths.regime_chain(torch.from_numpy(sw), torch.from_numpy(ch))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int32


def test_gbm_candles_on_jax_draws():
    B, T = 6, 256
    sched, _ = jsc.mixed_schedules(["calm", "flash_crash", "vol_regime_shift"], B, T, seed=1)
    key = jax.random.PRNGKey(3)
    ref = {k: np.asarray(v) for k, v in jpaths.gbm_candles(key, sched).items()}
    draws = JaxMarketDraws(key)
    got = {k: v.numpy() for k, v in paths.gbm_candles(draws, sched, device="cpu").items()}
    np.testing.assert_array_equal(got["regime"], ref["regime"])
    d = draws.gbm(B, T)
    vm = np.array([0.6, 1.2, 2.5])[ref["regime"]]
    rets = (0.00002 * np.array([0.0, 8.0, -3.0])[ref["regime"]]
            + 0.0015 * vm * sched.vol_mult * d.z.numpy() + sched.logret_shift)
    S = np.cumsum(np.abs(rets), axis=-1)
    bound = (4.0 + (np.arange(T) + 1) * S) * U
    for k in ("open", "high", "low", "close"):
        rel = np.abs(got[k].astype(np.float64) - ref[k]) / np.abs(ref[k])
        assert (rel <= bound + 4 * U).all(), (k, float(rel.max()))
    np.testing.assert_allclose(got["volume"], ref["volume"], rtol=8 * U, atol=0)
    assert (got["open"][:, 0] == np.float32(40_000.0)).all()


def test_bootstrap_candles_on_jax_draws():
    B, T = 4, 128
    sched, _ = jsc.mixed_schedules(["calm", "flash_crash"], B, T, seed=2)
    rets = np.random.default_rng(5).normal(0, 0.002, 500).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = {k: np.asarray(v) for k, v in jpaths.bootstrap_candles(key, rets, sched).items()}
    ks = jax.random.split(key, 3)

    class Draws:
        def bootstrap(self, B, T, n):
            return paths.BootstrapDraws(_t(jax.random.randint(ks[0], (B, T), 0, n)).long(),
                                        _t(jax.random.normal(ks[1], (2, B, T))),
                                        _t(jax.random.normal(ks[2], (B, T))))

    got = {k: v.numpy() for k, v in paths.bootstrap_candles(Draws(), rets, sched,
                                                            device="cpu").items()}
    idx = np.asarray(jax.random.randint(ks[0], (B, T), 0, rets.shape[0]))
    S = np.cumsum(np.abs(rets[idx] * sched.vol_mult + sched.logret_shift), axis=-1)
    bound = (8.0 + (np.arange(T) + 1) * S) * U
    for k in ("open", "high", "low", "close"):
        rel = np.abs(got[k].astype(np.float64) - ref[k]) / np.abs(ref[k])
        assert (rel <= bound).all(), (k, float(rel.max()))
    np.testing.assert_allclose(got["volume"], ref["volume"], rtol=8 * U, atol=0)


def test_flow_step_on_jax_draws():
    """One step of 8 books (4 already stepped 20 times under shocks) on the
    same draws: within 1e-6, the roll equal."""
    B = 8
    sched, _ = jsc.mixed_schedules(["flash_crash", "spread_blowout", "liquidity_hole",
                                    "exchange_outage"], B, 64, seed=3)
    jflow = jlob.flow_params(vol=0.004)
    tflow = lob.flow_params(vol=0.004, device="cpu")
    key = jax.random.PRNGKey(9)
    # warm books: JAX's own steps
    warm = {k: np.asarray(v) for k, v in jlob.lob_candles(key, sched, flow=jflow).items()}
    # the flow is an argument of the program, as in lob_candles (a constant
    # would let XLA turn its divisions into reciprocal products)
    step = jax.jit(jax.vmap(jlob.flow_step, in_axes=(0, 0, 0, None)))
    t = 30
    row = {k: jnp.asarray(getattr(sched, k)[:, t]) for k in jsc.ShockSchedule._fields}
    rng = np.random.default_rng(0)
    bid = (25.0 * rng.uniform(0.2, 1.5, (B, L))).astype(np.float32)
    ask = (25.0 * rng.uniform(0.2, 1.5, (B, L))).astype(np.float32)
    mid = warm["close"][:, t - 1]
    jb = jlob.LobState(mid=jnp.asarray(mid), s_ticks=jnp.full((B,), 1.0, jnp.float32),
                       bid_sz=jnp.asarray(bid), ask_sz=jnp.asarray(ask))
    keys = jnp.stack([jax.random.fold_in(key, 1000 + b) for b in range(B)])
    jb2, jc, jspread, jcap, jta, jtb = step(jb, keys, row, jflow)

    def draw(kt):
        k_mid, k_arr, k_can, k_mkt = jax.random.split(kt, 4)
        k_b, k_s, k_bs, k_ss = jax.random.split(k_mkt, 4)
        return (jax.random.normal(k_mid), jax.random.normal(k_arr, (2, L)),
                jax.random.uniform(k_can, (2, L)), jax.random.uniform(k_b),
                jax.random.uniform(k_s), jax.random.normal(k_bs), jax.random.normal(k_ss))

    d = lob.FlowDraws(*(_t(x) for x in jax.vmap(draw)(keys)))
    tb = lob.LobState(torch.from_numpy(mid.copy()), torch.ones(B), torch.from_numpy(bid),
                      torch.from_numpy(ask))
    trow = {k: torch.from_numpy(np.asarray(getattr(sched, k)[:, t], np.float32))
            for k in lob.SCHEDULE_KEYS}
    tb2, tc, tspread, tcap, tta, ttb = lob.flow_step(tb, d, trow, tflow)
    m_j = np.round((np.asarray(jb2.mid) / mid - np.float32(1)) / TICK)
    m_t = np.round((tb2.mid.numpy() / mid - np.float32(1)) / TICK)
    np.testing.assert_array_equal(m_t, m_j)
    assert np.abs(m_j).max() >= 1      # the roll is exercised
    np.testing.assert_allclose(tb2.mid.numpy(), np.asarray(jb2.mid), rtol=1e-6)
    np.testing.assert_array_equal(tb2.s_ticks.numpy(), np.asarray(jb2.s_ticks))
    size_atol = 1e-6 * 25.0
    for g, r in ((tb2.bid_sz, jb2.bid_sz), (tb2.ask_sz, jb2.ask_sz), (tta, jta), (ttb, jtb),
                 (tcap, jcap), (tc["volume"], jc["volume"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=size_atol)
    for k in ("open", "high", "low", "close"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6)
    np.testing.assert_array_equal(tspread.numpy(), np.asarray(jspread))


def test_lob_candles_flips_accounted():
    """[4, 256] of order-flow candles on JAX's draws under four presets:
    the mid path over the whole run, the book's channels up to each
    scenario's first flip, every flip within 4 ulps of a half tick."""
    B, T = 4, 256
    sched, _ = jsc.mixed_schedules(["calm", "flash_crash", "liquidity_hole",
                                    "spread_blowout"], B, T, seed=0)
    key = jax.random.PRNGKey(3)
    ref = {k: np.asarray(v) for k, v in jlob.lob_candles(key, sched).items()}
    got = {k: v.numpy() for k, v in lob.lob_candles(
        JaxMarketDraws(key), sched, device="cpu").items()}
    flips, dist = assert_lob_follows(got, ref)
    print(f"lob_candles [4, 256]: {len(flips)} grid-roll flips {flips.tolist()}, "
          f"distances from a half tick {dist}")
    assert set(got) == set(ref)


@pytest.mark.parametrize("dynamics", ["gbm", "lob"])
def test_scenario_env_params_follow_jax(dynamics):
    """(a) From the same candles (both packages' generators patched to give
    JAX's): the close table bit for bit, the return columns and the trade
    cost bit for bit, the book columns within an ulp, the indicator
    columns within the indicator table's tolerances
    (tests/test_torch_indicators.py) carried through the column's scale;
    (b) end to end on JAX's draws: the labels, shapes and the close table
    within the market's bounds."""
    key = jax.random.PRNGKey(7)
    kw = dict(num_scenarios=4, steps=256, episode_len=64, fee_rate=0.0005, dynamics=dynamics)
    jp, jlabels = jengine.scenario_env_params(key, **kw)
    sched, _ = jsc.mixed_schedules(None, 4, 256, seed=0)
    candles = {k: np.asarray(v) for k, v in jengine._stress_candles(
        key, sched, dynamics, None).items()}
    real = engine._stress_candles
    engine._stress_candles = lambda *a, **k: {
        c: torch.from_numpy(v.copy()) for c, v in candles.items()}
    try:
        tp, labels = engine.scenario_env_params(JaxMarketDraws(key), device="cpu", **kw)
    finally:
        engine._stress_candles = real
    assert labels == jlabels
    np.testing.assert_array_equal(tp.close.numpy(), np.asarray(jp.close))
    got, ref = tp.obs_table.numpy(), np.asarray(jp.obs_table)
    assert got.shape == ref.shape and jenv.obs_size(jp) == got.shape[-1] + 2
    close = np.asarray(jp.close)[..., None]
    np.testing.assert_array_equal(got[..., 6:8], ref[..., 6:8])
    np.testing.assert_allclose(got[..., 0], ref[..., 0], rtol=2e-5, atol=1e-5)   # rsi / 100
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=1e-5, atol=1e-6)   # stoch_k / 100
    macd_tol = (1e-3 + 2e-5 * np.abs(ref[..., 2:3]) * close / 100 + 2e-6 * close) / close * 100
    assert (np.abs(got[..., 2:3] - ref[..., 2:3]) <= macd_tol + 1e-6).all()
    np.testing.assert_allclose(got[..., 3], ref[..., 3], rtol=1e-5, atol=1e-6)   # williams
    # bb_position: the rolling std is sqrt(m2 − m²), whose float32 rounding
    # (~2u·close² on the variance) moves the std by u·(close/sd)² relative
    # and the position by that times its distance from the band's middle
    jind = {k: np.asarray(v) for k, v in jax_indicators(
        {k: candles[k] for k in ("open", "high", "low", "close", "volume")}).items()}
    sd = (jind["bb_high"] - jind["bb_low"]) / 4.0
    pos_tol = 1e-3 + (np.abs(ref[..., 4] - 0.5) + 0.5) * U * (jind["close"] / sd) ** 2
    assert (np.abs(got[..., 4] - ref[..., 4]) <= pos_tol).all()
    atr_tol = (1e-3 + 2e-5 * ref[..., 5:6] * close) / close
    assert (np.abs(got[..., 5:6] - ref[..., 5:6]) <= atr_tol + 1e-7).all()
    if dynamics == "lob":
        np.testing.assert_array_equal(got[..., 8], ref[..., 8])                 # spread ‰
        np.testing.assert_allclose(got[..., 9], ref[..., 9], rtol=0, atol=2 * U)  # tanh
        np.testing.assert_array_equal(tp.trade_cost.numpy(), np.asarray(jp.trade_cost))
    else:
        assert tp.trade_cost == 0.0 and float(jp.trade_cost) == 0.0

    e2e, labels2 = engine.scenario_env_params(JaxMarketDraws(key), device="cpu", **kw)
    assert labels2 == jlabels and e2e.obs_table.shape == jp.obs_table.shape
    T = np.arange(256) + 1
    rel = np.abs(e2e.close.numpy().astype(np.float64) - np.asarray(jp.close)) / np.asarray(jp.close)
    bound = 4.0 * T * U if dynamics == "lob" else (4.0 + T * 1.0) * U
    assert (rel <= bound).all(), float((rel / bound).max())


def test_generator_markets_run_and_default_to_cuda(monkeypatch):
    g = torch.Generator().manual_seed(0)
    p, labels = engine.scenario_env_params(g, num_scenarios=3, steps=128, episode_len=32,
                                           dynamics="lob", device="cpu")
    assert p.obs_table.shape == (3, 128, 10) and len(labels) == 3
    assert torch.isfinite(p.obs_table).all() and torch.isfinite(p.trade_cost).all()
    with pytest.raises(ValueError, match="dynamics"):
        engine.scenario_env_params(g, dynamics="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lob.flow_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.scenario_env_params(g, num_scenarios=2, steps=64)
