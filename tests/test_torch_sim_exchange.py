"""The port's candle-granularity exchange against the JAX package's, on the CPU.

    init_state, no_action, _fill, settle_pending, match_candle (with and
    without its gate), apply_action, equity ↔ ai_crypto_trader_tpu.sim.exchange

Inputs are random order flows made with numpy from a seed over
`generate_ohlcv` candles — markets, placements (some at absurd prices and
sizes, so rejects and never-triggering orders happen), cancels — with the
schedule channels (spread, halt, latency) on or off, a liquidity cap, and
a fill log short enough to overflow.  The JAX side runs jitted (`vmap` of
a `lax.scan`), as its rollouts do.

Tolerances.  Every comparison with the JAX package is bit for bit: the
exchange is adds, multiplies, compares and selects, and the one pattern
XLA's CPU program contracts into a fused multiply-add, ``quote +
base·price`` in `equity`, the port rounds once too (`device.plus_product`);
without it equity differs in ~6 % of steps (the test shows that it
matters).  The ledger properties are the JAX package's own (tests/
test_sim.py:216-360): the quote, base and fee balances equal the fill
log's sums within rtol 1e-5 / 1e-4 (float32 accumulation over ≤ 64
fills), and no balance goes below −1e-3 quote or −1e-6 base.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.data.synthetic import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu.sim import exchange as jsx  # noqa: E402
from ai_crypto_trader_tpu_torch.sim import exchange as sx  # noqa: E402

f32 = np.float32
K, B, T = 4, 16, 128
OHLC = ("open", "high", "low", "close")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.partial(jax.jit, static_argnames=("L",))
def _jax_flow(candles, actions, chans, quote0, fee_rate, cap, L):
    """The JAX exchange driven through action streams: final state and the
    per-step equity, [B] scenarios."""
    def one(c, a_s, ch):
        def step(st, xs):
            a, candle, t, s = xs
            st = jsx.settle_pending(st, candle, t, fee_rate, s["spread"], s["halt"])
            st = jsx.match_candle(st, candle, t, cap, s["halt"], fee_rate)
            st = jsx.apply_action(st, candle, t, a, fee_rate, s["spread"], s["halt"],
                                  s["latency"])
            return st, jsx.equity(st, candle["close"])
        st0 = jsx.init_state(quote0, K=K, L=L)
        n = c["close"].shape[-1]
        return jax.lax.scan(step, st0, (a_s, c, jnp.arange(n, dtype=jnp.int32), ch))
    return jax.vmap(one)(candles, actions, chans)


def _port_flow(candles, actions, chans, quote0, fee_rate, cap, L, eq=sx.equity):
    st = sx.init_state(quote0, K=K, L=L, batch=B, device="cpu")
    fee, capt = torch.tensor(fee_rate, dtype=torch.float32), torch.tensor(cap, dtype=torch.float32)
    curve = []
    for t in range(candles["close"].shape[-1]):
        c = {k: v[:, t] for k, v in candles.items()}
        a = sx.Action(*(v[:, t] for v in actions))
        s = {k: v[:, t] for k, v in chans.items()}
        tt = torch.tensor(t, dtype=torch.int32)
        st = sx.settle_pending(st, c, tt, fee, s["spread"], s["halt"])
        st = sx.match_candle(st, c, tt, capt, s["halt"], fee)
        st = sx.apply_action(st, c, tt, a, fee, s["spread"], s["halt"], s["latency"])
        curve.append(eq(st, c["close"]))
    return st, torch.stack(curve, 1)


def _random_flow(rng, close):
    mk = rng.random((B, T)) < 0.15
    qty = np.exp(rng.normal(-3.5, 1.2, (B, T))).astype(f32)
    ref = close[:, :, None]
    return dict(
        market_qty=np.where(mk, qty, 0.0).astype(f32),
        market_side=rng.choice([sx.BUY, sx.SELL], (B, T)).astype(np.int32),
        cancel=rng.random((B, T, K)) < 0.05,
        place=rng.random((B, T, K)) < 0.10,
        side=rng.choice([sx.BUY, sx.SELL], (B, T, K)).astype(np.int32),
        kind=rng.choice([sx.LIMIT, sx.STOP], (B, T, K)).astype(np.int32),
        qty=np.exp(rng.normal(-3.0, 1.5, (B, T, K))).astype(f32),
        limit_price=(ref * (1.0 + rng.normal(0, 0.02, (B, T, K)))).astype(f32),
        stop_price=(ref * (1.0 + rng.normal(0, 0.02, (B, T, K)))).astype(f32))


def _flow_case(seed, shocks, q0=1_000.0):
    d = generate_ohlcv(n=T, seed=list(range(100, 100 + B)))
    rng = np.random.default_rng(seed)
    act = _random_flow(rng, d["close"])
    zero = np.zeros((B, T), f32)
    chans = {"spread": zero, "halt": zero, "latency": zero}
    if shocks:
        chans = {"spread": ((rng.random((B, T)) < 0.3)
                            * rng.uniform(0, 0.01, (B, T))).astype(f32),
                 "halt": (rng.random((B, T)) < 0.05).astype(f32),
                 "latency": (rng.random((B, T)) < 0.2).astype(f32)}
    return {k: d[k].astype(f32) for k in OHLC}, act, chans, q0


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_state_equal(got: sx.ExchState, ref):
    for f in sx.ExchState._fields:
        if f == "book":
            for g in sx.Book._fields:
                np.testing.assert_array_equal(_bits(getattr(got.book, g).numpy()),
                                              _bits(getattr(ref.book, g)), err_msg=g)
        else:
            np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                          _bits(getattr(ref, f)), err_msg=f)


def _run_both(candles, act, chans, q0, fee, cap, L, eq=sx.equity):
    jst, jeq = _jax_flow({k: jnp.asarray(v) for k, v in candles.items()},
                         jsx.Action(**{k: jnp.asarray(v) for k, v in act.items()}),
                         {k: jnp.asarray(v) for k, v in chans.items()},
                         jnp.float32(q0), jnp.float32(fee), jnp.float32(cap), L=L)
    st, curve = _port_flow({k: _t(v) for k, v in candles.items()},
                           sx.Action(**{k: _t(v) for k, v in act.items()}),
                           {k: _t(v) for k, v in chans.items()}, q0, fee, cap, L, eq=eq)
    return st, curve, jax.device_get(jst), np.asarray(jeq)


@pytest.mark.parametrize("case", ["parity", "capped", "shocks", "full_log"])
def test_random_flows_bit_for_bit(case):
    """The whole state (balances, book, pending slot, fill log, counters)
    after 128 candles of random flow, and the equity at every candle."""
    shocks = case == "shocks"
    cap = 0.02 if case in ("capped", "shocks") else np.inf
    L = 8 if case == "full_log" else 64
    q0 = 1_000.0 if case == "parity" else 100_000.0
    candles, act, chans, q0 = _flow_case(7, shocks, q0=q0)
    st, curve, jst, jeq = _run_both(candles, act, chans, q0, 0.001, cap, L)
    _assert_state_equal(st, jst)
    np.testing.assert_array_equal(_bits(curve.numpy()), _bits(jeq))
    assert (jst.n_fills > 0).sum() >= B // 2, "the flow barely trades"
    if case == "full_log":
        assert (jst.dropped_fills > 0).any() and (jst.n_fills == L).any()
    if case == "capped":
        assert (jst.fills[..., 3] == f32(0.02)).sum() >= 3, "no fill was capped"


def test_equity_needs_the_single_rounding():
    """Without `plus_product` equity is off JAX's at some steps: the fused
    multiply-add is real, and the port's rounding is what makes it equal."""
    candles, act, chans, q0 = _flow_case(1, False, q0=100_000.0)
    _, curve, _, jeq = _run_both(candles, act, chans, q0, 0.001, np.inf, 64,
                                 eq=lambda s, p: s.quote + s.base * p)
    assert (_bits(curve.numpy()) != _bits(jeq)).sum() > 0


def _mid_run_state(seed=3, steps=60):
    """A JAX exchange state after ``steps`` candles of random flow (resting
    orders, a parked order, fills logged), and the next candle's inputs."""
    candles, act, chans, q0 = _flow_case(seed, True, q0=100_000.0)
    cut = lambda x: x[:, :steps]  # noqa: E731
    jst, _ = _jax_flow({k: jnp.asarray(cut(v)) for k, v in candles.items()},
                       jsx.Action(**{k: jnp.asarray(cut(v)) for k, v in act.items()}),
                       {k: jnp.asarray(cut(v)) for k, v in chans.items()},
                       jnp.float32(q0), jnp.float32(0.001), jnp.float32(0.05), L=16)
    nxt = lambda x: x[:, steps]  # noqa: E731
    return (jax.device_get(jst), {k: nxt(v) for k, v in candles.items()},
            {k: nxt(v) for k, v in act.items()}, {k: nxt(v) for k, v in chans.items()})


def _port_state(j) -> sx.ExchState:
    book = sx.Book(*(_t(getattr(j.book, f)) for f in sx.Book._fields))
    return sx.ExchState(**{f: book if f == "book" else _t(getattr(j, f))
                           for f in sx.ExchState._fields})


@pytest.mark.parametrize("fn", ["_fill", "settle_pending", "match_candle", "match_gated",
                                "apply_action", "equity"])
def test_each_function_bit_for_bit_on_a_mid_run_state(fn):
    jst, candle, act, ch = _mid_run_state()
    assert jst.book.active.any() and jst.n_fills.sum() > 0
    fee, cap, t = 0.001, 0.05, 60
    jc = {k: jnp.asarray(v) for k, v in candle.items()}
    tc = {k: _t(v) for k, v in candle.items()}
    gate = np.random.default_rng(0).random((B, K)) < 0.5
    jact = jsx.Action(**{k: jnp.asarray(v) for k, v in act.items()})
    tact = sx.Action(**{k: _t(v) for k, v in act.items()})
    jch = {k: jnp.asarray(v) for k, v in ch.items()}
    tch = {k: _t(v) for k, v in ch.items()}
    side = np.where(np.arange(B) % 2 == 0, sx.BUY, sx.SELL).astype(np.int32)
    qty = np.exp(np.random.default_rng(1).normal(-2.0, 1.0, B)).astype(f32)
    extra = {"side": side, "qty": qty, "gate": gate}
    tf, tcap = torch.tensor(f32(fee)), torch.tensor(f32(cap))
    calls = {
        "_fill": (lambda s, c, ch_, a, x, tt: jsx._fill(s, tt, 2, x["side"], x["qty"],
                                                        c["close"], fee)[0],
                  lambda s, c, ch_, a, x, tt: sx._fill(s, tt, 2, x["side"], x["qty"],
                                                       c["close"], tf)[0]),
        "settle_pending": (
            lambda s, c, ch_, a, x, tt: jsx.settle_pending(s, c, tt, fee, ch_["spread"],
                                                           ch_["halt"]),
            lambda s, c, ch_, a, x, tt: sx.settle_pending(s, c, tt, tf, ch_["spread"],
                                                          ch_["halt"])),
        "match_candle": (
            lambda s, c, ch_, a, x, tt: jsx.match_candle(s, c, tt, cap, ch_["halt"], fee),
            lambda s, c, ch_, a, x, tt: sx.match_candle(s, c, tt, tcap, ch_["halt"], tf)),
        "match_gated": (
            lambda s, c, ch_, a, x, tt: jsx.match_candle(s, c, tt, cap, ch_["halt"], fee,
                                                         gate=x["gate"]),
            lambda s, c, ch_, a, x, tt: sx.match_candle(s, c, tt, tcap, ch_["halt"], tf,
                                                        gate=x["gate"])),
        "apply_action": (
            lambda s, c, ch_, a, x, tt: jsx.apply_action(s, c, tt, a, fee, ch_["spread"],
                                                         ch_["halt"], ch_["latency"]),
            lambda s, c, ch_, a, x, tt: sx.apply_action(s, c, tt, a, tf, ch_["spread"],
                                                        ch_["halt"], ch_["latency"])),
    }
    if fn == "equity":
        ref = np.asarray(jax.jit(jax.vmap(jsx.equity))(
            jax.tree.map(jnp.asarray, jst), jc["close"]))
        got = sx.equity(_port_state(jst), tc["close"]).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        return
    jfn, tfn = calls[fn]
    per = jax.jit(jax.vmap(lambda s, c, ch_, a, x: jfn(s, c, ch_, a, x, jnp.int32(t))))
    ref = jax.device_get(per(jax.tree.map(jnp.asarray, jst), jc, jch, jact,
                             {k: jnp.asarray(v) for k, v in extra.items()}))
    got = tfn(_port_state(jst), tc, tch, tact, {k: _t(v) for k, v in extra.items()},
              torch.tensor(t, dtype=torch.int32))
    _assert_state_equal(got, ref)


def _ledger_state(seed):
    candles, act, chans, q0 = _flow_case(seed, False)
    st, _ = _port_flow({k: _t(v) for k, v in candles.items()},
                       sx.Action(**{k: _t(v) for k, v in act.items()}),
                       {k: _t(v) for k, v in chans.items()}, q0, 0.001, np.inf, 64)
    return st, q0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_conservation_and_no_negative_balance(seed):
    st, q0 = _ledger_state(seed)
    n_fills = st.n_fills.numpy()
    assert (n_fills > 0).sum() >= B // 2 and (st.dropped_fills == 0).all()
    for b in range(B):
        log = st.fills[b, :int(n_fills[b])].numpy().astype(np.float64)
        side, qty, price, fee = log[:, 2], log[:, 3], log[:, 4], log[:, 5]
        buys, sells = side > 0, side < 0
        cost = qty * price
        quote = q0 - (cost[buys] + fee[buys]).sum() + (cost[sells] - fee[sells]).sum()
        np.testing.assert_allclose(float(st.quote[b]), quote, rtol=1e-5, atol=5e-2)
        np.testing.assert_allclose(float(st.base[b]), qty[buys].sum() - qty[sells].sum(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(st.fee_paid[b]), fee.sum(), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(fee, cost * 0.001, rtol=1e-3, atol=1e-6)
    assert (st.quote >= -1e-3).all() and (st.base >= -1e-6).all()


def test_partial_fills_carry_over_under_a_cap():
    """One resting LIMIT BUY of 10 base under a cap of 3 a candle, on
    constant candles: fills of 3, 3, 3, 1, and the order is gone."""
    n = 6
    const = torch.full((1,), 100.0)
    c = {"open": const, "high": const * 1.01, "low": const * 0.99, "close": const}
    st = sx.init_state(10_000.0, K=K, L=16, device="cpu")
    place = torch.zeros((1, K), dtype=torch.bool)
    place[0, 0] = True
    a = sx.no_action(K, device="cpu")._replace(
        place=place, side=torch.full((1, K), sx.BUY, dtype=torch.int32),
        kind=torch.full((1, K), sx.LIMIT, dtype=torch.int32), qty=torch.full((1, K), 10.0),
        limit_price=torch.full((1, K), 100.0))
    z, fee, cap = torch.zeros(1), torch.tensor(0.0), torch.tensor(3.0)
    idle = sx.no_action(K, device="cpu")
    for t in range(n):
        st = sx.match_candle(st, c, t, cap, z, fee)
        st = sx.apply_action(st, c, t, a if t == 0 else idle, fee, z, z, z)
    log = st.fills[0, :int(st.n_fills[0])].numpy()
    np.testing.assert_allclose(log[:, 3], [3.0, 3.0, 3.0, 1.0])
    np.testing.assert_allclose(float(st.base[0]), 10.0)
    assert not bool(st.book.active[0, 0]) and int(st.n_fills[0]) == 4


def test_init_state_and_no_action_match_jax():
    ref, got = jsx.init_state(5_000.0, K=3, L=7), sx.init_state(5_000.0, K=3, L=7, device="cpu")
    jref = jax.tree.map(lambda x: np.asarray(x)[None], ref)
    _assert_state_equal(got, jref)
    ja, ta = jsx.no_action(3), sx.no_action(3, batch=2, device="cpu")
    for f in sx.Action._fields:
        g, r = getattr(ta, f).numpy(), np.asarray(getattr(ja, f))
        np.testing.assert_array_equal(g, np.broadcast_to(r, g.shape), err_msg=f)
        assert g.dtype == r.dtype, f
    assert sx.FILL_FIELDS == jsx.FILL_FIELDS
    assert (sx.BUY, sx.SELL, sx.LIMIT, sx.STOP) == (jsx.BUY, jsx.SELL, jsx.LIMIT, jsx.STOP)
