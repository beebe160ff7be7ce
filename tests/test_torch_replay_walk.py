"""The replay kernel's event walk, held bit for bit on the CPU.

`csrc/replay_sweep.cu` does not step every candle: it jumps from an entry
to the first candle whose pnl% hits SL or TP, and from a close to the next
candle whose entry gate is set, and books a run of candles out of a
position as one equity point counted into n_r.  The kernel runs only on
the card, but the argument it rests on can be tested here.  `walk` below is
a NumPy float32 mirror of the kernel — the same events in the same order,
each with replay_step's operands in replay_step's order, volume times
float32(1/50000) as `device.div_const` computes it — and it must agree with
the engine's plain loop (`backtest.sweep(device="cpu")`) bit for bit on
every stat and on the equity curve, in cases chosen to reach every branch:
overrides, gating, exits on the next candle, no exit but the end of the
test, a warmup past the first gate, and SL/TP hit with equality.  Once it is
also held against the JAX package's `sweep` (at `assert_stats_equal`'s
tolerance).  `ops.replay.gate_mask_plain`, the pre-pass's plain version, is
held against the entry gate of `replay_step`.

The rows form (the GA's fitness: signal, decision, strength, confidence,
volatility and the SL/TP overrides [B, T], a row per strategy; close and
volume shared) is mirrored the same way, strategy j walking row j of each
stream: rows whose gates differ, rows that hit SL/TP with equality beside
rows that do not, a ragged T.  `run_backtest` on per-genome rows, the
input the kernel's rows form takes on the card, is held against the JAX
package's `population_backtest` on the CPU.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_backtest import assert_stats_equal, make_inputs, to_port  # noqa: E402

from ai_crypto_trader_tpu import backtest as jbt  # noqa: E402
from ai_crypto_trader_tpu_torch import backtest as tbt  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import engine  # noqa: E402
from ai_crypto_trader_tpu_torch.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch.ops import compute_indicators  # noqa: E402
from ai_crypto_trader_tpu_torch.ops.replay import gate_mask_plain  # noqa: E402

F = np.float32
THR, MIN_STRENGTH, BALANCE = 0.7, 70.0, 10_000.0


def _min_nan(a, b):
    return F(np.nan) if (np.isnan(a) or np.isnan(b)) else (b if b < a else a)


def _max_nan(a, b):
    return F(np.nan) if (np.isnan(a) or np.isnan(b)) else (b if b > a else a)


def _position_size(balance, vol, volume):
    hi = vol > F(0.02)
    mid = (not hi) and vol > F(0.01)
    pct = F(0.25) if hi else (F(0.20) if mid else F(0.15))
    sl = F(0.02) if hi else (F(0.015) if mid else F(0.01))
    size = balance * pct * _min_nan(volume * F(1.0 / 50_000.0), F(1.0))
    size = _min_nan(size, balance * F(0.15) / sl)
    size = _min_nan(size, balance * F(0.20))
    size = _max_nan(size, balance * F(0.10))
    return _max_nan(size, F(40.0))


def gate_of(x, warmup):
    """The entry gate of every candle, out of a position (bool [T])."""
    t = np.arange(len(x["close"]))
    return ((t >= warmup) & (x["confidence"] >= F(THR)) & (x["strength"] >= F(MIN_STRENGTH))
            & (x["signal"] == x["decision"]) & (x["decision"] == 1))


class _Carry:
    """The kernel's carry (Carry in csrc/replay_sweep.cu) as float32/int."""

    def __init__(self):
        self.balance = self.max_equity = F(BALANCE)
        self.entry = self.qty = self.sl = self.tp = F(0.0)
        self.max_dd = self.max_dd_pct = self.total_profit = self.total_loss = F(0.0)
        self.sum_r = self.sum_r2 = self.sum_neg_r2 = F(0.0)
        self.in_pos = False
        self.trades = self.wins = self.cur_win = self.cur_loss = 0
        self.max_win = self.max_loss = 0
        self.n_r = 1

    def book_close(self, price):
        pnl = (price - self.entry) * self.qty
        self.balance = self.balance + pnl
        self.in_pos = False
        self.trades += 1
        if pnl > F(0.0):
            self.wins += 1
            self.total_profit = self.total_profit + pnl
            self.cur_win, self.cur_loss = self.cur_win + 1, 0
        else:
            self.total_loss = self.total_loss + (-pnl)
            self.cur_win, self.cur_loss = 0, self.cur_loss + 1
        self.max_win = max(self.max_win, self.cur_win)
        self.max_loss = max(self.max_loss, self.cur_loss)

    def equity_point(self, prev_balance):
        equity = self.balance
        self.max_equity = _max_nan(self.max_equity, equity)
        dd = self.max_equity - equity
        if dd > self.max_dd:
            self.max_dd, self.max_dd_pct = dd, dd / self.max_equity * F(100.0)
        r = (equity - prev_balance) / prev_balance
        self.sum_r = self.sum_r + r
        self.sum_r2 = self.sum_r2 + r * r
        if r < F(0.0):
            self.sum_neg_r2 = self.sum_neg_r2 + r * r
        self.n_r += 1


def _walk_one(x, gate, psl, ptp, warmup, curve_row):
    close, T = x["close"], len(x["close"])
    gates = np.flatnonzero(gate)
    c = _Carry()
    booked = t = max(warmup, 0)
    curve_from = 0
    while t < T:
        later = gates[gates >= t]
        g = int(later[0]) if later.size else T
        count = (g + 1 if g < T else T) - booked
        if count > 0:                      # the run booked..g, each r = 0
            c.equity_point(c.balance)
            c.n_r += count - 1
        if g >= T:
            break
        price = close[g]
        size = _position_size(c.balance, x["volatility"][g], x["volume"][g])
        c.in_pos, c.entry, c.qty = True, price, size / price
        c.sl = psl if np.isnan(x["sl_pct"][g]) else x["sl_pct"][g]
        c.tp = ptp if np.isnan(x["tp_pct"][g]) else x["tp_pct"][g]
        entry_safe = F(1.0) if c.entry == F(0.0) else c.entry
        pnl_pct = (close[g + 1:] - c.entry) / entry_safe * F(100.0)
        hits = np.flatnonzero((pnl_pct <= -c.sl) | (pnl_pct >= c.tp))
        if not hits.size:
            break
        xt = g + 1 + int(hits[0])
        prev_balance = c.balance
        curve_row[curve_from:xt] = prev_balance
        curve_from = xt
        c.book_close(close[xt])
        c.equity_point(prev_balance)
        booked, t = xt + 1, xt
    curve_row[curve_from:] = c.balance
    if c.in_pos:
        c.book_close(close[T - 1])
    return c


def _row_of(x, j):
    """Strategy j's streams: row j of each [B, T] stream, the [T] ones as
    they are (the kernel's row stride T or 0)."""
    return {k: (v[j] if v.ndim == 2 else v) for k, v in x.items()}


def walk(inputs, params, warmup=10):
    """The kernel's event walk in NumPy float32: (stats dict, curve [B, T]).
    Each stream [T], or [B, T] rows (but close and volume)."""
    x = {k: getattr(inputs, k).numpy() for k in inputs._fields}
    assert x["close"].ndim == 1 and x["volume"].ndim == 1
    sl, tp = params.stop_loss.numpy(), params.take_profit.numpy()
    B, T = len(sl), len(x["close"])
    curve = np.empty((B, T), F)
    with np.errstate(all="ignore"):
        carries = []
        for j in range(B):
            xj = _row_of(x, j)
            carries.append(_walk_one(xj, gate_of(xj, warmup), sl[j], tp[j], warmup, curve[j]))
    col = lambda f, dt: np.array([getattr(c, f) for c in carries], dt)  # noqa: E731
    stats = {
        "initial_balance": np.full(B, BALANCE, F), "final_balance": col("balance", F),
        "total_trades": col("trades", np.int32), "winning_trades": col("wins", np.int32),
        "losing_trades": col("trades", np.int32) - col("wins", np.int32),
        "total_profit": col("total_profit", F), "total_loss": col("total_loss", F),
        "max_drawdown": col("max_dd", F), "max_drawdown_pct": col("max_dd_pct", F),
        "sum_r": col("sum_r", F), "sum_r2": col("sum_r2", F),
        "sum_neg_r2": col("sum_neg_r2", F), "n_r": col("n_r", np.int32),
        "max_win_streak": col("max_win", np.int32), "max_loss_streak": col("max_loss", np.int32),
    }
    return stats, curve


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bit_identical(mirror, plain_stats, plain_curve, curve):
    got = convert.stats_to_numpy(plain_stats)
    for f in engine.BacktestStats._fields:
        assert got[f].dtype == mirror[f].dtype, f
        np.testing.assert_array_equal(_bits(mirror[f]), _bits(got[f]), err_msg=f)
    np.testing.assert_array_equal(_bits(curve), _bits(plain_curve.numpy()))


# --- the cases -------------------------------------------------------------

T_BASE, B_BASE = 3000, 32


@pytest.fixture(scope="module")
def base():
    d = {k: v for k, v in generate_ohlcv(n=T_BASE, seed=3).items() if k != "regime"}
    inp = tbt.prepare_inputs(compute_indicators(d, device="cpu"), device="cpu")
    params = tbt.sample_params(torch.Generator().manual_seed(0), B_BASE, device="cpu")
    return inp, params


def _pnl_pct(close, e, t):
    """replay_step's pnl% of candle t for an entry at candle e, float32."""
    entry = close[e]
    return (close[t] - entry) / (F(1.0) if entry == F(0.0) else entry) * F(100.0)


def _running_extreme(close, e, sign, nth):
    """The nth candle after e that sets a new strict extreme of sign * close
    (above the entry for sign 1, below it for -1)."""
    best, found = sign * close[e], 0
    for t in range(e + 1, len(close)):
        if sign * close[t] > best:
            best, found = sign * close[t], found + 1
            if found == nth:
                return t
    raise AssertionError("no such candle: pick another entry")


def exact_tie(inp):
    """Gates only at two candles (and past 2000 as the signals have them):
    at e1 a TP override equal to the float32 pnl% of a later candle, with SL
    out of reach; at e2, after that exit, an SL override equal to minus the
    pnl% of a later candle.  Each exit is hit with equality."""
    close = inp.close.numpy()
    e1 = 500
    x1 = _running_extreme(close, e1, 1, 6)
    e2 = x1 + 50
    x2 = _running_extreme(close, e2, -1, 4)
    keep = np.arange(T_BASE) >= 2000
    one = lambda t: torch.as_tensor(np.isin(np.arange(T_BASE), t))  # noqa: E731
    hot = one([e1, e2])
    sig = torch.where(hot, 1, torch.where(torch.as_tensor(keep), inp.signal, 0)).to(torch.int32)
    sl = np.full(T_BASE, np.nan, F)
    tp = np.full(T_BASE, np.nan, F)
    sl[e1], tp[e1] = F(1e6), _pnl_pct(close, e1, x1)
    sl[e2], tp[e2] = -_pnl_pct(close, e2, x2), F(1e6)
    assert tp[e1] > 0 and sl[e2] > 0
    out = inp._replace(signal=sig, decision=sig,
                       strength=torch.where(hot, 100.0, inp.strength),
                       sl_pct=torch.from_numpy(sl), tp_pct=torch.from_numpy(tp))
    return out, {"exits": (x1, x2), "entries": (e1, e2)}


def case(name, inp, params):
    """(inputs, params, warmup, expectation) of one named case."""
    T = T_BASE
    rng = np.random.default_rng(1)
    if name == "synthetic":
        return inp, params, 10, None
    if name == "overrides":
        mask = torch.as_tensor(rng.random(T) < 0.33)
        return inp._replace(sl_pct=torch.where(mask, 1.5, torch.nan),
                            tp_pct=torch.where(mask, 3.0, torch.nan)), params, 10, None
    if name == "gated":
        conf = torch.where(torch.arange(T) % 3 == 0, 0.9, 0.2).to(torch.float32)
        return inp._replace(confidence=conf), params, 10, None
    if name in ("tiny_sl_tp", "huge_sl_tp"):
        v = 1e-4 if name == "tiny_sl_tp" else 1e6
        full = torch.full((B_BASE,), v, dtype=torch.float32)
        return inp, params._replace(stop_loss=full, take_profit=full), 10, name
    if name == "late_warmup":
        first = int(np.flatnonzero(gate_of({k: getattr(inp, k).numpy() for k in inp._fields},
                                           0))[0])
        return inp, params, first + 1, "late_warmup"
    if name == "exact_tie":
        out, info = exact_tie(inp)
        return out, params, 10, info
    raise KeyError(name)


CASES = ["synthetic", "overrides", "gated", "tiny_sl_tp", "huge_sl_tp",
         "late_warmup", "exact_tie"]
ROW_STREAMS = ("signal", "decision", "strength", "confidence", "volatility",
               "sl_pct", "tp_pct")


def rows_case(name, inp, params):
    """(inputs with [B, T] rows, params, warmup) of one rows case."""
    rng = np.random.default_rng(7)
    B, T = int(params.stop_loss.shape[0]), T_BASE
    if name == "rows_gates":
        # each row keeps its own share of the BUY candles, its own strength
        # offset, confidence, volatility scale and exit overrides
        keep = torch.as_tensor(rng.random((B, T)) < rng.uniform(0.2, 1.0, (B, 1)))
        sig = torch.where(keep, inp.signal, 0).to(torch.int32)
        dec = torch.where(torch.as_tensor(rng.random((B, T)) < 0.97), sig, 1).to(torch.int32)
        ovr = torch.as_tensor(rng.random((B, T)) < rng.uniform(0.0, 0.6, (B, 1)))
        level = torch.as_tensor(rng.uniform(0.3, 4.0, (B, 1)).astype(np.float32))
        return inp._replace(
            signal=sig, decision=dec,
            strength=inp.strength + torch.as_tensor(rng.normal(0, 8, (B, 1)).astype(np.float32)),
            confidence=torch.as_tensor(rng.uniform(0.6, 1.0, (B, T)).astype(np.float32)),
            volatility=inp.volatility * torch.as_tensor(rng.uniform(0.5, 3, (B, 1)).astype(F)),
            sl_pct=torch.where(ovr, level, torch.nan),
            tp_pct=torch.where(ovr, 2 * level, torch.nan)), params, 10
    if name == "rows_exact_tie":
        # even rows: the exact-tie gates and overrides; odd rows: the base
        tie, _ = exact_tie(inp)
        even = (torch.arange(B) % 2 == 0)[:, None]
        return inp._replace(**{k: torch.where(even, getattr(tie, k), getattr(inp, k))
                               for k in ROW_STREAMS}), params, 10
    if name == "rows_ragged":
        Tr = 2 * 1024 + 7
        out, p, w = rows_case("rows_gates", inp, params)
        return type(out)(*(x[..., :Tr] for x in out)), p, 700
    raise KeyError(name)


ROW_CASES = ["rows_gates", "rows_exact_tie", "rows_ragged"]


@pytest.mark.parametrize("name", CASES)
def test_walk_matches_plain_loop_bit_for_bit(base, name):
    inp, params, warmup, expect = case(name, *base)
    mirror, curve = walk(inp, params, warmup)
    stats, plain_curve = tbt.sweep(inp, params, warmup=warmup, return_curve=True,
                                   device="cpu")
    assert_bit_identical(mirror, stats, plain_curve, curve)
    trades = mirror["total_trades"]
    assert trades.sum() > 0
    if expect == "huge_sl_tp":                 # only the end-of-test close
        assert (trades == 1).all()
    elif expect == "tiny_sl_tp":               # a close on the candle after each entry
        assert trades.min() > 100 and (mirror["n_r"] > T_BASE // 2).all()
    elif expect == "late_warmup":              # nothing is booked before warmup
        assert (mirror["n_r"] <= 1 + T_BASE - warmup).all()
        assert (curve[:, :warmup + 1] == BALANCE).all()
    elif isinstance(expect, dict):             # both exits hit with equality
        assert expect["exits"][1] < 2000
        close, x = inp.close.numpy(), expect["exits"]
        e1, e2 = expect["entries"]
        assert _pnl_pct(close, e1, x[0]) == inp.tp_pct[e1].item()
        assert _pnl_pct(close, e2, x[1]) == -inp.sl_pct[e2].item()
        # every strategy closes at the first tie candle: its curve steps there
        assert (curve[:, x[0]] != curve[:, x[0] - 1]).all()
        assert (curve[:, x[1]] != curve[:, x[1] - 1]).all()


@pytest.mark.parametrize("name", ROW_CASES)
def test_walk_matches_plain_loop_bit_for_bit_on_rows(base, name):
    inp, params, warmup = rows_case(name, *base)
    assert inp.signal.ndim == 2 and inp.close.ndim == 1
    mirror, curve = walk(inp, params, warmup)
    stats, plain_curve = tbt.sweep(inp, params, warmup=warmup, return_curve=True,
                                   device="cpu")
    assert_bit_identical(mirror, stats, plain_curve, curve)
    trades = mirror["total_trades"]
    assert trades.sum() > 0 and len(np.unique(trades)) > 4
    if name == "rows_exact_tie":
        # the tie rows close at both tie candles, as the shared form does
        _, info = exact_tie(base[0])
        for x in info["exits"]:
            assert (curve[0::2, x] != curve[0::2, x - 1]).all()
    # a row equal to the shared stream walks as the shared form does
    one = type(inp)(*(x[3] if x.ndim == 2 else x for x in inp))
    p3 = params._replace(**{f: getattr(params, f)[3:4] for f in params._fields})
    alone, _ = walk(one, p3, warmup)
    for f in alone:
        np.testing.assert_array_equal(_bits(alone[f]), _bits(mirror[f][3:4]), err_msg=f)


def test_walk_matches_jax_sweep():
    _, jinp = make_inputs(1500)
    jparams = jbt.sample_params(jax.random.PRNGKey(0), 24)
    tin, tpar = to_port(jinp, jparams)
    mirror, _ = walk(tin, tpar)
    ref = jbt.sweep(jinp, jparams)
    assert_stats_equal(ref, tbt.BacktestStats(**{k: torch.from_numpy(v)
                                                 for k, v in mirror.items()}))
    assert int(np.sum(np.asarray(ref.total_trades))) > 0


def test_gate_mask_plain_rows_form(base):
    """[B, T] gate streams give one mask row per strategy, each the mask of
    that strategy's streams alone and replay_step's gate."""
    inp, params, warmup = rows_case("rows_gates", *base)
    words = gate_mask_plain(inp, THR, MIN_STRENGTH, warmup)
    B = int(params.stop_loss.shape[0])
    assert words.dtype == torch.int32 and words.shape == (B, -(-T_BASE // 32))
    for j in (0, 5, B - 1):
        one = type(inp)(*(x[j] if x.ndim == 2 else x for x in inp))
        assert torch.equal(words[j], gate_mask_plain(one, THR, MIN_STRENGTH, warmup))
    bits = ((words.to(torch.int64)[..., None] >> torch.arange(32)) & 1).flatten(1).bool()
    step = engine.replay_step(tbt.default_params(device="cpu"), warmup=warmup,
                              ai_confidence_threshold=THR, min_signal_strength=MIN_STRENGTH,
                              reference_quirks=False, use_param_sl_tp=True,
                              return_curve=False, sell_exits=False)
    state = engine._init_state(BALANCE, (B, T_BASE), torch.device("cpu"))
    after, _ = step(state, (torch.arange(T_BASE),) + tuple(inp))
    assert torch.equal(bits[:, :T_BASE], after.in_pos)
    assert (after.in_pos.sum(1) != after.in_pos[0].sum()).any()


def test_run_backtest_on_per_genome_rows_matches_jax_population_backtest():
    """The input `population_backtest` gives `run_backtest`: one close
    series, per-genome signal/strength/volatility/SL/TP rows.  On the card
    it takes the kernel's rows form; here the plain loop, against the JAX
    package's vmapped replay."""
    import jax.numpy as jnp

    from ai_crypto_trader_tpu.backtest import evolvable as jev
    from ai_crypto_trader_tpu.data import generate_ohlcv as jax_generate

    d = {k: jnp.asarray(v[:1024]) for k, v in jax_generate(n=1024, seed=3).items()
         if k != "regime"}
    pop = jbt.sample_params(jax.random.PRNGKey(5), 12)
    ref = jev.population_backtest(d, pop)
    rows = jax.jit(jax.vmap(lambda p: jev.evolvable_inputs(d, p)))(pop)
    shared = {"close", "volume", "confidence"}
    tin = convert.inputs_from_numpy({k: np.asarray(getattr(rows, k))[0] if k in shared
                                     else np.asarray(getattr(rows, k))
                                     for k in rows._fields}, device="cpu")
    assert tin.close.shape == (1024,) and tin.sl_pct.shape == (12, 1024)
    got = tbt.run_backtest(tin, convert.params_from_numpy(pop, device="cpu"),
                           use_param_sl_tp=True, min_signal_strength=50.0, device="cpu")
    assert got.total_trades.shape == (12,)
    assert_stats_equal(ref, got)
    assert int(np.sum(np.asarray(ref.total_trades))) > 0


@pytest.mark.parametrize("warmup,gated", [(10, False), (1234, True)])
def test_gate_mask_plain_matches_replay_step(base, warmup, gated):
    inp = base[0]
    if gated:
        conf = torch.where(torch.arange(T_BASE) % 3 == 0, 0.9, 0.2).to(torch.float32)
        inp = inp._replace(confidence=conf)
    T = T_BASE + 5                                  # a ragged last word
    inp = type(inp)(*(torch.cat([x, x[:5]]) for x in inp))
    words = gate_mask_plain(inp, THR, MIN_STRENGTH, warmup)
    assert words.dtype == torch.int32 and words.shape == (-(-T // 32),)
    bits = ((words.to(torch.int64)[:, None] >> torch.arange(32)) & 1).flatten().bool()
    # replay_step on a flat state, one candle per element: in_pos after the
    # step is the gate
    step = engine.replay_step(tbt.default_params(device="cpu"), warmup=warmup, ai_confidence_threshold=THR,
                              min_signal_strength=MIN_STRENGTH, reference_quirks=False,
                              use_param_sl_tp=True, return_curve=False, sell_exits=False)
    state = engine._init_state(BALANCE, (T,), torch.device("cpu"))
    after, _ = step(state, (torch.arange(T),) + tuple(inp))
    assert torch.equal(bits[:T], after.in_pos)
    assert not bits[T:].any()
    assert after.in_pos.any() and not after.in_pos[:warmup].any()
