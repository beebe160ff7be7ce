"""The trading cells' reference: a tick's last-candle features and the
tenants' decisions, written plainly.

`tick_features` is what the trader reads of one symbol's newest 1-minute
candle: its close, the signal rule's signal and strength, the volatility
(ATR over close) and the average quote volume, from the indicator table of
the candle window (float64, `indicators`) with the rule in float32
(`signals`).  It also says whether the candle is ``borderline``: whether
one of the rule's inputs lies so near one of its thresholds (a vote's, or
the trend's comparison of close, SMA 20 and SMA 50) that float32's
rounding of the table may put it on the other side (`BANDS`), where a
float32 program may rightly read another signal or strength.

`decide` is one tick of the reference system's executor gates and position
sizing for every tenant and symbol, as the trading configuration states
them: the analyzer's verdict (confidence = min(strength / 100, 1) times
the confidence scale, rounded to 3 decimals; the decision is the signal),
then the gates in the flight recorder's veto order, the first that holds
naming the veto.  The symbols are decided in order within a tick: symbol
k + 1 sees symbol k's entry in the open count and the balance.  A
tenant's state carries from one tick to the next; a lane whose state or
parameters hold a NaN or an infinity is quarantined.  Computed in float32
(the configuration's precision), the balance's ``balance - size * (1 +
fee)`` rounded once, or in `BF16` for the control.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import indicators as ref_ind
from portbench.reference import signals as ref_sig
from portbench.reference.numerics import BF16

#: the flight recorder's gate vocabulary (an append-only list: a decision's
#: gate is its index), and the veto order the executor checks them in
GATES = ("analysis_interval", "outcome_probability", "nan_gate", "confidence_floor",
         "strength_floor", "signal_disagreement", "not_buy", "position_open",
         "pending_intent", "max_positions", "risk_min_size", "entry_rejected",
         "quarantine", "lane_quarantined")
VETO_ORDER = ("lane_quarantined", "nan_gate", "confidence_floor", "strength_floor",
              "not_buy", "signal_disagreement", "position_open", "pending_intent",
              "max_positions", "risk_min_size")
EXECUTABLE = -1
NO_DECISION = -2
MAX_RISK_PER_TRADE = 0.15
FEATURES = ("price", "signal", "strength", "volatility", "avg_volume", "valid")

#: how near a threshold an input of the rule lies on a borderline candle:
#: (column, thresholds, band).  The bands are some ten times the largest
#: gap between a float32 table of the port's and the float64 table on the
#: trading cell's candles (MACD and the SMAs as shares of the close).
BANDS = (("rsi", (35.0, 45.0), 1e-3), ("stoch_k", (20.0, 30.0), 1e-3),
         ("williams_r", (-80.0, -65.0), 1e-3), ("bb_position", (0.2, 0.4), 1e-3),
         ("trend_strength", (5.0, 10.0), 1e-3), ("macd", (0.0,), 1e-5),
         ("close_sma_20", (0.0,), 1e-5), ("sma_20_sma_50", (0.0,), 1e-5))


def borderline(table: dict) -> bool:
    """Whether the newest candle of a float64 table lies within `BANDS` of
    one of the rule's thresholds, or within them of the MACD term's
    unsaturated range."""
    close, sma20, sma50 = (float(table[k][-1]) for k in ("close", "sma_20", "sma_50"))
    at = {k: float(table[k][-1]) for k in ("rsi", "stoch_k", "williams_r", "bb_position")}
    at["trend_strength"] = abs(((close - sma20) / sma20 * 100.0
                                + (close - sma50) / sma50 * 100.0) / 2.0)
    at["macd"] = float(table["macd"][-1]) / close
    at["close_sma_20"] = (close - sma20) / close
    at["sma_20_sma_50"] = (sma20 - sma50) / close
    unsaturated = abs(float(table["macd"][-1])) <= 1.0 + 1e-5 * close
    return unsaturated or any(abs(at[k] - x) <= band for k, xs, band in BANDS for x in xs)


def tick_features(window: dict, fmt: str = "f32") -> dict:
    """The newest candle's features from a window of float32 candles
    (``fmt="bf16"``: the table and the rule in bfloat16), and whether it is
    borderline."""
    cols = ("high", "low", "close", "volume")
    if fmt == "bf16":
        table = ref_ind.indicator_table(*(BF16(window[k]) for k in cols))
        table.update({k: BF16(window[k]) for k in ("close", "volume")})
        edge = False
    else:
        wide = ref_ind.indicator_table(*(np.asarray(window[k], np.float64) for k in cols))
        edge = borderline(dict(wide, close=np.asarray(window["close"], np.float64)))
        table = {k: np.asarray(v, np.float32) for k, v in wide.items()}
        table.update({k: np.asarray(window[k], np.float32) for k in ("close", "volume")})
    s = ref_sig.signal_inputs(table)
    return {"price": float(s["close"][-1]), "signal": int(s["signal"][-1]),
            "strength": float(s["strength"][-1]), "volatility": float(s["volatility"][-1]),
            "avg_volume": float(s["volume"][-1]), "borderline": edge}


def draw_tenants(tenant: dict, n: int, seed: int) -> dict:
    """Each tenant's own settings, [N] arrays drawn from ``seed`` within the
    configuration's ranges: the quote balance log-uniform, the confidence
    threshold, strength floor and position cap uniform."""
    rng = np.random.default_rng(seed)
    lo, hi = tenant["quote_balance"]
    f = np.float32
    return {"balance": np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(f),
            "conf_threshold": rng.uniform(*tenant["confidence_threshold"], n).astype(f),
            "min_strength": rng.uniform(*tenant["min_signal_strength"], n).astype(f),
            "max_positions": rng.integers(tenant["max_positions"][0],
                                          tenant["max_positions"][1] + 1, n).astype(np.int32),
            "min_trade": np.full(n, tenant["min_trade_amount"], f)}


def initial_state(balance: np.ndarray, s: int) -> dict:
    """Flat tenants holding ``balance`` ([N])."""
    n, f = balance.shape[0], np.float32
    balance = np.asarray(balance, f)
    return {"open": np.zeros((n, s), bool), "pending": np.zeros((n, s), bool),
            "entry": np.zeros((n, s), f), "qty": np.zeros((n, s), f),
            "sl": np.zeros((n, s), f), "tp": np.zeros((n, s), f),
            "balance": balance.copy(), "equity0": balance.copy(),
            "peak_equity": balance.copy(), "max_drawdown": np.zeros(n, f),
            "quarantined": np.zeros(n, bool), "cooldown": np.zeros(n, np.int32)}


def tenant_params(tenants: dict, tenant: dict) -> dict:
    """[N] parameters: the drawn settings and the configuration's shared
    ones."""
    n, f = tenants["balance"].shape[0], np.float32
    full = lambda v, dt=f: np.full(n, v, dt)  # noqa: E731
    return {"conf_threshold": tenants["conf_threshold"], "min_strength": tenants["min_strength"],
            "max_positions": tenants["max_positions"], "min_trade": tenants["min_trade"],
            "conf_scale": full(tenant["confidence_scale"]), "fee_rate": full(tenant["fee_rate"]),
            "active": np.ones(n, bool),
            "cooldown_ticks": full(tenant["quarantine_cooldown"], np.int32)}


def decide(state: dict, params: dict, feats: dict, containment: bool = True,
           fmt: str = "f32") -> tuple[dict, dict]:
    """(out, new state) of one tick.  ``feats``: [S] arrays of `FEATURES`;
    out: the [N, S] gate, confidence and size, and the [N] equity."""
    low = (lambda x: BF16(x)) if fmt == "bf16" else (lambda x: np.asarray(x, np.float32))
    f = (lambda v: BF16(np.float32(v))) if fmt == "bf16" else np.float32
    st, pr = state, params
    fin = np.isfinite
    price, strength = low(feats["price"]), low(feats["strength"])
    vol, avol = low(feats["volatility"]), low(feats["avg_volume"])
    sig, valid = np.asarray(feats["signal"]), np.asarray(feats["valid"], bool)
    balance = low(st["balance"])
    N, S = st["open"].shape

    lane_ok = (fin(balance) & fin(st["equity0"]) & fin(st["peak_equity"])
               & fin(st["max_drawdown"]) & fin(st["entry"]).all(1) & fin(st["qty"]).all(1)
               & fin(st["sl"]).all(1) & fin(st["tp"]).all(1)
               & fin(pr["conf_threshold"]) & fin(pr["min_strength"]) & fin(pr["min_trade"])
               & fin(pr["conf_scale"]) & fin(pr["fee_rate"]))
    if not containment:
        lane_ok = np.ones(N, bool)
    newly = ~lane_ok & ~st["quarantined"]
    quarantined = st["quarantined"] | ~lane_ok
    cooldown = np.where(newly, pr["cooldown_ticks"],
                        np.maximum(st["cooldown"] - quarantined.astype(np.int32), 0))

    conf = np.minimum(strength * f(1.0 / 100.0), f(1.0))[None, :] * low(pr["conf_scale"])[:, None]
    conf = np.round(conf * f(1e3)) * f(1.0 / 1e3)
    decision = np.sign(sig).astype(np.int8)
    preds = {
        "lane_quarantined": np.broadcast_to(quarantined[:, None] & containment, (N, S)),
        "nan_gate": (~(fin(price) & (price > 0.0)))[None, :] | ~fin(conf)
        | (~fin(strength) | ~fin(vol) | ~fin(avol))[None, :],
        "confidence_floor": conf < low(pr["conf_threshold"])[:, None],
        "strength_floor": strength[None, :] < low(pr["min_strength"])[:, None],
        "not_buy": np.broadcast_to((decision != 1)[None, :], (N, S)),
        "signal_disagreement": np.broadcast_to((sig.astype(np.int8) != decision)[None, :], (N, S)),
        "position_open": st["open"],
        "pending_intent": st["pending"],
    }
    static = np.full((N, S), EXECUTABLE, np.int8)
    for name in reversed(VETO_ORDER[:-2]):
        static = np.where(preds[name], GATES.index(name), static).astype(np.int8)
    live = valid[None, :] & pr["active"][:, None]
    cand = live & (static == EXECUTABLE)
    resolved = np.where(live, static, NO_DECISION).astype(np.int8)

    hi = vol > 0.02
    mid = ~hi & (vol > 0.01)
    pct = low(np.where(hi, 0.25, np.where(mid, 0.20, 0.15)))
    sl_frac = low(np.where(hi, 0.02, np.where(mid, 0.015, 0.01)))
    vfac = np.minimum(avol * f(1.0 / 50_000.0), f(1.0))
    fee1 = np.float64(np.float32(1.0) + np.float32(pr["fee_rate"][0]))

    n_open = st["open"].sum(1).astype(np.int32)
    bal = balance
    gates, oks, sizes = [], [], []
    for s in range(S):
        size = bal * pct[s] * vfac[s]
        size = np.minimum(size, bal * f(MAX_RISK_PER_TRADE) / sl_frac[s])
        size = np.minimum(size, bal * f(0.20))
        size = np.maximum(size, bal * f(0.10))
        size = np.maximum(size, f(40.0))
        size = np.minimum(size, bal * f(0.95))
        dyn = np.where(n_open >= pr["max_positions"], GATES.index("max_positions"),
                       np.where(size < low(pr["min_trade"]), GATES.index("risk_min_size"),
                                EXECUTABLE))
        gate = np.where(cand[:, s], dyn, resolved[:, s]).astype(np.int8)
        ok = gate == EXECUTABLE
        n_open = n_open + ok.astype(np.int32)
        spent = low(np.asarray(bal, np.float64) - np.asarray(size, np.float64) * fee1)
        bal = np.where(ok, spent, bal)
        if fmt == "bf16":
            bal = BF16(bal)
        gates.append(gate)
        oks.append(ok)
        sizes.append(size)
    gate, ok, size = np.stack(gates, 1), np.stack(oks, 1), np.stack(sizes, 1)

    qty = np.where(ok, size / np.where(price > 0.0, price, f(1.0))[None, :], 0.0)
    new = {"open": st["open"] | ok, "pending": st["pending"],
           "entry": np.where(ok, price[None, :], st["entry"]),
           "qty": np.where(ok, qty, st["qty"]),
           "sl": np.where(ok, (sl_frac * f(100.0))[None, :], st["sl"]),
           "tp": np.where(ok, (sl_frac * f(2.0) * f(100.0))[None, :], st["tp"]),
           "balance": bal}
    price_eff = np.where((valid & (price > 0.0))[None, :], price[None, :], new["entry"])
    held = np.where(new["open"], new["qty"] * price_eff, f(0.0))
    pos_val = held[:, 0]
    for j in range(1, S):
        pos_val = pos_val + held[:, j]
    equity = bal + pos_val
    peak = np.maximum(st["peak_equity"], equity)
    new.update(equity0=st["equity0"], peak_equity=peak,
               max_drawdown=np.maximum(st["max_drawdown"], peak - equity),
               quarantined=quarantined, cooldown=cooldown)
    new = {k: (v if v.dtype.kind in "bi" else np.asarray(v, np.float32)) for k, v in new.items()}
    return {"gate": gate, "confidence": np.asarray(conf, np.float32),
            "size": np.asarray(size, np.float32), "equity": np.asarray(equity, np.float32)}, new
