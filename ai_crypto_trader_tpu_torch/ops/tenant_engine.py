"""Tenant decision engine: every tenant's gate and size decisions for one
tick as one device program and one host read.

Port of `ai_crypto_trader_tpu/ops/tenant_engine.py`.  Tenants are data, a
leading axis of N lanes:

  * **strategy params** (confidence threshold, strength floor, position
    cap, min trade size, fee rate, live SL/TP overrides, the quarantine
    cooldown) as [N] tensors;
  * **position state** (open/pending flags, entry, quantity, SL/TP, quote
    balance, the PnL carry, the quarantine bit) as [N, S] / [N] tensors
    that stay on the device from one decide to the next;
  * **the decision program** (`_decide_program`): the analyzer's verdict
    (confidence = min(strength/100, 1) · scale rounded to 3 decimals,
    decision = the technical signal) and the executor's gates as
    predicates that resolve, in `obs.flightrec.VETO_ORDER`, to one int8
    gate id (an index into `obs.flightrec.GATES`) per (tenant, symbol),
    plus the executor's `position_size` sizing.

Within a tick the symbols are sequential, as the executor drains them:
symbol k + 1 sees symbol k's entry in the open count and the balance.  The
JAX program threads (open count, balance) through a `lax.scan` over S;
here it is a loop over S on [N] vectors.  Whatever does not read that
carry (confidence, decision, the NaN gate, the floors, not_buy,
signal_disagreement, position_open, pending_intent, the volatility
ladder) is computed once over [N, S] before the loop, which keeps only the
sizing, max_positions, risk_min_size and the carry update inside it.
Elementwise operations give the same bits either way.  XLA fuses the
balance carry's ``balance − size·(1 + fee)`` into one multiply-add on the
CPU; the port rounds it once too (`device.minus_product`), so its carry is
the JAX program's bit for bit, on the card as on the CPU.

One host read a decide and no other synchronizing call: features go up
from pinned staging with ``non_blocking=True``; the output table, the new
state and, when the fleet observatory (`obs.fleetscope`) is active, the
fleet aggregates are packed into one float32 tensor, copied once into
pinned memory and an event recorded; the module-level `host_read` waits on
it and unpacks with the JAX package's dtypes and shapes (the tick engine's
pattern).  A set/sync/revert/heal/restore changes the host mirror and marks
it dirty; the next decide re-seeds the device state from it.

Fault containment: NaN/Inf anywhere in a lane's state or strategy params
sets the lane's quarantine bit (sticky), and every decision of that lane
resolves to ``lane_quarantined``; its neighbours' values are untouched.
NaN in ``sl_override`` / ``tp_override`` means "no override" and is not
poison.  The tenant axis pads to a power of two (at least 8), and the
symbol axis to the tick engine's pad, because `feats_from_tick` slices the
tick engine's [S_pad, F] table.

With `utils.devprof` active the first decide takes the ``tenant_engine``
cost card and the state's donation check (the decide returns the state
anew; the old one must be released once replaced); with `utils.meshprof`
active the decide through its one host read runs in a ``tenant_engine``
watch window, the first decide of a shape cold.  The JAX engine's
tick-path seam (`obs.tickpath`) is not part of the port yet; with
`utils.tracing` active `feats_from_tick` is a ``tenant.feats`` span and a
decide a ``tenant.decide`` span (attributes ``lanes``, ``full_seed``,
``upload_bytes``) holding ``tenant.upload`` (the state's seed and the
features' staging), ``tenant.dispatch`` (the program's enqueue and its
read-back copy; ``device_ms`` on the card) and ``tenant.read`` (the one
read).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.backtest.signals import ladder_size, size_ladder
from ai_crypto_trader_tpu_torch.config import TradingParams
from ai_crypto_trader_tpu_torch.device import (
    canonical_precision,
    div_const,
    minus_product,
    resolve_device,
)
from ai_crypto_trader_tpu_torch.obs import fleetscope
from ai_crypto_trader_tpu_torch.obs.flightrec import GATES, VETO_ORDER
from ai_crypto_trader_tpu_torch.ops.tick_engine import Readback, read_packed
from ai_crypto_trader_tpu_torch.ops.tick_engine import _pad_symbols as _pad_pow2
from ai_crypto_trader_tpu_torch.parallel.partitioner import resolve_partitioner
from ai_crypto_trader_tpu_torch.utils import devprof, meshprof, tracing
from ai_crypto_trader_tpu_torch.utils.journal import pack_array, unpack_array

#: gate id for "no gate fired: the decision is executable"
EXECUTABLE = -1
#: gate id for "no decision existed" (warming or padded symbol lane, padded
#: or deactivated tenant), never counted as a veto
NO_DECISION = -2

#: gate name -> int8 id (an index into `GATES`)
GATE_ID = {name: int(GATES.index(name)) for name in VETO_ORDER}
GATE_NAME = {i: name for name, i in GATE_ID.items()}

#: feature columns the decision program reads, in staging order
FEATURE_KEYS = ("price", "signal", "strength", "volatility", "avg_volume",
                "valid")

#: decides a poisoned lane stays quarantined before the host healer may
#: re-seed it from venue truth
DEFAULT_QUARANTINE_COOLDOWN = 8

#: the gates that do not read the (open count, balance) carry, in
#: VETO_ORDER; the two that do (max_positions, risk_min_size) come last
_STATIC_GATES = VETO_ORDER[:-2]
assert VETO_ORDER[-2:] == ("max_positions", "risk_min_size")

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int8: np.int8, torch.bool: np.bool_}


def host_read(readback: Readback) -> dict:
    """THE per-decide device→host sync: wait for the decide's one copy into
    pinned memory and unpack it into ``{"out": …, "state": …[, "fleet":
    …]}`` of NumPy arrays.  A module-level seam, so tests can wrap it with
    a counting double.  Timed into the ``host_read`` SLO window and the
    meshprof sanctioned-transfer scope."""
    t0 = time.perf_counter()
    with meshprof.allow_transfers():   # THE sanctioned device→host sync
        out = read_packed(readback)
    devprof.observe_latency("host_read", time.perf_counter() - t0)
    return out


def tenant_params(n: int, trading=None, *, confidence_scale: float = 0.9,
                  fee_rate: float = 0.001,
                  quarantine_cooldown: int = DEFAULT_QUARANTINE_COOLDOWN,
                  ) -> dict:
    """Struct-of-arrays tenant params ([N] NumPy leaves) seeded from one
    `TradingParams` (every tenant identical); heterogeneous fleets
    overwrite rows.  ``confidence_scale`` is the deterministic analyzer's
    strength→confidence factor; ``fee_rate`` mirrors the venue's taker fee
    so the balance carry tracks venue truth."""
    t = trading or TradingParams()
    full = lambda v, dt=np.float32: np.full((n,), v, dt)   # noqa: E731
    return {
        "conf_threshold": full(t.ai_confidence_threshold),
        "min_strength": full(t.min_signal_strength),
        "max_positions": full(t.max_positions, np.int32),
        "min_trade": full(t.min_trade_amount),
        "conf_scale": full(confidence_scale),
        "fee_rate": full(fee_rate),
        # live strategy-param overrides; NaN = none (the sizer's
        # volatility-ladder SL/TP applies)
        "sl_override": full(np.nan),
        "tp_override": full(np.nan),
        "active": np.ones((n,), bool),
        # decides a poisoned lane sits quarantined before it may heal
        "cooldown_ticks": full(quarantine_cooldown, np.int32),
    }


def _decide_program(state: dict, params: dict, feats: dict, *,
                    containment: bool = True, fleet_k: int | None = None,
                    s_real: int | None = None):
    """One decide over every (tenant, symbol) lane, on the device of the
    tensors.  Returns ``(out, new_state, fleet)``; ``fleet`` is None unless
    ``fleet_k`` is given, and then the fleet aggregates over the first
    ``s_real`` symbol columns (pad columns are structurally NO_DECISION)."""
    st, pr = state, params
    N, S = st["open"].shape
    fin = torch.isfinite
    price, sig = feats["price"], feats["signal"]
    strength, vol, avol = feats["strength"], feats["volatility"], feats["avg_volume"]
    valid = feats["valid"]

    # -- lane poison detector (fault containment) --------------------------
    if containment:
        lane_ok = (fin(st["balance"]) & fin(st["equity0"])
                   & fin(st["peak_equity"]) & fin(st["max_drawdown"])
                   & fin(st["entry"]).all(1) & fin(st["qty"]).all(1)
                   & fin(st["sl"]).all(1) & fin(st["tp"]).all(1)
                   & fin(pr["conf_threshold"]) & fin(pr["min_strength"])
                   & fin(pr["min_trade"]) & fin(pr["conf_scale"])
                   & fin(pr["fee_rate"]))
        poisoned = ~lane_ok
        newly = poisoned & ~st["quarantined"]
        quarantined = st["quarantined"] | poisoned
        # the cooldown arms on the quarantine edge and counts decides from
        # there (the poison persists in state until the healer re-seeds)
        cooldown = torch.where(
            newly, pr["cooldown_ticks"],
            torch.clamp_min(st["cooldown"] - quarantined.to(torch.int32), 0))
    else:
        quarantined, cooldown = st["quarantined"], st["cooldown"]

    # -- everything that does not read the carry, over [N, S] --------------
    conf = torch.clamp_max(div_const(strength, 100.0), 1.0)[None, :] \
        * pr["conf_scale"][:, None]
    conf = div_const(torch.round(conf * 1e3), 1e3)
    decision = torch.sign(sig).to(torch.int8)
    preds = {
        "lane_quarantined": quarantined[:, None] if containment else None,
        "nan_gate": (~(fin(price) & (price > 0.0)))[None, :] | ~fin(conf)
        | (~fin(strength) | ~fin(vol) | ~fin(avol))[None, :],
        "confidence_floor": conf < pr["conf_threshold"][:, None],
        "strength_floor": strength[None, :] < pr["min_strength"][:, None],
        "not_buy": (decision != 1)[None, :],
        "signal_disagreement": (sig.to(torch.int8) != decision)[None, :],
        "position_open": st["open"],
        "pending_intent": st["pending"],
    }
    # first gate in VETO_ORDER wins: back to front, the earliest overwrites
    static = torch.full((N, S), EXECUTABLE, dtype=torch.int8, device=price.device)
    for name in reversed(_STATIC_GATES):
        if preds[name] is not None:
            static = torch.where(preds[name], GATE_ID[name], static)
    live = valid[None, :] & pr["active"][:, None]
    cand = live & (static == EXECUTABLE)
    resolved = torch.where(live, static, NO_DECISION)
    pct, sl_frac, vfac = size_ladder(vol, avol)
    fee1 = (1.0 + pr["fee_rate"]).double()
    # the loop's gate ids as [N] tensors, so no select fills one per symbol
    const = lambda v: torch.full((N,), v, dtype=torch.int8, device=price.device)  # noqa: E731
    g_maxp, g_size, g_exec = (const(GATE_ID["max_positions"]),
                              const(GATE_ID["risk_min_size"]), const(EXECUTABLE))

    # -- the sequential part: sizing on the balance carry ------------------
    n_open = st["open"].to(torch.int32).sum(1).to(torch.int32)
    bal = st["balance"]
    gates, oks, sizes = [], [], []
    for s in range(S):
        size = ladder_size(bal, pct[s], sl_frac[s], vfac[s])
        size = torch.minimum(size, bal * 0.95)
        dyn = torch.where(n_open >= pr["max_positions"], g_maxp,
                          torch.where(size < pr["min_trade"], g_size, g_exec))
        gate = torch.where(cand[:, s], dyn, resolved[:, s])
        ok = gate == EXECUTABLE
        n_open = n_open + ok.to(torch.int32)
        bal = torch.where(ok, minus_product(bal, size, fee1), bal)
        gates.append(gate)
        oks.append(ok)
        sizes.append(size)
    gate = torch.stack(gates, 1)
    ok = torch.stack(oks, 1)
    size = torch.stack(sizes, 1)

    sl = torch.where(fin(pr["sl_override"])[:, None], pr["sl_override"][:, None],
                     (sl_frac * 100.0)[None, :])
    tp = torch.where(fin(pr["tp_override"])[:, None], pr["tp_override"][:, None],
                     (sl_frac * 2.0 * 100.0)[None, :])
    qty = torch.where(ok, size / torch.where(price > 0.0, price, 1.0)[None, :], 0.0)
    new_state = {
        "open": st["open"] | ok,
        "pending": st["pending"],
        "entry": torch.where(ok, price[None, :], st["entry"]),
        "qty": torch.where(ok, qty, st["qty"]),
        "sl": torch.where(ok, sl, st["sl"]),
        "tp": torch.where(ok, tp, st["tp"]),
        "balance": bal,
    }
    # mark-to-market equity: stale symbols (invalid this tick) mark at
    # their entry price; the positions' value is summed in a fixed order
    price_eff = torch.where((valid & (price > 0.0))[None, :], price[None, :],
                            new_state["entry"])
    pos_val = _row_sum(torch.where(new_state["open"], new_state["qty"] * price_eff, 0.0))
    equity = bal + pos_val
    peak = torch.maximum(st["peak_equity"], equity)
    new_state.update({
        "equity0": st["equity0"],
        "peak_equity": peak,
        "max_drawdown": torch.maximum(st["max_drawdown"], peak - equity),
        "quarantined": quarantined,
        "cooldown": cooldown,
    })
    out = {"gate": gate, "decision": decision[None, :].expand(N, S),
           "confidence": conf, "size": size, "qty": qty,
           "sl_pct": sl, "tp_pct": tp, "exec": ok, "equity": equity}
    return out, new_state, _fleet(out, new_state, pr, fleet_k, s_real)


def _fleet(out: dict, new_state: dict, params: dict, fleet_k: int | None, s_real):
    """The fleet aggregates of a decide's whole tenant axis (None without
    ``fleet_k``), over the first ``s_real`` symbol columns."""
    if fleet_k is None:
        return None
    return fleetscope.device_aggregates(
        gate=out["gate"][:, :s_real], pnl=out["equity"] - new_state["equity0"],
        balance=new_state["balance"], max_drawdown=new_state["max_drawdown"],
        active=params["active"], quarantined=new_state["quarantined"], k=fleet_k)


def _mesh_decide(part, state: dict, params: dict, feats: dict, *, containment: bool,
                 fleet_k: int | None, s_real: int | None):
    """`_decide_program` with the tenant axis split over ``part``'s mesh:
    state and params are the population, the features ride replicated,
    and the fleet aggregates run over the gathered lanes on the mesh's
    first device."""
    program = part.population_eval(
        lambda pop, f: _decide_program(pop["state"], pop["params"], f,
                                       containment=containment)[:2],
        name="tenant_engine")
    out, new_state = program({"state": state, "params": params}, feats)
    return out, new_state, _fleet(out, new_state, params, fleet_k, s_real)


def _row_sum(x):
    """Sum over the last axis in one fixed order on every device: left to
    right, as XLA reduces a short row on the CPU."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _pack(groups: dict):
    """``{group: {leaf: tensor}}`` as one float32 tensor and the layout that
    unpacks it ([("group/leaf", shape, numpy dtype)])."""
    leaves = [(f"{g}/{k}", v) for g, tree in groups.items() for k, v in tree.items()]
    flat = torch.cat([v.reshape(-1).to(torch.float32) for _, v in leaves])
    return flat, [(k, tuple(v.shape), _NP_DTYPES[v.dtype]) for k, v in leaves]


class TenantEngine:
    """Host side: the tenant state and param mirrors, the one-program /
    one-read decide, and venue-truth corrections.

    ``decide(feats)`` runs the whole [N_pad, S] decision table and reads
    the host once; ``configure(n)`` resizes the tenant axis;
    ``revert_entry`` / ``sync_positions`` / ``sync_balance`` patch the
    mirror when the venue disagrees with the engine's optimistic entry,
    and the next decide re-seeds the device state from it.

    ``partitioner`` (None: the single device) may be a
    `parallel.MeshPartitioner`: the tenant axis then splits over its mesh
    (a ragged count pads by repeating the last tenant), the features ride
    replicated, and state, outputs and the fleet aggregates are gathered
    onto the mesh's first device, where the engine keeps its state;
    ``device`` is then that device.  ``precision`` takes the JAX package's
    matmul-precision vocabulary (`device.PRECISIONS`); the decide has no
    matrix product, so no value changes with it.  ``device=None`` means
    the CUDA card (``RuntimeError`` without one); ``device="cpu"`` runs
    the program on the CPU.
    """

    def __init__(self, symbols, n_tenants: int, trading=None, *,
                 partitioner=None, quote_balance: float = 10_000.0,
                 confidence_scale: float = 0.9, fee_rate: float = 0.001,
                 pad_pow2: bool = True, containment: bool = True,
                 quarantine_cooldown: int = DEFAULT_QUARANTINE_COOLDOWN,
                 precision: str | None = None, device=None):
        self.partitioner = resolve_partitioner(partitioner)
        canonical_precision(precision)         # validate eagerly, fail loud
        self.precision = precision
        self.device = (self.partitioner.home if self.partitioner.device_count > 1
                       else resolve_device(device))
        self.symbols = list(symbols)
        self.sym_index = {s: i for i, s in enumerate(self.symbols)}
        self.S = _pad_pow2(len(self.symbols))      # the tick engine's pad
        self.quote_balance = float(quote_balance)
        self.confidence_scale = float(confidence_scale)
        self.fee_rate = float(fee_rate)
        self.pad_pow2 = bool(pad_pow2)
        self.containment = bool(containment)
        self.quarantine_cooldown = int(quarantine_cooldown)
        self.trading = trading
        self.dispatch_count = 0
        self.full_seeds = 0
        self.last_stats: dict = {}
        self.last_out: dict | None = None
        # fleet observatory: the newest decide's aggregates, and the
        # venue-truth re-anchor accounting
        self.last_fleet: dict | None = None
        self.balance_resyncs = 0
        self._drift_pending = 0.0
        # lifetime containment counters (a reconfigure resets lane state,
        # not the history of the process)
        self.quarantine_trips = 0
        self.heals_total = 0
        self._feat_staging = None
        self._out_host = None
        self.configure(n_tenants)

    # -- shape / state lifecycle ---------------------------------------------
    def configure(self, n_tenants: int, trading=None) -> None:
        """(Re)build the tenant axis: fresh params and flat position
        state."""
        if trading is not None:
            self.trading = trading
        self.n_tenants = int(n_tenants)
        self.n_pad = (_pad_pow2(self.n_tenants) if self.pad_pow2
                      else self.n_tenants)
        N, S = self.n_pad, self.S
        self._params_np = tenant_params(
            N, self.trading, confidence_scale=self.confidence_scale,
            fee_rate=self.fee_rate,
            quarantine_cooldown=self.quarantine_cooldown)
        self._params_np["active"][self.n_tenants:] = False
        self._state_np = {
            "open": np.zeros((N, S), bool),
            "pending": np.zeros((N, S), bool),
            "entry": np.zeros((N, S), np.float32),
            "qty": np.zeros((N, S), np.float32),
            "sl": np.zeros((N, S), np.float32),
            "tp": np.zeros((N, S), np.float32),
            "balance": np.full((N,), self.quote_balance, np.float32),
            # the lane's seeded equity (rolling PnL = equity − this) and
            # the monotone peak / max-drawdown fold
            "equity0": np.full((N,), self.quote_balance, np.float32),
            "peak_equity": np.full((N,), self.quote_balance, np.float32),
            "max_drawdown": np.zeros((N,), np.float32),
            # fault containment: the quarantine bit and heal cooldown
            "quarantined": np.zeros((N,), bool),
            "cooldown": np.zeros((N,), np.int32),
        }
        self._dev_state = None
        self._dev_params = None
        self._need_seed = True
        self._cold = True                  # a new shape: its first decide

    def set_tenant(self, i: int, *, balance: float | None = None,
                   open_symbols=(), pending_symbols=(), **params) -> None:
        """Overwrite one tenant's param and state rows.  Param keys are
        `tenant_params` fields; the next decide re-seeds."""
        for k, v in params.items():
            self._params_np[k][i] = v
        if balance is not None:
            self._state_np["balance"][i] = balance
            # a provisioned balance re-bases the lane's PnL accounting
            self._state_np["equity0"][i] = balance
            self._state_np["peak_equity"][i] = balance
            self._state_np["max_drawdown"][i] = 0.0
        for sym in open_symbols:
            self._state_np["open"][i, self.sym_index[sym]] = True
        for sym in pending_symbols:
            self._state_np["pending"][i, self.sym_index[sym]] = True
        self._need_seed = True

    def set_live_overrides(self, stop_loss=None, take_profit=None) -> None:
        """The fleet-wide live SL/TP hot-swap: every row is overwritten,
        per-tenant values included; None/NaN clears.  A no-op when the
        full arrays already hold these values, else the next decide
        re-seeds."""
        p = self._params_np
        sl = np.full_like(p["sl_override"],
                          np.nan if stop_loss is None else stop_loss)
        tp = np.full_like(p["tp_override"],
                          np.nan if take_profit is None else take_profit)
        if (np.array_equal(p["sl_override"], sl, equal_nan=True)
                and np.array_equal(p["tp_override"], tp, equal_nan=True)):
            return
        p["sl_override"] = sl
        p["tp_override"] = tp
        self._need_seed = True

    def sync_positions(self, tenant: int, held_symbols) -> bool:
        """Venue truth for the position set: clear the rows of symbols the
        executor no longer holds (a protective SL/TP fill closed them), so
        a stale open flag neither vetoes re-entry nor holds a
        max_positions slot.  The balance credit rides `sync_balance`."""
        held = np.zeros(self.S, bool)
        for sym in held_symbols:
            s = self.sym_index.get(sym)
            if s is not None:
                held[s] = True
        st = self._state_np
        stale = st["open"][tenant] & ~held
        if not stale.any():
            return False
        st["open"][tenant, stale] = False
        st["entry"][tenant, stale] = 0.0
        st["qty"][tenant, stale] = 0.0
        self._need_seed = True
        return True

    def sync_balance(self, tenant: int, venue_balance: float,
                     rel_tol: float = 1e-5, expected: bool = False) -> bool:
        """Venue truth for the quote balance: re-anchor the lane when it
        diverges by more than ``rel_tol`` (float32 carry against the
        venue's float64).  ``expected=True`` marks a divergence the rim can
        explain (a closure it just learned); an unexplained one feeds the
        fleet observatory's balance-drift input."""
        cur = float(self._state_np["balance"][tenant])
        ref = max(abs(cur), abs(float(venue_balance)), 1.0)
        drift = abs(cur - float(venue_balance)) / ref
        if drift <= rel_tol:
            return False
        self.balance_resyncs += 1
        if not expected:
            # folded into the next decide's fleetscope observe, reset there
            self._drift_pending = max(self._drift_pending, drift)
        self._state_np["balance"][tenant] = np.float32(venue_balance)
        self._need_seed = True
        return True

    def revert_entry(self, tenant: int, symbol: str | int) -> None:
        """The optimistic entry for (tenant, symbol) did not land (rejected
        order, balance drift): refund the balance carry, clear the
        position row, re-seed on the next decide."""
        s = (symbol if isinstance(symbol, (int, np.integer))
             else self.sym_index[symbol])
        st = self._state_np
        if not st["open"][tenant, s]:
            return
        spent = st["qty"][tenant, s] * st["entry"][tenant, s]
        st["balance"][tenant] += spent * (1.0 + self.fee_rate)
        st["open"][tenant, s] = False
        st["entry"][tenant, s] = 0.0
        st["qty"][tenant, s] = 0.0
        self._need_seed = True

    # -- feature assembly -----------------------------------------------------
    def feats_from_tick(self, tick_out: dict, tick_valid, frame: int = 0,
                        due_mask=None) -> dict:
        """[S] feature columns straight from the tick engine's host output
        (`TickEngine.last_out` / `last_valid`).  ``due_mask`` marks the
        symbols the monitor published this tick."""
        S = self.S
        with tracing.span("tenant.feats", service="tenant") as sp:
            take = lambda a: np.asarray(a[:S, frame], np.float32)  # noqa: E731
            valid = np.asarray(tick_valid[:S, frame], bool)
            if due_mask is not None:
                valid = valid & np.asarray(due_mask[:S], bool)
            sp.set_attribute("symbols", int(valid.sum()))
            return {
                "price": take(tick_out["current_price"]),
                "signal": np.asarray(tick_out["signal"][:S, frame], np.int32),
                "strength": take(tick_out["signal_strength"]),
                "volatility": take(tick_out["volatility"]),
                "avg_volume": take(tick_out["avg_volume"]),
                "valid": valid,
            }

    def feats_from_updates(self, updates: dict) -> dict:
        """[S] feature columns from per-symbol market_update payloads."""
        S = self.S
        sig_id = {"BUY": 1, "SELL": -1}
        out = {"price": np.zeros(S, np.float32),
               "signal": np.zeros(S, np.int32),
               "strength": np.zeros(S, np.float32),
               "volatility": np.zeros(S, np.float32),
               "avg_volume": np.zeros(S, np.float32),
               "valid": np.zeros(S, bool)}
        for sym, u in updates.items():
            s = self.sym_index.get(sym)
            if s is None:
                continue
            out["price"][s] = u.get("current_price", 0.0)
            out["signal"][s] = sig_id.get(u.get("signal"), 0)
            out["strength"][s] = u.get("signal_strength", 0.0)
            out["volatility"][s] = u.get("volatility", 0.0)
            out["avg_volume"][s] = u.get("avg_volume", 0.0)
            out["valid"][s] = True
        return out

    # -- device buffers -------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, with no sync: on the card
        from a fresh pinned copy (the host allocator keeps it until the
        copy is done)."""
        src = torch.from_numpy(np.array(arr))
        if self.device.type != "cuda":
            return src
        return src.pin_memory().to(self.device, non_blocking=True)

    def _seed(self) -> int:
        """The device state and params from the host mirrors; returns the
        bytes uploaded."""
        self._dev_state = {k: self._upload(v) for k, v in self._state_np.items()}
        self._dev_params = {k: self._upload(v) for k, v in self._params_np.items()}
        self.full_seeds += 1
        return sum(int(np.asarray(v).nbytes)
                   for v in (*self._state_np.values(), *self._params_np.values()))

    def _upload_feats(self, feats: dict) -> dict:
        """The six [S] feature columns through one pinned float32 staging
        row each (int and bool columns are small and exact in float32) and
        one copy; split and cast back on the device."""
        S = self.S
        if self._feat_staging is None:
            self._feat_staging = torch.empty(
                (len(FEATURE_KEYS), S), dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
        host = self._feat_staging.numpy()
        for j, k in enumerate(FEATURE_KEYS):
            host[j] = np.asarray(feats[k]).reshape(S)
        if self.device.type == "cuda":
            dev = self._feat_staging.to(self.device, non_blocking=True)
        else:
            dev = self._feat_staging.clone()
        cols = dict(zip(FEATURE_KEYS, dev.unbind(0)))
        cols["signal"] = cols["signal"].to(torch.int32)
        cols["valid"] = cols["valid"] != 0.0
        return cols

    def _readback(self, packed: torch.Tensor, layout) -> Readback:
        if self.device.type != "cuda":
            return Readback(packed, None, layout)
        if self._out_host is None or self._out_host.shape != packed.shape:
            self._out_host = torch.empty(packed.shape, dtype=torch.float32,
                                         pin_memory=True)
        self._out_host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return Readback(self._out_host, event, layout)

    # -- the decide step ------------------------------------------------------
    def decide(self, feats: dict) -> dict:
        """ONE program over every (tenant, symbol) lane and ONE host read.
        Returns the trimmed [N, S] output views (gate, decision,
        confidence, size, qty, sl_pct, tp_pct, exec) and the [N] equity;
        the device state stays resident for the next decide.  When the
        fleet observatory is active the same read carries its aggregates
        (``last_fleet``)."""
        with tracing.span("tenant.decide", service="tenant") as sp:
            out = self._decide(feats)
            sp.set_attribute("lanes", self.last_stats["lanes"])
            sp.set_attribute("full_seed", self.last_stats["full_seed"])
            sp.set_attribute("upload_bytes", self.last_stats["upload_bytes"])
        return out

    def _decide(self, feats: dict) -> dict:
        t_step0 = time.perf_counter()
        fs = fleetscope.active()
        upload_bytes = 0
        seeded = self._dev_state is None or self._need_seed
        try:
            with tracing.span("tenant.upload", service="tenant"):
                if seeded:
                    upload_bytes += self._seed()
                feats_dev = self._upload_feats(feats)
            upload_bytes += sum(int(np.asarray(v).nbytes) for v in feats.values())
            # the cost card and the state's donation check on the first
            # carded decide (the state comes back anew: the old one must be
            # released once replaced)
            donation = (devprof.donated(released=self._dev_state)
                        if not devprof.has_card("tenant_engine") else None)
            # a fresh engine's (or a resized tenant axis's) first decide is cold
            with meshprof.watch("tenant_engine", cold=self._cold):
                with tracing.span("tenant.dispatch", service="tenant",
                                  device=self.device):
                    args = (self._dev_state, self._dev_params, feats_dev)
                    program = (_decide_program if self.partitioner.device_count == 1
                               else functools.partial(_mesh_decide, self.partitioner))
                    with devprof.carding("tenant_engine", args) as card:
                        out, new_state, fleet = card.result(program(
                            *args, containment=self.containment,
                            fleet_k=fs.top_k if fs is not None else None,
                            s_real=len(self.symbols)))
                    del args
                    groups = {"out": out, "state": new_state}
                    if fleet is not None:
                        groups["fleet"] = fleet
                    readback = self._readback(*_pack(groups))
                self._dev_state = new_state
                if donation is not None:
                    devprof.verify_donation("tenant_engine", donation,
                                            after=new_state)
                self._cold = False
                self.dispatch_count += 1
                self._need_seed = False
                t_hr = time.perf_counter()
                with tracing.span("tenant.read", service="tenant"):
                    host = host_read(readback)
                host_read_s = time.perf_counter() - t_hr
        except Exception:
            # a mid-step abort leaves the device state unknown: the host
            # mirror is authoritative, so the next decide re-seeds (from
            # fresh staging: a copy from the old one may be pending)
            self._need_seed = True
            self._feat_staging = None
            self._out_host = None
            raise
        prev_q = self._state_np["quarantined"]
        self._state_np = host["state"]        # fresh arrays: the mirror
        # quarantine trip edges: lanes whose bit rose in this decide
        self.quarantine_trips += int(
            (self._state_np["quarantined"] & ~prev_q).sum())
        n = self.n_tenants
        self.last_out = {k: v[:n] for k, v in host["out"].items()}
        self.last_fleet = host["fleet"] if fs is not None else None
        drift, self._drift_pending = self._drift_pending, 0.0
        if fs is not None:
            # drift drains every decide whether or not a scope consumes it
            fs.observe_decide(self.last_fleet, tenants=n,
                              balance_drift=drift,
                              balance_resyncs=self.balance_resyncs,
                              quarantined=int(
                                  self._state_np["quarantined"][:n].sum()),
                              heals=self.heals_total)
        self.last_stats = {
            "dispatches": 1, "tenants": n, "tenant_pad": self.n_pad,
            "symbols": len(self.symbols), "symbol_pad": self.S,
            "lanes": n * len(self.symbols),
            "devices": self.partitioner.device_count, "full_seed": bool(seeded),
            "upload_bytes": int(upload_bytes),
            "host_read_s": host_read_s,
            "step_s": time.perf_counter() - t_step0,
        }
        return self.last_out

    # -- views ---------------------------------------------------------------
    def veto_counts(self, out: dict | None = None) -> dict:
        """{gate_name: count} over the newest decide's [N, S] gate table."""
        out = out or self.last_out
        if not out:
            return {}
        ids = np.asarray(out["gate"], np.int64)
        counts = {}
        for gid, name in GATE_NAME.items():
            c = int((ids == gid).sum())
            if c:
                counts[name] = c
        return counts

    def executable(self, out: dict | None = None) -> list[tuple[int, int]]:
        """(tenant, symbol_index) pairs the newest decide cleared for
        entry, tenant-major, symbols in the carry's order."""
        out = out or self.last_out
        if not out:
            return []
        return [(int(n), int(s)) for n, s in np.argwhere(out["exec"])]

    def open_positions(self) -> int:
        return int(self._state_np["open"][:self.n_tenants].sum())

    def balances(self) -> np.ndarray:
        return self._state_np["balance"][:self.n_tenants].copy()

    def rolling_pnl(self) -> np.ndarray:
        """[N] mark-to-market PnL since each lane's seed: the newest
        decide's equity minus the seeded equity; zeros before the first
        decide."""
        n = self.n_tenants
        if not self.last_out or "equity" not in self.last_out:
            return np.zeros(n, np.float32)
        return (np.asarray(self.last_out["equity"][:n])
                - self._state_np["equity0"][:n])

    def max_drawdowns(self) -> np.ndarray:
        return self._state_np["max_drawdown"][:self.n_tenants].copy()

    # -- fault containment: quarantine views + the host healer ---------------
    def quarantined_lanes(self) -> list[dict]:
        """Per-lane quarantine ledger off the host mirror: lane id, the gate
        it resolves to, decides of cooldown left before it may heal."""
        st = self._state_np
        out = []
        for i in np.nonzero(st["quarantined"][:self.n_tenants])[0]:
            out.append({"lane": int(i), "gate": "lane_quarantined",
                        "cooldown": int(st["cooldown"][i])})
        return out

    def heal_ready(self) -> list[int]:
        """Lanes whose quarantine cooldown has run out: the set the rim
        should re-seed from venue truth with :meth:`heal_lane`."""
        st = self._state_np
        mask = st["quarantined"][:self.n_tenants] \
            & (st["cooldown"][:self.n_tenants] <= 0)
        return [int(i) for i in np.nonzero(mask)[0]]

    def heal_lane(self, i: int, *, balance: float,
                  positions: dict | None = None) -> None:
        """Re-seed one quarantined lane from venue truth: its state rows are
        rebuilt from the venue's quote balance and the executor's position
        book (``positions`` maps symbol -> (entry_price, quantity)), its
        PnL accounting re-bases, and any non-finite strategy param rolls
        back to the fleet default."""
        st = self._state_np
        st["open"][i] = False
        st["pending"][i] = False
        st["entry"][i] = 0.0
        st["qty"][i] = 0.0
        st["sl"][i] = 0.0
        st["tp"][i] = 0.0
        pos_value = 0.0
        for sym, (entry, qty) in (positions or {}).items():
            s = self.sym_index.get(sym)
            if s is None:
                continue
            st["open"][i, s] = True
            st["entry"][i, s] = np.float32(entry)
            st["qty"][i, s] = np.float32(qty)
            pos_value += float(entry) * float(qty)
        st["balance"][i] = np.float32(balance)
        equity = np.float32(float(balance) + pos_value)
        st["equity0"][i] = equity
        st["peak_equity"][i] = equity
        st["max_drawdown"][i] = 0.0
        st["quarantined"][i] = False
        st["cooldown"][i] = 0
        fresh = tenant_params(
            1, self.trading, confidence_scale=self.confidence_scale,
            fee_rate=self.fee_rate,
            quarantine_cooldown=self.quarantine_cooldown)
        for k, v in self._params_np.items():
            if (np.issubdtype(v.dtype, np.floating)
                    and k not in ("sl_override", "tp_override")
                    and not np.isfinite(v[i])):
                v[i] = fresh[k][0]
        self.heals_total += 1
        self._need_seed = True

    # -- durable fleet state: snapshot + restore -----------------------------
    def snapshot(self) -> dict:
        """The lane mirrors (refreshed by the last decide's read, so a
        snapshot costs no sync) as a journal payload: every array packed
        with its own checksum (`utils.journal.pack_array`), plus the
        identity `restore` validates.  The JAX engine's format."""
        return {
            "version": 1,
            "n_tenants": self.n_tenants,
            "symbols": list(self.symbols),
            "dispatches": self.dispatch_count,
            "counters": {"balance_resyncs": self.balance_resyncs,
                         "quarantine_trips": self.quarantine_trips,
                         "heals_total": self.heals_total},
            "state": {k: pack_array(v) for k, v in self._state_np.items()},
            "params": {k: pack_array(v) for k, v in self._params_np.items()},
        }

    def restore(self, payload: dict) -> dict:
        """Rebuild the lane mirrors from a :meth:`snapshot` payload (this
        package's or the JAX engine's): validate the symbol universe,
        re-shape the tenant axis if it changed, unpack every checksummed
        array.  The next decide re-seeds.  Returns restore stats."""
        if payload.get("version") != 1:
            raise ValueError(f"unknown fleet snapshot version: "
                             f"{payload.get('version')!r}")
        if list(payload.get("symbols") or []) != self.symbols:
            raise ValueError("fleet snapshot symbol universe does not "
                             "match this engine")
        n = int(payload["n_tenants"])
        if n != self.n_tenants:
            self.configure(n)
        state = {k: unpack_array(v) for k, v in payload["state"].items()}
        params = {k: unpack_array(v) for k, v in payload["params"].items()}
        for name, mirror, restored in (("state", self._state_np, state),
                                       ("params", self._params_np, params)):
            missing = set(mirror) - set(restored)
            if missing:
                raise ValueError(f"fleet snapshot {name} misses "
                                 f"{sorted(missing)}")
            for k, v in restored.items():
                if k in mirror and v.shape != mirror[k].shape:
                    raise ValueError(
                        f"fleet snapshot {name}[{k}] shape {v.shape} != "
                        f"engine {mirror[k].shape}")
        # known leaves restore verbatim; unknown ones are dropped
        self._state_np.update({k: v for k, v in state.items()
                               if k in self._state_np})
        self._params_np.update({k: v for k, v in params.items()
                                if k in self._params_np})
        counters = payload.get("counters") or {}
        self.balance_resyncs = int(counters.get("balance_resyncs", 0))
        self.quarantine_trips = int(counters.get("quarantine_trips", 0))
        self.heals_total = int(counters.get("heals_total", 0))
        self._need_seed = True
        return {
            "lanes": n,
            "open_positions": self.open_positions(),
            "quarantined": int(
                self._state_np["quarantined"][:n].sum()),
            "snapshot_dispatches": int(payload.get("dispatches", 0)),
        }
