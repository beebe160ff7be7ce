"""Trade executor service: trading_signals → gated orders → SL/TP/trailing.

Capability parity with TradeExecutorService
(`services/trade_executor_service.py`):
  * `execute_trade` (:816-1046): confidence gate → market BUY → adaptive &
    socially-adjusted SL/TP percentages (:921-976) → protective
    STOP_LOSS_LIMIT + LIMIT take-profit orders (:978-999) → active-trade
    record (:1002-1015) → trailing-stop registration (:1017-1034);
  * trailing-stop maintenance on price updates with stop-order replacement
    (:333) — the stop math is the pure state machine in risk/stops.py;
  * `should_execute_trade` agreement gate (signal == decision == BUY,
    strength ≥ 70, confidence ≥ threshold — `strategy_tester.py:371-401`);
  * max-positions cap and holdings tracking.

Port of `ai_crypto_trader_tpu/shell/executor.py`: the books, the journal
records, the gates and the reconciliation are host code, copied.  What the
JAX executor evaluates in float32 arrays the port evaluates in float32
tensors on ``device`` (None: the CUDA card): the position size
(`position_plan`), the trailing-stop state (`risk.stops`) and the social
adjustment (`risk.social`), so sizes, quantities, SL/TP and stops are the
JAX package's bit for bit.  Every value read back to the host goes through
`host_read` (one read per sizing, one more for the social factors when
the bus holds a `SocialSnapshot`, two per trailing-stop update).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.config import TradingParams, TrailingStopParams
from ai_crypto_trader_tpu_torch.device import resolve_device, upload
from ai_crypto_trader_tpu_torch.risk.social import SocialSnapshot, social_risk_adjustment
from ai_crypto_trader_tpu_torch.risk.stops import (
    trailing_stop_init,
    trailing_stop_update,
)
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.exchange import (
    ExchangeInterface,
    ExchangeUnavailable,
)
from ai_crypto_trader_tpu_torch.utils import meshprof, tracing


def host_read(values: torch.Tensor) -> list:
    """The executor's device→host read: ``values`` (a float32 vector) as
    Python floats, in one copy.  A module-level seam, so a caller can wrap
    it to count the executor's reads; a sanctioned read of the sync guard
    (`utils.meshprof.allow_transfers`)."""
    with meshprof.allow_transfers():
        return values.tolist()


# `risk.social.social_risk_adjustment`'s factors, in its order
_SOCIAL_FACTORS = ("position_size_factor", "stop_loss_factor", "take_profit_factor",
                   "correlation_limit_factor")


def position_plan(balance: float, volatility: float, volume: float,
                  device) -> tuple[float, float, float]:
    """`backtest.signals.position_size` as the JAX executor evaluates it
    eagerly on Python floats: ``(size, stop_loss, take_profit)`` fractions
    as Python floats.

    The Python products and the volume ratio are float64 (Python
    arithmetic, as in the JAX call); each enters the float32 program
    rounded once, and every array operation is float32 — products, true
    divisions, comparisons, minima.  The six inputs go up in one upload and
    the three results come back in one `host_read`."""
    ins = np.array([volatility, balance, volume / 50_000.0,
                    balance * 0.15, balance * 0.20,     # 0.15: max risk a trade
                    balance * 0.10], np.float32)
    vol, cap, vf, cap_risk, cap_hi, cap_lo = upload(ins, device)
    vf = torch.clamp_max(vf, 1.0)
    hi = vol > 0.02
    mid = (~hi) & (vol > 0.01)
    position_pct = torch.where(hi, 0.25, torch.where(mid, 0.20, 0.15))
    sl = torch.where(hi, 0.02, torch.where(mid, 0.015, 0.01))
    size = cap * position_pct * vf
    size = torch.minimum(size, cap_risk / sl)
    size = torch.minimum(size, cap_hi)
    size = torch.maximum(size, cap_lo)
    size = torch.clamp_min(size, 40.0)
    size, sl, tp = host_read(torch.stack([size, sl, sl * 2.0]))
    return size, sl, tp


@dataclass
class ActiveTrade:
    symbol: str
    entry_price: float
    quantity: float
    stop_loss_pct: float
    take_profit_pct: float
    stop_order_id: int | None
    tp_order_id: int | None
    trailing_state: object
    opened_at: float
    # deterministic client order ids (journaled BEFORE placement): the
    # keys that make an ambiguous venue failure resolvable after a crash
    entry_coid: str | None = None
    stop_coid: str | None = None
    tp_coid: str | None = None
    # entry-signal provenance (decision id, dominant combination family,
    # structure/model versions) — journaled with the trade and carried
    # onto the closure record for PnL attribution (obs/attribution.py)
    source: dict | None = None


@dataclass
class TradeExecutor:
    bus: EventBus
    exchange: ExchangeInterface
    trading: TradingParams = field(default_factory=TradingParams)
    trailing: TrailingStopParams = field(default_factory=TrailingStopParams)
    now_fn: any = time.time
    active_trades: dict = field(default_factory=dict)
    closed_trades: list = field(default_factory=list)
    # Crash-safety (utils/journal.py): when a WriteAheadJournal is attached
    # every order intent is durable BEFORE it can hit the exchange and
    # every ack/fill/closure lands after — recover_from_journal() replays
    # this into books and reconciles them against venue ground truth.
    journal: object = None
    coid_prefix: str = "wj"
    # Tenant-lane tag (ROADMAP item 4 / testing/loadgen.py): a lane-scoped
    # executor subscribes to its own `trading_signals.<lane>` channel (the
    # analyzer publishes there — O(N) fanout for N tenants) and drains
    # only signals tagged with ITS lane (belt-and-braces against a
    # pattern-subscribed producer).  None = the one-tenant launcher: the
    # shared `trading_signals` channel, every signal processed, exactly
    # as before.
    lane: str | None = None
    # Decision-provenance flight recorder (obs/flightrec.py), wired by the
    # launcher; None = disabled (one attribute check per call site).
    flightrec: object = None
    # intents whose venue outcome is UNKNOWN (placement raised mid-flight,
    # or journaled intent with no ack found at recovery), keyed by
    # client_order_id; entry for a symbol is blocked while one is pending
    pending_intents: dict = field(default_factory=dict)
    # sibling protective orders whose cancel failed during finalization —
    # retried every tick until dead (a resting orphan that fills would
    # sell inventory backing a newer position)
    orphan_orders: list = field(default_factory=list)
    _coid_seq: int = 0
    _compacted_at: int = 0
    # closures rotated out of snapshots (see snapshot_state): the full
    # per-trade records live in the journal history that was compacted
    # away; count and PnL are conserved here so books stay truthful
    _closed_dropped_n: int = 0
    _closed_dropped_pnl: float = 0.0
    # where the sizing, the trailing stops and the social adjustment
    # compute: None = the CUDA card, "cpu" = the CPU
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    COMPACT_EVERY = 2048           # journal records between snapshots
    SNAPSHOT_CLOSED_TAIL = 1024    # closed trades embedded per snapshot

    # --- journal helpers ---------------------------------------------------
    def _j(self, kind: str, flush: bool = False, **data) -> None:
        if self.journal is not None:
            self.journal.append(kind, data, flush=flush)

    def maybe_compact(self) -> None:
        """Snapshot+compact once the journal grows past COMPACT_EVERY.
        Called only at SAFE points (top of run_once, end of recovery) —
        never mid-operation: a compaction between an order intent record
        and its ack would snapshot state that knows nothing of the
        in-flight order, losing the ambiguity-resolution key."""
        if (self.journal is not None
                and self.journal.seq - self._compacted_at >= self.COMPACT_EVERY):
            self.journal.compact(self.snapshot_state())
            self._compacted_at = self.journal.seq

    def _next_coid(self, tag: str, symbol: str) -> str:
        self._coid_seq += 1
        return f"{self.coid_prefix}-{tag}-{symbol}-{self._coid_seq}"

    # --- gates (strategy_tester.py:371-401 / trade_executor_service.py) ----
    def veto_reason(self, signal: dict) -> str | None:
        """WHICH gate rejects this signal (None = executable) — the single
        source of truth behind ``should_execute`` AND the flight
        recorder's per-decision rejection reason, so the recorded gate can
        never drift from the gate actually applied.

        Gate names AND their evaluation order are the flight recorder's
        shared vocabulary (`obs.flightrec.GATES` / `VETO_ORDER`): the
        vmapped tenant engine (ops/tenant_engine.py) re-expresses these
        same checks as traced predicates resolving in the same priority,
        and the gate-for-gate parity sweep in tests/test_tenant_engine.py
        pins the two paths equal.  Changing a check here without updating
        the traced twin (and VETO_ORDER) fails that sweep."""
        # poisoned-payload gate: a NaN/zero price reaching the sizer would
        # turn into a NaN-quantity order and poison the venue balances —
        # reject non-finite numerics at the door (docs/RESILIENCE.md)
        price = signal.get("current_price", 0.0)
        if not (np.isfinite(price) and price > 0.0):
            return "nan_gate"
        if not all(np.isfinite(signal.get(k, 0.0)) for k in
                   ("confidence", "signal_strength", "volatility",
                    "avg_volume")):
            return "nan_gate"
        if signal.get("confidence", 0.0) < self.trading.ai_confidence_threshold:
            return "confidence_floor"
        if signal.get("signal_strength", 0.0) < self.trading.min_signal_strength:
            return "strength_floor"
        if signal.get("decision") != "BUY":
            return "not_buy"
        if signal.get("signal") != signal.get("decision"):
            return "signal_disagreement"
        if signal["symbol"] in self.active_trades:
            return "position_open"
        # an unresolved intent means the venue MAY already hold a
        # position for this symbol — entering again would be the exact
        # double-order the journal exists to prevent
        if signal["symbol"] in {i.get("symbol")
                                for i in self.pending_intents.values()}:
            return "pending_intent"
        if len(self.active_trades) >= self.trading.max_positions:
            return "max_positions"
        return None

    def should_execute(self, signal: dict) -> bool:
        return self.veto_reason(signal) is None

    def _social_factors(self, symbol: str) -> dict:
        snap = self.bus.get(f"social_snapshot_{symbol}")
        if snap is None:
            return {"position_size_factor": 1.0, "stop_loss_factor": 1.0,
                    "take_profit_factor": 1.0}
        if isinstance(snap, SocialSnapshot):
            # the factors in one host read
            adj = social_risk_adjustment(snap, device=self.device)
            return dict(zip(_SOCIAL_FACTORS, host_read(torch.stack(
                [adj[k] for k in _SOCIAL_FACTORS]))))
        return snap

    async def handle_signal(self, signal: dict) -> ActiveTrade | None:
        """`execute_trade` (:816-1046)."""
        fr = self.flightrec
        did = signal.get("decision_id")
        reason = self.veto_reason(signal)
        if reason is not None:
            if fr is not None:
                fr.veto(did, reason, symbol=signal.get("symbol"))
            return None
        symbol = signal["symbol"]
        balance = self.exchange.get_balances().get("USDC", 0.0)

        plan_size, plan_sl, plan_tp = position_plan(
            balance, signal.get("volatility", 0.01),
            signal.get("avg_volume", 0.0), self.device)
        social = self._social_factors(symbol)
        size = plan_size * social["position_size_factor"]
        size = min(size, balance * 0.95)
        if size < self.trading.min_trade_amount:
            if fr is not None:
                fr.veto(did, "risk_min_size", symbol=symbol,
                        detail=f"sized {size:.2f} < "
                               f"{self.trading.min_trade_amount:.2f}")
            return None
        # sizer fractions interpreted as percent (the corrected semantics;
        # see engine.reference_quirks docs), then socially adjusted
        sl_pct = plan_sl * 100.0 * social["stop_loss_factor"]
        tp_pct = plan_tp * 100.0 * social["take_profit_factor"]
        # Hot-swapped live params take precedence over the volatility sizer's
        # exits: the evolver / generator publish `strategy_params` on the bus
        # (`hot_swap_strategy`, strategy_evolution_service.py:349-362) and
        # the reference executor reads the current strategy at entry time.
        live = self.bus.get("strategy_params") or {}
        if isinstance(live.get("stop_loss"), (int, float)):
            sl_pct = float(live["stop_loss"]) * social["stop_loss_factor"]
        if isinstance(live.get("take_profit"), (int, float)):
            tp_pct = float(live["take_profit"]) * social["take_profit_factor"]

        qty_req = size / signal["current_price"]
        coid = self._next_coid("ent", symbol)
        # entry-signal provenance: journaled with the intent and carried
        # through the trade onto its closure record (PnL attribution)
        source = {"decision_id": did,
                  "family": signal.get("top_family"),
                  "structure_version": signal.get("structure_version"),
                  "model_version": signal.get("model_version")}
        if fr is not None:
            # provenance durable BEFORE the venue can see the order, like
            # the journal intent below — a kill in the placement window
            # must not orphan the venue-side fill from its decision
            fr.execution(did, coid, symbol=symbol, quantity=qty_req,
                         sl_pct=sl_pct, tp_pct=tp_pct)
        # WAL property: the intent is durable BEFORE the order can reach
        # the venue — a crash in the placement window leaves a journaled
        # intent the reconciler resolves by client id (reached? adopt :
        # never arrived? discard), never a silent double-entry hazard.
        self._j("entry_intent", flush=True, symbol=symbol,
                client_order_id=coid, quantity=qty_req, sl_pct=sl_pct,
                tp_pct=tp_pct, coid_seq=self._coid_seq, source=source)
        try:
            order = self.exchange.place_order(symbol, "BUY", "MARKET",
                                              quantity=qty_req,
                                              client_order_id=coid)
        except ExchangeUnavailable:
            # AMBIGUOUS: the request may or may not have reached the venue.
            # Park the intent (blocks re-entry for this symbol) and let
            # resolve_pending_intents() ask the venue by client id once it
            # is reachable again.
            self.pending_intents[coid] = {
                "phase": "entry", "symbol": symbol, "client_order_id": coid,
                "quantity": qty_req, "sl_pct": sl_pct, "tp_pct": tp_pct,
                "source": source}
            self._j("entry_ambiguous", flush=True, symbol=symbol,
                    client_order_id=coid)
            raise
        if order.get("status") != "FILLED":
            self._j("entry_reject", symbol=symbol, client_order_id=coid,
                    status=order.get("status"))
            if fr is not None:
                fr.veto(did, "entry_rejected", symbol=symbol,
                        detail=str(order.get("status")))
            return None
        entry = order["price"]
        qty = order["quantity"]
        if fr is not None:
            fr.fill(coid, entry, qty, symbol=symbol)

        # Register the position BEFORE placing protective orders: if the
        # exchange dies between the fill and the stop placement, the trade
        # must exist on the books (unprotected but managed) rather than be
        # orphaned on the exchange. _ensure_protection retries on every
        # subsequent price update.
        stop_price = entry * (1 - sl_pct / 100.0)
        trade = ActiveTrade(
            symbol=symbol, entry_price=entry, quantity=qty,
            stop_loss_pct=sl_pct, take_profit_pct=tp_pct,
            stop_order_id=None, tp_order_id=None,
            trailing_state=trailing_stop_init(
                entry, stop_price, self.trailing.activation_threshold_pct,
                device=self.device),
            opened_at=self.now_fn(),
            entry_coid=coid,
            source=source,
        )
        self.active_trades[symbol] = trade
        self._j("entry_ack", flush=True, symbol=symbol, client_order_id=coid,
                order_id=order.get("order_id"), price=entry, quantity=qty,
                sl_pct=sl_pct, tp_pct=tp_pct, opened_at=trade.opened_at,
                stop=stop_price, coid_seq=self._coid_seq, source=source)
        try:
            self._ensure_protection(trade)
        except ExchangeUnavailable:
            pass        # trade stays registered; protection retried later
        self.bus.set("active_trades", {s: vars(t) | {"trailing_state": None}
                                       for s, t in self.active_trades.items()})
        await self.bus.publish("trade_executions", {
            "symbol": symbol, "side": "BUY", "price": entry, "quantity": qty,
            "stop_loss_pct": sl_pct, "take_profit_pct": tp_pct})
        return trade

    def _adopt_unacked_leg(self, trade: ActiveTrade, leg: str) -> bool:
        """A protective placement that raised mid-flight may still have
        landed on the venue.  Before placing AGAIN (double-protection =
        double inventory committed to sells), ask the venue about the last
        journaled client id for this leg."""
        coid = trade.stop_coid if leg == "stop" else trade.tp_coid
        if coid is None:
            return False
        found = self.exchange.find_order_by_client_id(trade.symbol, coid)
        if found is None or found.get("order_id") is None:
            return False
        # never adopt a venue-cancelled/expired leg as live protection;
        # FILLED is adopted so the reconcile pass finalizes off its fill
        if found.get("status") not in ("OPEN", "NEW", "PARTIALLY_FILLED",
                                       "FILLED"):
            return False
        oid = found["order_id"]
        if leg == "stop":
            trade.stop_order_id = oid
        else:
            trade.tp_order_id = oid
        self._j("protect_ack", symbol=trade.symbol, leg=leg, order_id=oid,
                client_order_id=coid, adopted=True)
        return True

    def _place_protective(self, trade: ActiveTrade, leg: str) -> None:
        """Place one missing protective leg, intent-journaled so a crash
        between placement and ack is resolvable by client id."""
        symbol = trade.symbol
        if self._adopt_unacked_leg(trade, leg):
            return
        coid = self._next_coid("stp" if leg == "stop" else "tp", symbol)
        if leg == "stop":
            stop_price = self._stop(trade)
            trade.stop_coid = coid
            self._j("protect_intent", flush=True, symbol=symbol, leg=leg,
                    client_order_id=coid, stop=stop_price,
                    coid_seq=self._coid_seq)
            o = self.exchange.place_order(
                symbol, "SELL", "STOP_LOSS_LIMIT", trade.quantity,
                price=stop_price * 0.999, stop_price=stop_price,
                client_order_id=coid)
            trade.stop_order_id = o.get("order_id")
            self._j("protect_ack", symbol=symbol, leg=leg,
                    order_id=trade.stop_order_id, client_order_id=coid,
                    stop=stop_price)
        else:
            tp_price = trade.entry_price * (1 + trade.take_profit_pct / 100.0)
            trade.tp_coid = coid
            self._j("protect_intent", flush=True, symbol=symbol, leg=leg,
                    client_order_id=coid, price=tp_price,
                    coid_seq=self._coid_seq)
            o = self.exchange.place_order(
                symbol, "SELL", "LIMIT", trade.quantity, price=tp_price,
                client_order_id=coid)
            trade.tp_order_id = o.get("order_id")
            self._j("protect_ack", symbol=symbol, leg=leg,
                    order_id=trade.tp_order_id, client_order_id=coid,
                    price=tp_price)

    def _ensure_protection(self, trade: ActiveTrade) -> None:
        """Place whichever protective orders are missing (initial placement
        and post-outage repair share this path). Raises ExchangeUnavailable
        if the exchange is down; callers decide whether to swallow."""
        if trade.stop_order_id is None:
            self._place_protective(trade, "stop")
        if trade.tp_order_id is None:
            self._place_protective(trade, "tp")

    @staticmethod
    def _protective_orders(trade: ActiveTrade):
        """(order_id, close reason, entry-price factor estimating the fill
        price when no fill record is available) for both protective legs."""
        return ((trade.tp_order_id, "Take Profit",
                 1 + trade.take_profit_pct / 100),
                (trade.stop_order_id, "Stop Loss",
                 1 - trade.stop_loss_pct / 100))

    def _reconcile_protective_fills(self, symbol: str, price: float):
        """Detect server-side fills of the protective SL/TP orders and
        finalize the trade — otherwise a filled TP leaves the trade in
        active_trades and a later trailing trigger double-sells."""
        trade = self.active_trades.get(symbol)
        if trade is None:
            return None
        for oid, reason, px_factor in self._protective_orders(trade):
            if oid is not None and not self.exchange.order_is_open(symbol, oid):
                fill = getattr(self.exchange, "last_fill", lambda _o: None)(oid)
                exit_price = (fill.get("price", trade.entry_price * px_factor)
                              if fill else trade.entry_price * px_factor)
                return (reason, exit_price)
        return None

    async def on_price(self, symbol: str, price: float) -> None:
        """Trailing-stop maintenance (`TrailingStopManager.update_price` +
        stop replacement, :142-333), after reconciling protective fills."""
        trade = self.active_trades.get(symbol)
        if trade is None:
            return
        # Reconcile BEFORE repairing: a protective order may have filled
        # server-side during an outage — repairing first would place sells
        # for inventory that is already gone.
        filled = self._reconcile_protective_fills(symbol, price)
        if filled is not None:
            reason, exit_price = filled
            await self._finalize_filled(symbol, exit_price, reason)
            return
        if trade.stop_order_id is None or trade.tp_order_id is None:
            # repair protection lost to an earlier exchange outage
            self._ensure_protection(trade)
        md = self.bus.get(f"market_data_{symbol}") or {}
        prev_stop = self._stop(trade)
        st, triggered = trailing_stop_update(
            trade.trailing_state, price,
            strategy=self.trailing.strategy,
            trail_percent=self.trailing.trail_percent,
            min_trail_distance_pct=self.trailing.min_trail_distance_pct,
            atr=md.get("atr", 0.0),
            atr_multiplier=self.trailing.atr_multiplier,
            volatility=md.get("volatility", 0.0) * price,
            volatility_multiplier=self.trailing.volatility_multiplier,
            fixed_trail_amount=self.trailing.fixed_trail_amount,
            device=self.device)
        trade.trailing_state = st
        new_stop, triggered = host_read(torch.stack(
            [st.stop, triggered.to(torch.float32)]))
        if new_stop > prev_stop and trade.stop_order_id is not None:
            # replace the protective stop order at the ratcheted level;
            # id goes None between cancel and place so a mid-replacement
            # outage is repaired by _ensure_protection, not double-placed
            self.exchange.cancel_order(symbol, trade.stop_order_id)
            self._j("protect_cancel", symbol=symbol, leg="stop",
                    order_id=trade.stop_order_id, reason="trail_ratchet")
            trade.stop_order_id = None
            trade.stop_coid = None         # cancelled leg must not be adopted
            self._place_protective(trade, "stop")
        if bool(triggered):
            await self.close_trade(symbol, price, "Trailing Stop")

    async def _finalize_filled(self, symbol: str, exit_price: float,
                               reason: str) -> None:
        """Close the books on a trade whose protective order already sold
        the position server-side — cancel the sibling order, no re-sell.

        The closure is booked UNCONDITIONALLY: the inventory is already
        gone, so a failing sibling cancel must not abort finalization
        (that leaves the trade popped but unrecorded and the sibling
        resting — an orphan that later fills and sells inventory backing
        a NEWER position; found by the chaos soak).  Un-cancellable
        siblings are parked on ``orphan_orders`` for the per-tick reaper."""
        trade = self.active_trades.pop(symbol, None)
        if trade is None:
            return
        for oid in (trade.stop_order_id, trade.tp_order_id):
            if oid is None:
                continue
            try:
                if self.exchange.order_is_open(symbol, oid):
                    self.exchange.cancel_order(symbol, oid)
                    self._j("protect_cancel", symbol=symbol, order_id=oid,
                            reason="sibling_filled")
            except ExchangeUnavailable:
                self.orphan_orders.append({"symbol": symbol,
                                           "order_id": oid})
                self._j("orphan_order", flush=True, symbol=symbol,
                        order_id=oid)
        pnl = (exit_price - trade.entry_price) * trade.quantity
        record = self._closure_record(trade, exit_price, pnl, reason)
        self.closed_trades.append(record)
        self._j("trade_closed", flush=True, **record)
        await self.bus.publish("trade_closures", record)

    def _closure_record(self, trade: ActiveTrade, exit_price: float,
                        pnl: float, reason: str) -> dict:
        """One closure record, provenance included: entry_coid + source
        complete the flight recorder's signal→order→fill→PnL chain and
        feed PnL attribution — on the live path AND through journal
        replay after a restart."""
        record = {"symbol": trade.symbol, "entry_price": trade.entry_price,
                  "exit_price": exit_price, "quantity": trade.quantity,
                  "pnl": pnl, "reason": reason, "opened_at": trade.opened_at,
                  "closed_at": self.now_fn(),
                  "entry_coid": trade.entry_coid, "source": trade.source}
        if self.flightrec is not None:
            self.flightrec.closure(trade.entry_coid, trade.symbol,
                                   exit_price, pnl, reason)
        return record

    async def close_trade(self, symbol: str, price: float, reason: str) -> None:
        """Pop the trade only AFTER the exit sell succeeds: if the exchange
        dies mid-close the position stays on the books (cancelled
        protective orders are re-placed by _ensure_protection) and the
        close is re-attempted on the next trigger."""
        trade = self.active_trades.get(symbol)
        if trade is None:
            return
        # A protective order that is already not-open BEFORE we cancel it
        # filled server-side — finalize with that fill instead of selling
        # inventory that is no longer held.
        filled = self._reconcile_protective_fills(symbol, price)
        if filled is not None:
            fill_reason, exit_price = filled
            await self._finalize_filled(symbol, exit_price, fill_reason)
            return
        prot = self._protective_orders(trade)
        if trade.stop_order_id is not None:
            self.exchange.cancel_order(symbol, trade.stop_order_id)
            self._j("protect_cancel", symbol=symbol, leg="stop",
                    order_id=trade.stop_order_id, reason="closing")
            trade.stop_order_id = None
            trade.stop_coid = None
        if trade.tp_order_id is not None:
            self.exchange.cancel_order(symbol, trade.tp_order_id)
            self._j("protect_cancel", symbol=symbol, leg="tp",
                    order_id=trade.tp_order_id, reason="closing")
            trade.tp_order_id = None
            trade.tp_coid = None
        coid = self._next_coid("ext", symbol)
        self._j("close_intent", flush=True, symbol=symbol,
                client_order_id=coid, quantity=trade.quantity, reason=reason,
                coid_seq=self._coid_seq)
        try:
            order = self.exchange.place_order(symbol, "SELL", "MARKET",
                                              trade.quantity,
                                              client_order_id=coid)
        except ExchangeUnavailable:
            # ambiguous exit: the sell may have landed — park the intent
            # (inventory state unknown) for client-id resolution; the trade
            # stays on the books so nothing is silently dropped
            self.pending_intents[coid] = {
                "phase": "exit", "symbol": symbol, "client_order_id": coid,
                "quantity": trade.quantity, "reason": reason}
            self._j("close_ambiguous", flush=True, symbol=symbol,
                    client_order_id=coid)
            raise
        if order.get("status") != "FILLED":
            self._j("close_reject", symbol=symbol, client_order_id=coid,
                    status=order.get("status"))
            # Rejected exit. Either a protective order filled in the race
            # window between the reconcile above and our cancels (the ids
            # are cancelled now, so on_price reconciliation can no longer
            # see it — check the fills directly), or the rejection is
            # transient with inventory intact (keep the trade;
            # _ensure_protection re-places the protective orders next tick).
            last_fill = getattr(self.exchange, "last_fill", lambda _o: None)
            for oid, fill_reason, factor in prot:
                fill = last_fill(oid) if oid is not None else None
                if fill is not None:
                    await self._finalize_filled(
                        symbol, fill.get("price",
                                         trade.entry_price * factor),
                        fill_reason)
                    return
            return
        self.active_trades.pop(symbol, None)
        pnl = (price - trade.entry_price) * trade.quantity
        record = self._closure_record(trade, price, pnl, reason)
        self.closed_trades.append(record)
        self._j("trade_closed", flush=True, **record)
        await self.bus.publish("trade_closures", record)

    @staticmethod
    def _stop(trade: ActiveTrade) -> float:
        """The trade's current trailing stop, read to the host."""
        return host_read(trade.trailing_state.stop.reshape(1))[0]

    # --- crash recovery (utils/journal.py) ---------------------------------
    def _trade_dict(self, t: ActiveTrade) -> dict:
        return {"symbol": t.symbol, "entry_price": t.entry_price,
                "quantity": t.quantity, "stop_loss_pct": t.stop_loss_pct,
                "take_profit_pct": t.take_profit_pct,
                "stop_order_id": t.stop_order_id, "tp_order_id": t.tp_order_id,
                "stop": self._stop(t),
                "opened_at": t.opened_at, "entry_coid": t.entry_coid,
                "stop_coid": t.stop_coid, "tp_coid": t.tp_coid,
                "source": t.source}

    def _trade_from_dict(self, d: dict) -> ActiveTrade:
        entry = float(d["entry_price"])
        stop = float(d.get("stop") or entry * (1 - d["stop_loss_pct"] / 100.0))
        return ActiveTrade(
            symbol=d["symbol"], entry_price=entry,
            quantity=float(d["quantity"]),
            stop_loss_pct=float(d["stop_loss_pct"]),
            take_profit_pct=float(d["take_profit_pct"]),
            stop_order_id=d.get("stop_order_id"),
            tp_order_id=d.get("tp_order_id"),
            # trailing watermark is re-anchored at the journaled stop level
            # (the highest-price watermark itself is not journaled; the
            # ratchet resumes from the last durable stop, never below it)
            trailing_state=trailing_stop_init(
                entry, stop, self.trailing.activation_threshold_pct,
                device=self.device),
            opened_at=float(d.get("opened_at", 0.0)),
            entry_coid=d.get("entry_coid"), stop_coid=d.get("stop_coid"),
            tp_coid=d.get("tp_coid"), source=d.get("source"))

    def closed_count(self) -> int:
        """Total closed trades over the process LINEAGE (snapshot rotation
        keeps only a tail of per-trade records in memory/journal)."""
        return self._closed_dropped_n + len(self.closed_trades)

    def closed_pnl(self) -> float:
        return self._closed_dropped_pnl + sum(r.get("pnl", 0.0)
                                              for r in self.closed_trades)

    def snapshot_state(self) -> dict:
        """Bounded snapshot: compaction must stay O(live state), not
        O(every trade ever) — only the last SNAPSHOT_CLOSED_TAIL closure
        records are embedded; older ones are rotated into conserved
        aggregates (count + PnL) so the ledger totals survive restarts."""
        tail = self.closed_trades[-self.SNAPSHOT_CLOSED_TAIL:]
        return {"coid_seq": self._coid_seq,
                "active": {s: self._trade_dict(t)
                           for s, t in self.active_trades.items()},
                "closed": list(tail),
                "closed_total_n": self.closed_count(),
                "closed_total_pnl": self.closed_pnl(),
                "pending": dict(self.pending_intents),
                "orphans": list(self.orphan_orders)}

    def _restore_closed(self, snap: dict) -> None:
        self.closed_trades = list(snap.get("closed", []))
        total_n = int(snap.get("closed_total_n", len(self.closed_trades)))
        total_pnl = float(snap.get(
            "closed_total_pnl",
            sum(r.get("pnl", 0.0) for r in self.closed_trades)))
        self._closed_dropped_n = max(total_n - len(self.closed_trades), 0)
        self._closed_dropped_pnl = total_pnl - sum(
            r.get("pnl", 0.0) for r in self.closed_trades)

    def restore_state(self, snap: dict) -> None:
        self._coid_seq = max(self._coid_seq, int(snap.get("coid_seq", 0)))
        self.active_trades = {s: self._trade_from_dict(d)
                              for s, d in snap.get("active", {}).items()}
        self._restore_closed(snap)
        self.pending_intents = dict(snap.get("pending", {}))
        self.orphan_orders = list(snap.get("orphans", []))

    def apply_journal(self, records: list[dict]) -> None:
        """Replay journal records into the in-memory books (pure state
        reconstruction; no exchange calls — reconcile() does those).

        Trades are tracked as raw dicts during the scan and materialized
        (with their trailing-stop state on the device) only for positions
        still OPEN at the end — replay cost stays O(records) host work, not
        O(records) device-tensor builds (the `recovery_ms` bench row)."""
        active: dict = {s: self._trade_dict(t)
                        for s, t in self.active_trades.items()}
        for rec in records:
            kind, d = rec.get("kind"), rec.get("data", {})
            coid = d.get("client_order_id")
            sym = d.get("symbol")
            trade = active.get(sym)
            if kind == "snapshot":
                self._coid_seq = max(self._coid_seq,
                                     int(d.get("coid_seq", 0)))
                active = {s: dict(t) for s, t in d.get("active", {}).items()}
                self._restore_closed(d)
                self.pending_intents = dict(d.get("pending", {}))
                self.orphan_orders = list(d.get("orphans", []))
            elif kind in ("entry_intent", "entry_ambiguous"):
                if kind == "entry_intent":
                    self.pending_intents[coid] = {"phase": "entry", **d}
            elif kind == "entry_ack":
                self.pending_intents.pop(coid, None)
                active[sym] = {**d, "entry_price": d["price"],
                               "stop_loss_pct": d["sl_pct"],
                               "take_profit_pct": d["tp_pct"],
                               "entry_coid": coid,
                               "stop_order_id": None, "tp_order_id": None}
            elif kind in ("entry_reject", "intent_resolved", "close_reject"):
                self.pending_intents.pop(coid, None)
            elif kind == "protect_intent" and trade is not None:
                trade["stop_coid" if d.get("leg") == "stop"
                      else "tp_coid"] = coid
            elif kind == "protect_ack" and trade is not None:
                if d.get("leg") == "stop":
                    trade["stop_order_id"] = d.get("order_id")
                    trade["stop_coid"] = coid
                    if d.get("stop") is not None:
                        trade["stop"] = float(d["stop"])
                else:
                    trade["tp_order_id"] = d.get("order_id")
                    trade["tp_coid"] = coid
            elif kind == "protect_cancel" and trade is not None:
                if trade.get("stop_order_id") == d.get("order_id"):
                    trade["stop_order_id"] = trade["stop_coid"] = None
                if trade.get("tp_order_id") == d.get("order_id"):
                    trade["tp_order_id"] = trade["tp_coid"] = None
            elif kind in ("close_intent", "close_ambiguous"):
                if kind == "close_intent":
                    self.pending_intents[coid] = {"phase": "exit", **d}
            elif kind == "orphan_order":
                self.orphan_orders.append({"symbol": sym,
                                           "order_id": d.get("order_id")})
            elif kind == "orphan_cancelled":
                self.orphan_orders = [o for o in self.orphan_orders
                                      if o.get("order_id") != d.get("order_id")]
            elif kind == "trade_closed":
                active.pop(sym, None)
                self.closed_trades.append(dict(d))
                # a recorded closure resolves any outstanding exit intent
                for c, i in list(self.pending_intents.items()):
                    if i.get("phase") == "exit" and i.get("symbol") == sym:
                        self.pending_intents.pop(c, None)
            if d.get("coid_seq"):
                self._coid_seq = max(self._coid_seq, int(d["coid_seq"]))
        self.active_trades = {s: self._trade_from_dict(t)
                              for s, t in active.items()}

    def reap_orphans(self) -> int:
        """Retry cancelling parked sibling orders (see _finalize_filled).
        Venue unreachable → keep them parked, never raise (the reaper must
        not turn a cleanup retry into a skipped tick)."""
        reaped = 0
        for o in list(self.orphan_orders):
            try:
                if self.exchange.order_is_open(o["symbol"], o["order_id"]):
                    self.exchange.cancel_order(o["symbol"], o["order_id"])
            except ExchangeUnavailable:
                continue
            self.orphan_orders.remove(o)
            self._j("orphan_cancelled", symbol=o["symbol"],
                    order_id=o["order_id"])
            reaped += 1
        return reaped

    async def resolve_pending_intents(self) -> dict:
        """Ask the venue about every parked ambiguous intent by its
        deterministic client id.  Entry that landed → adopt the position;
        entry that never arrived → discard (re-entry unblocks).  Exit that
        landed → finalize the trade off the real fill; exit that never
        arrived → the trade stays managed.  Raises ExchangeUnavailable if
        the venue still can't answer (intents stay parked)."""
        out = {"adopted": 0, "discarded": 0, "finalized": 0}
        LIVE = ("OPEN", "NEW", "PARTIALLY_FILLED")
        for coid, intent in list(self.pending_intents.items()):
            symbol = intent["symbol"]
            found = self.exchange.find_order_by_client_id(symbol, coid)
            status = (found or {}).get("status")
            executed = float((found or {}).get("executed_qty") or 0.0)
            if found is not None and status in LIVE:
                # the venue holds a LIVE order for this intent — neither
                # adopt nor discard yet; stay parked (entry stays blocked)
                # until it fills or dies
                continue
            if intent.get("phase") == "entry":
                filled_qty = (float(found.get("quantity")
                                    or intent["quantity"])
                              if status == "FILLED" else executed)
                if found is not None and filled_qty > 0.0:
                    entry = self._fill_price(found, symbol)
                    sl = float(intent.get("sl_pct", 2.0))
                    tp = float(intent.get("tp_pct", 4.0))
                    self.active_trades[symbol] = self._trade_from_dict({
                        "symbol": symbol, "entry_price": entry,
                        "quantity": filled_qty, "stop_loss_pct": sl,
                        "take_profit_pct": tp, "opened_at": self.now_fn(),
                        "entry_coid": coid, "source": intent.get("source")})
                    self._j("entry_ack", flush=True, symbol=symbol,
                            client_order_id=coid, price=entry,
                            quantity=filled_qty, sl_pct=sl, tp_pct=tp,
                            opened_at=self.now_fn(),
                            order_id=found.get("order_id"),
                            stop=entry * (1 - sl / 100.0),
                            source=intent.get("source"))
                    if self.flightrec is not None:
                        # the fill that landed while we were down completes
                        # the provenance chain for the recovered entry
                        self.flightrec.fill(coid, entry, filled_qty,
                                            symbol=symbol)
                    out["adopted"] += 1
                else:
                    self._j("intent_resolved", symbol=symbol,
                            client_order_id=coid, resolution="not_placed")
                    if self.flightrec is not None:
                        # the durable decision record says "executed" (it
                        # flushed before placement) but the order never
                        # reached the venue — finalize it as a veto so
                        # replay can't show a phantom execution
                        self.flightrec.veto(
                            (intent.get("source") or {}).get("decision_id"),
                            "entry_rejected", symbol=symbol,
                            detail="intent discarded: order never reached "
                                   "the venue")
                    out["discarded"] += 1
            else:                                           # exit
                trade = self.active_trades.get(symbol)
                fully = (status == "FILLED"
                         or (trade is not None
                             and executed >= trade.quantity * 0.999))
                if found is not None and fully:
                    price = self._fill_price(found, symbol)
                    trade = self.active_trades.pop(symbol, None)
                    if trade is not None:
                        pnl = (price - trade.entry_price) * trade.quantity
                        record = self._closure_record(
                            trade, price, pnl,
                            intent.get("reason", "Recovered Exit"))
                        self.closed_trades.append(record)
                        self._j("trade_closed", flush=True, **record)
                        await self.bus.publish("trade_closures", record)
                    out["finalized"] += 1
                else:
                    # never landed (or died unfilled): the trade stays
                    # managed; protection is repaired by the next tick
                    self._j("intent_resolved", symbol=symbol,
                            client_order_id=coid, resolution="not_placed")
                    out["discarded"] += 1
            self.pending_intents.pop(coid, None)
        return out

    def _fill_price(self, found: dict, symbol: str) -> float:
        """Average fill price of a resolved order, with a last-resort
        market-price estimate: some venues report price=0 on MARKET
        orders, and booking an entry/exit at 0 would poison the trailing
        stop, the TP leg and PnL."""
        price = float(found.get("price") or 0.0)
        if price > 0.0 and np.isfinite(price):
            return price
        return float(self.exchange.get_ticker(symbol)["price"])

    async def reconcile(self) -> dict:
        """Reconcile the in-memory books against exchange ground truth —
        the restart path after apply_journal, and safe to run any time.

        Per active trade × protective leg: live → re-adopt; filled while
        we were down → finalize the position off the fill; missing /
        venue-cancelled → re-place.  Then sweep the venue's open orders
        for protective orphans (our client-id namespace, no parent
        position) and cancel them."""
        report = {"finalized_while_down": 0, "repaired_protection": 0,
                  "orphans_cancelled": 0}
        report.update(await self.resolve_pending_intents())
        report["orphans_cancelled"] += self.reap_orphans()
        for symbol, trade in list(self.active_trades.items()):
            # unacked legs first: adopt whatever actually landed
            for leg in ("stop", "tp"):
                oid = trade.stop_order_id if leg == "stop" else trade.tp_order_id
                if oid is None:
                    self._adopt_unacked_leg(trade, leg)
            # per-leg ground truth via order_state: FILLED (executed qty)
            # closes the position; venue-CANCELLED/EXPIRED must NOT be
            # booked as a fill (that would fabricate an exit) — it is a
            # missing leg to re-place
            closed = None
            for oid, reason, px_factor in self._protective_orders(trade):
                if oid is None:
                    continue
                st = self.exchange.order_state(symbol, oid, trade.quantity)
                if st["is_open"]:
                    continue
                if st["executed_qty"] >= trade.quantity * 0.999:
                    fill = getattr(self.exchange, "last_fill",
                                   lambda _o: None)(oid)
                    exit_price = (fill.get("price",
                                           trade.entry_price * px_factor)
                                  if fill else trade.entry_price * px_factor)
                    closed = (reason, exit_price)
                    break
                # dead leg: clear id + coid so _ensure_protection re-places
                if oid == trade.stop_order_id:
                    trade.stop_order_id = trade.stop_coid = None
                if oid == trade.tp_order_id:
                    trade.tp_order_id = trade.tp_coid = None
            if closed is not None:
                reason, exit_price = closed
                await self._finalize_filled(symbol, exit_price,
                                            f"{reason} (recovered)")
                report["finalized_while_down"] += 1
                continue
            if trade.stop_order_id is None or trade.tp_order_id is None:
                self._ensure_protection(trade)
                report["repaired_protection"] += 1
        # orphan sweep: protective orders in OUR namespace whose parent
        # position is gone (closed while down, or books lost their ack)
        referenced = {oid for t in self.active_trades.values()
                      for oid in (t.stop_order_id, t.tp_order_id)
                      if oid is not None}
        for o in self.exchange.list_open_orders():
            coid = o.get("client_order_id") or ""
            if not coid.startswith(f"{self.coid_prefix}-"):
                continue                   # not ours (grid/DCA/manual)
            if o.get("order_id") in referenced:
                continue
            sym = o.get("symbol")
            if (sym in self.active_trades
                    and coid in (self.active_trades[sym].stop_coid,
                                 self.active_trades[sym].tp_coid)):
                continue                   # adoptable, not an orphan
            self.exchange.cancel_order(sym, o["order_id"])
            self._j("protect_cancel", symbol=sym, order_id=o.get("order_id"),
                    reason="orphan")
            report["orphans_cancelled"] += 1
        self.bus.set("active_trades", {s: vars(t) | {"trailing_state": None}
                                       for s, t in self.active_trades.items()})
        return report

    async def recover_from_journal(self, journal=None) -> dict:
        """Full restart recovery: replay the write-ahead journal into the
        books, reconcile against the exchange, then compact the journal to
        one snapshot so the NEXT restart replays O(live state)."""
        from ai_crypto_trader_tpu_torch.utils import journal as journal_mod

        journal = journal or self.journal
        initial = getattr(journal, "initial_records", None)
        if (initial is not None
                and journal.seq == (initial[-1]["seq"] if initial else 0)):
            # nothing appended since open: the constructor's replay IS the
            # journal content — no second pass over the file
            records, stats = initial, journal.replay_stats
        else:
            records, stats = journal_mod.replay(journal.path)
        journal.initial_records = None     # release; compact() follows anyway
        self.apply_journal(records)
        report = {"journal": stats, "replayed_records": len(records),
                  "active_after_replay": len(self.active_trades)}
        report.update(await self.reconcile())
        journal.compact(self.snapshot_state())
        self._compacted_at = journal.seq
        return report

    def _queue(self):
        # Persistent subscription (see analyzer._queue).
        if not hasattr(self, "_q"):
            channel = ("trading_signals" if self.lane is None
                       else f"trading_signals.{self.lane}")
            self._q = self.bus.subscribe(channel)
        return self._q

    async def run_once(self) -> int:
        """Drain pending trading_signals (test/launcher tick). A signal
        interrupted by an exchange outage is re-queued so the entry is
        retried once the circuit recovers, then the outage propagates to
        the launcher's skip-and-alert path."""
        n = 0
        self.maybe_compact()
        if self.pending_intents:
            # self-heal ambiguous placements as soon as the venue answers
            # again — until resolved, entry for those symbols stays blocked
            await self.resolve_pending_intents()
        if self.orphan_orders:
            self.reap_orphans()
        q = self._queue()
        while not q.empty():
            env = q.get_nowait()
            if (self.lane is not None
                    and env["data"].get("lane") is not None
                    and env["data"]["lane"] != self.lane):
                continue                   # another tenant's decision lane
            try:
                with tracing.consumer_span(
                        env, "executor.handle_signal", service="executor",
                        attributes={"symbol": env["data"].get("symbol")}) as sp:
                    trade = await self.handle_signal(env["data"])
                    if trade:
                        sp.set_attribute("entry_price", trade.entry_price)
                        n += 1
                    else:
                        sp.set_attribute("gated", True)
            except ExchangeUnavailable:
                q.put_nowait(env)
                raise
        return n
