"""Decision-provenance flight recorder: signal → order → fill → PnL.

One compact record per (symbol, tick) decision, keyed by the tick's
trace_id when tracing is on (a fresh id otherwise), capturing

  * the fused tick engine's feature/confluence slice for the symbol,
  * each architecture's live prediction (the ``nn_prediction_*`` bus
    snapshot at decision time),
  * the analyzer verdict plus the structured explanation
    (strategy/explain.py), and
  * the terminal outcome: either the REJECTING GATE (which check vetoed
    — confidence floor, strength floor, NaN gate, pending-intent park,
    quarantine, …) or the execution chain — the WAL client_order_id,
    the entry fill, and eventually the realized closure PnL.

Two sinks, mirroring utils/tracing.py: a bounded in-memory ring (the
dashboard's ``/decisions?symbol=&trace_id=`` endpoint and ``cli why``)
and an optional append-only JSONL in the utils/journal.py checksummed
record format — so a torn tail from a crash is detected, replay is
shared code, and the provenance chain survives restarts (the chaos soak
asserts it).  Execution/fill/closure records flush write-through (they
are rare and must survive a kill, like the executor's order intents);
veto records batch.

The recorder is DEFAULT-ON in the launcher.  The disabled path follows
the tracing/devprof discipline: services hold a ``flightrec`` attribute
and every hot-path call site is one ``None`` check.
The port's own copy of `ai_crypto_trader_tpu/obs/flightrec.py`, host
code over the port's `utils.journal` and `utils.tracing`.  Gate ids are
positions in `GATES` and live in journaled records, so `GATES` and
`VETO_ORDER` are copied in the same order and only ever appended to; the
JSONL is the same checksummed format, so a file either package writes
loads in the other.  ``id_fn`` is injectable, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque

from ai_crypto_trader_tpu_torch.utils import journal as journal_mod
from ai_crypto_trader_tpu_torch.utils import tracing

GATES = (
    "analysis_interval",      # analyzer per-symbol cadence gate
    "outcome_probability",    # trade-outcome model downgraded BUY → HOLD
    "nan_gate",               # non-finite price/feature poisoned payload
    "confidence_floor",       # AI confidence below threshold
    "strength_floor",         # technical signal strength below floor
    "signal_disagreement",    # technical signal != AI decision
    "not_buy",                # agreed decision is HOLD/SELL
    "position_open",          # symbol already holds a position
    "pending_intent",         # unresolved ambiguous order parks entry
    "max_positions",          # position slots exhausted
    "risk_min_size",          # sized below min_trade_amount
    "entry_rejected",         # venue rejected the entry order
    "quarantine",             # executor stage quarantined mid-flight
    "lane_quarantined",       # tenant lane poisoned (NaN/Inf state or
    #                           params), masked out of sizing and entry
    #                           until the host healer re-seeds it
)

VETO_ORDER = (
    "lane_quarantined",
    "nan_gate",
    "confidence_floor",
    "strength_floor",
    "not_buy",
    "signal_disagreement",
    "position_open",
    "pending_intent",
    "max_positions",
    "risk_min_size",
)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class FlightRecorder:
    """Ring + journal-backed decision recorder.

    ``path=None`` keeps the ring only (tests, ad-hoc systems); with a
    path every terminal decision/fill/closure lands as a checksummed
    JSONL record replayable by :func:`load_decisions`.
    """

    def __init__(self, path: str | None = None, metrics=None,
                 now_fn=time.time, ring_size: int = 4096,
                 fsync_every: int = 64, id_fn=_new_id):
        self.metrics = metrics
        self.now_fn = now_fn
        self.ring_size = int(ring_size)
        self._id_fn = id_fn
        self.journal = (journal_mod.WriteAheadJournal(
            path, fsync_every=fsync_every, now_fn=now_fn)
            if path else None)
        self._ring: deque = deque()
        self._by_id: dict = {}              # open/ring records by id
        self._by_coid: dict = {}            # entry client_order_id -> id
        self._lock = threading.Lock()
        self.recorded = 0
        self.vetoed = 0
        self.executed = 0
        self.closed = 0
        # analysis-interval throttle hits, counted per symbol instead of
        # recorded: one fires per symbol per POLL — orders of magnitude
        # more often than real decisions, with no decision content.  Full
        # records would dominate the ring (evicting executed records
        # before their closures attach) and bloat the JSONL with ticks.
        self.throttled_counts: dict = {}    # symbol -> [n, last_t]

    # -- record lifecycle ----------------------------------------------------
    def _blank(self, symbol: str | None, decision_id: str | None = None,
               trace_fallback: bool = False,
               lane: int | None = None) -> dict:
        """One decision record in the canonical shape.  Synthetic records
        (veto/execution on an id the ring no longer holds — post-restart
        paths) leave trace_id None when no trace is active, so a journal
        re-append never clobbers the original record's trace on replay.
        ``lane`` tags a vmapped tenant lane's sampled decision
        (obs/fleetscope.py provenance sampling) so `cli why --lane N`
        can filter the fleet the way `--symbol` filters the universe."""
        sp = tracing.current()
        trace_id = sp.trace_id if sp is not None and sp.trace_id else None
        if trace_id is None and trace_fallback:
            trace_id = self._id_fn()
        return {
            "id": decision_id or self._id_fn(),
            "trace_id": trace_id,
            "symbol": symbol,
            "lane": lane,
            "t": self.now_fn(),
            "features": {},
            "predictions": {},
            "verdict": None,
            "explanation": None,
            "event_age_ms": None,
            "gate": None,
            "gate_detail": None,
            "status": "open",
            "exec": None,
            "fills": [],
            "closure": None,
        }

    def begin(self, symbol: str, features: dict | None = None,
              predictions: dict | None = None,
              verdict: dict | None = None,
              explanation: dict | None = None,
              lane: int | None = None,
              event_age_ms: float | None = None) -> str:
        """Open a decision record; returns its id (the analyzer stamps it
        onto the published signal as ``decision_id`` so the executor can
        finalize the same record).  ``event_age_ms`` is the venue-E →
        decision age the tickpath observatory clamped/folded
        (obs/tickpath.py) — None when that observatory is off."""
        rec = self._blank(symbol, trace_fallback=True, lane=lane)
        rec["features"] = features or {}
        rec["predictions"] = predictions or {}
        rec["verdict"] = verdict
        rec["explanation"] = explanation
        rec["event_age_ms"] = event_age_ms
        with self._lock:
            self._append(rec)
        self.recorded += 1
        if self.metrics is not None:
            self.metrics.inc("decisions_recorded_total", symbol=symbol)
        return rec["id"]

    def _append(self, rec: dict) -> None:
        self._ring.append(rec)
        self._by_id[rec["id"]] = rec
        if len(self._ring) > self.ring_size:
            old = self._ring.popleft()
            self._by_id.pop(old["id"], None)
            coid = (old.get("exec") or {}).get("client_order_id")
            if coid is not None:
                self._by_coid.pop(coid, None)

    def set_verdict(self, decision_id: str | None, verdict: dict,
                    explanation: dict | None = None) -> None:
        rec = self._by_id.get(decision_id)
        if rec is None:
            return
        rec["verdict"] = verdict
        if explanation is not None:
            # the structured explanation is large; keep the queryable core
            rec["explanation"] = {
                "supporting_factors": explanation.get("supporting_factors"),
                "narrative": explanation.get("narrative"),
            }

    def veto(self, decision_id: str | None, gate: str,
             detail: str | None = None, symbol: str | None = None) -> None:
        """Terminal: the decision was rejected by ``gate``."""
        rec = self._by_id.get(decision_id)
        if rec is None:
            if decision_id is None and symbol is None:
                return
            rec = self._blank(symbol, decision_id)
            with self._lock:
                self._append(rec)
        if rec["status"] == "vetoed":
            return                      # first gate wins (the informative
            #                             one — e.g. outcome_probability
            #                             before the executor's not_buy)
        rec["gate"] = gate
        rec["gate_detail"] = detail
        rec["status"] = "vetoed"
        self.vetoed += 1
        if self.metrics is not None:
            self.metrics.inc("decision_vetoes_total", gate=gate)
        if self.journal is not None:
            self.journal.append("decision", rec)

    def throttled(self, symbol: str) -> None:
        """The analyzer's per-poll cadence gate: counted (the
        ``decision_vetoes_total{gate="analysis_interval"}`` rate series
        and a per-symbol summary in ``why()``) but never recorded — see
        ``throttled_counts`` above."""
        slot = self.throttled_counts.setdefault(symbol, [0, 0.0])
        slot[0] += 1
        slot[1] = self.now_fn()
        if self.metrics is not None:
            self.metrics.inc("decision_vetoes_total",
                             gate="analysis_interval")

    def execution(self, decision_id: str | None, client_order_id: str,
                  symbol: str | None = None, **exec_info) -> None:
        """Terminal (for the decision): an entry order is about to reach
        the venue under ``client_order_id``.  Durable BEFORE placement
        (flush) so a kill in the placement window cannot orphan the
        venue-side fill from its provenance."""
        rec = self._by_id.get(decision_id)
        if rec is None:
            rec = self._blank(symbol, decision_id)
            with self._lock:
                self._append(rec)
        if rec["status"] == "vetoed":
            # a quarantine-parked decision drained after the stage came
            # back: the execution supersedes the provisional veto — an
            # executed record must not carry a gate
            self.vetoed -= 1
            rec["gate"] = None
            rec["gate_detail"] = None
        rec["exec"] = {"client_order_id": client_order_id, **exec_info}
        rec["status"] = "executed"
        with self._lock:
            self._by_coid[client_order_id] = rec["id"]
        self.executed += 1
        if self.metrics is not None:
            self.metrics.inc("decisions_executed_total",
                             symbol=rec.get("symbol") or symbol or "")
        if self.journal is not None:
            self.journal.append("decision", rec, flush=True)

    def fill(self, client_order_id: str, price: float, quantity: float,
             symbol: str | None = None) -> None:
        """Entry fill for a recorded client_order_id (live ack or the
        recovery path adopting a fill that landed while we were down)."""
        data = {"client_order_id": client_order_id, "price": float(price),
                "quantity": float(quantity), "symbol": symbol,
                "t": self.now_fn()}
        rid = self._by_coid.get(client_order_id)
        rec = self._by_id.get(rid)
        if rec is not None:
            rec["fills"].append(data)
        if self.journal is not None:
            self.journal.append("fill", data, flush=True)

    def closure(self, client_order_id: str | None, symbol: str,
                exit_price: float, pnl: float, reason: str) -> None:
        """Realized closure of the position opened by
        ``client_order_id`` — completes the provenance chain."""
        data = {"client_order_id": client_order_id, "symbol": symbol,
                "exit_price": float(exit_price), "pnl": float(pnl),
                "reason": reason, "t": self.now_fn()}
        rid = self._by_coid.get(client_order_id)
        rec = self._by_id.get(rid)
        if rec is not None:
            rec["closure"] = data
            rec["status"] = "closed"
        self.closed += 1
        if self.metrics is not None:
            self.metrics.inc("decision_closures_total", symbol=symbol)
        if self.journal is not None:
            self.journal.append("closure", data, flush=True)

    def mark_open(self, gate: str, detail: str | None = None) -> int:
        """Veto every still-open record (the executor-quarantine path:
        published signals that will not be drained while the stage is
        quarantined get their gate recorded instead of dangling)."""
        n = 0
        with self._lock:
            opens = [r for r in self._ring if r["status"] == "open"]
        for rec in opens:
            self.veto(rec["id"], gate, detail=detail)
            n += 1
        return n

    # -- queries -------------------------------------------------------------
    def query(self, symbol: str | None = None, trace_id: str | None = None,
              limit: int = 50, lane: int | None = None) -> list[dict]:
        """Newest-first decision records filtered by symbol / trace_id /
        sampled tenant lane."""
        with self._lock:
            records = list(self._ring)
        out = []
        for rec in reversed(records):
            if symbol is not None and rec.get("symbol") != symbol:
                continue
            if trace_id is not None and rec.get("trace_id") != trace_id:
                continue
            if lane is not None and rec.get("lane") != lane:
                continue
            out.append(rec)
            if limit and len(out) >= limit:
                break
        return out

    def why(self, symbol: str, n: int = 10) -> list[str]:
        lines = format_why(self.query(symbol=symbol, limit=n))
        thr = self.throttled_counts.get(symbol)
        if thr:
            stamp = time.strftime("%H:%M:%S", time.gmtime(thr[1]))
            lines.append(f"({thr[0]} polls throttled by analysis_interval, "
                         f"last at {stamp})")
        return lines

    def status(self) -> dict:
        with self._lock:
            ring = len(self._ring)
        return {"recorded": self.recorded, "vetoed": self.vetoed,
                "executed": self.executed, "closed": self.closed,
                "throttled": sum(v[0] for v in
                                 self.throttled_counts.values()),
                "ring": ring,
                "journal": self.journal.path if self.journal else None}

    def export(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("flightrec_ring_size", len(self._ring))

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


def load_decisions(path: str) -> tuple[list[dict], dict]:
    """Replay a flight-recorder JSONL into joined decision records.

    Uses the journal's checksummed replay (torn tails dropped, mid-file
    corruption counted), then joins ``fill``/``closure`` records onto
    their decision via the entry client_order_id — the restart-surviving
    twin of the in-memory ring.  Returns (records, replay_stats)."""
    raw, stats = journal_mod.replay(path)
    records: list[dict] = []
    by_id: dict = {}
    by_coid: dict = {}
    for rec in raw:
        kind, d = rec.get("kind"), rec.get("data", {})
        if kind == "decision":
            prev = by_id.get(d.get("id"))
            if prev is not None:
                # veto→execution re-append updates.  The terminal triple
                # is taken verbatim (veto and execution write all three
                # consistently — an execution superseding a quarantine
                # veto must CLEAR the gate); other fields merge non-empty
                # only, so a post-restart SYNTHETIC veto (ring lost in the
                # crash: features/exec/trace empty) can't erase content.
                for k, v in d.items():
                    if k in ("status", "gate", "gate_detail") or v \
                            or k not in prev:
                        prev[k] = v
                d = prev
            else:
                records.append(d)
                by_id[d.get("id")] = d
            coid = (d.get("exec") or {}).get("client_order_id")
            if coid:
                by_coid[coid] = d
        elif kind == "fill":
            parent = by_coid.get(d.get("client_order_id"))
            if parent is not None:
                parent.setdefault("fills", []).append(d)
        elif kind == "closure":
            parent = by_coid.get(d.get("client_order_id"))
            if parent is not None:
                parent["closure"] = d
                parent["status"] = "closed"
            else:
                # closure whose decision predates the file (rotation) —
                # kept as a standalone record so PnL provenance is never
                # silently dropped
                records.append({"id": None, "symbol": d.get("symbol"),
                                "status": "closed", "gate": None,
                                "exec": {"client_order_id":
                                         d.get("client_order_id")},
                                "fills": [], "closure": d,
                                "orphan_closure": True})
    return records, stats


def format_why(records: list[dict]) -> list[str]:
    """Human lines for ``cli why`` / the recorder's ``why()``: one line
    per decision with its outcome, plus the explanation narrative."""
    lines = []
    for rec in records:
        t = rec.get("t")
        stamp = (time.strftime("%H:%M:%S", time.gmtime(t))
                 if isinstance(t, (int, float)) else "--:--:--")
        head = f"{stamp} {rec.get('symbol')} "
        if rec.get("lane") is not None:
            head += f"[lane {rec['lane']}] "
        verdict = rec.get("verdict") or {}
        if rec.get("status") == "vetoed":
            detail = f" ({rec['gate_detail']})" if rec.get("gate_detail") else ""
            head += f"VETO [{rec.get('gate')}]{detail}"
        elif rec.get("status") in ("executed", "closed"):
            ex = rec.get("exec") or {}
            head += f"EXECUTED {ex.get('client_order_id')}"
            fills = rec.get("fills") or []
            if fills:
                head += (f" filled {fills[0].get('quantity', 0):.6g}"
                         f" @ {fills[0].get('price', 0):,.2f}")
            closure = rec.get("closure")
            if closure:
                head += (f" → {closure.get('reason')} "
                         f"pnl {closure.get('pnl', 0):+,.2f}")
        else:
            head += "PENDING"
        if verdict:
            head += (f" | {verdict.get('decision', '?')}"
                     f" conf {verdict.get('confidence', 0):.2f}")
        lines.append(head)
        narrative = (rec.get("explanation") or {}).get("narrative")
        if narrative:
            lines.append(f"    {narrative}")
    return lines
