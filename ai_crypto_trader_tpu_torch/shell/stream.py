"""Streaming-native market ingest: the websocket feed as the FIRST-CLASS
market-data path, with a supervised connection lifecycle.

Capability parity with the reference's push path — the Binance
`!miniTicker@arr` stream handled by `services/market_monitor_service.py:615`
(per-symbol 5 s throttle → pending set → batches) and
`auto_trader.py:33-123` — extended past parity into the transport itself:
Binance `kline` / combined-stream frames are parsed into candle rows that
feed the fused tick engine's scatter-list delta uploads DIRECTLY
(`MarketStream` → `TickEngine.ingest_row` → device ring buffer), so a
steady-state drain is one device dispatch with ZERO REST kline fetches.
REST becomes the backfill tool, not the transport.

Three layers:

  * **`MarketStream`** — frame parsing + continuity enforcement.  Each
    (symbol, interval) lane keeps a `_CandleBook`: an expected-next-open-
    time tracker over a bounded candle window.  Duplicates and out-of-order
    frames are dropped-and-counted; a gap (reconnect window, missed candle)
    marks the lane for bounded REST backfill through the monitor's
    breaker-protected fetch BEFORE any ring upload — the device ring can
    never hold a torn or contradictory window.  Drains ride
    `MarketMonitor.poll(symbols=…, fetch=…)` with the stream's own windows
    as the kline source, so publication/bus/analyzer semantics are
    byte-identical to the polling path (the parity tests pin this).
  * **`StreamSupervisor`** — the connection lifecycle.  A bounded frame
    queue (drop-oldest + counter, the bus's per-channel policy applied
    to the feed) decouples the transport from the drain; `pump()` is the
    wall-clock reconnect loop (exponential backoff + jitter, connect/read
    timeouts); a max-silence watchdog forces a disconnect when a live
    socket goes quiet; edge-triggered `StreamDisconnected` /
    `StreamFlapping` alerts and `stream_*` gauges make every transition
    observable.  The launcher runs `step()` as a supervised stage and
    degrades to REST polling while the stream is quarantined or stale
    (shell/launcher.py `_poll_market`).
  * **`BinanceStreamSource`** — the real-network source, gated on an
    installed websocket client library; parameterized url / ping interval
    / connect timeout, one-time import, clean close on cancellation.

Tests inject recorded frames (`replay_frames`, `kline_frame`); zero egress.

Port of `ai_crypto_trader_tpu/shell/stream.py`: host code, copied, with the
same counters, gauges, alerts and frame formats.  The stream computes
nothing itself: a drain is its monitor's poll, so it runs on the monitor's
device (`MarketMonitor(device=...)`, whose `TickEngine` makes three launches
of the fused-EWMA kernel a step and one host read).  A streamed row reaches
the engine through `TickEngine.ingest_row` as the frame lands.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable

from ai_crypto_trader_tpu_torch.obs import tickpath
from ai_crypto_trader_tpu_torch.utils import tracing

BINANCE_WS = "wss://stream.binance.com:9443/ws/!miniTicker@arr"
BINANCE_STREAM_BASE = "wss://stream.binance.com:9443/stream?streams="


def binance_kline_url(symbols, intervals, base: str = BINANCE_STREAM_BASE,
                      depth_symbols=()) -> str:
    """Combined-stream subscription URL for every (symbol × interval) kline
    channel — the one-socket fan-in the supervisor reconnects.

    ``depth_symbols`` subscribes TWO capture channels each: ``@depth``
    diffs (the full-fidelity recorder feed with update-id gap detection)
    and ``@depth20`` partial snapshots — the book shapes calibration and
    the FakeExchange replay seam consume (diffs are per-level CHANGES,
    not books)."""
    streams = "/".join([f"{s.lower()}@kline_{iv}"
                        for s in symbols for iv in intervals]
                       + [f"{s.lower()}@{ch}" for s in depth_symbols
                          for ch in ("depth", "depth20")])
    return base + streams


#: Binance kline interval units → milliseconds.  '1M' is calendar-variable
#: on the venue; 30 days is the continuity step (a real month boundary at
#: worst flags a spurious gap, which backfill heals — never a torn ring).
_INTERVAL_UNIT_MS = {"s": 1_000, "m": 60_000, "h": 3_600_000,
                     "d": 86_400_000, "w": 604_800_000, "M": 2_592_000_000}


def interval_ms(interval: str) -> int:
    """Candle step in epoch milliseconds ('1m' → 60_000)."""
    try:
        return int(interval[:-1]) * _INTERVAL_UNIT_MS[interval[-1]]
    except (KeyError, ValueError, IndexError):
        raise ValueError(f"unrecognized kline interval {interval!r}") from None


def kline_frame(symbol: str, interval: str, row: list, *,
                closed: bool = True, event_ms: int | None = None,
                quote_volume: float | None = None,
                combined: bool = False) -> str:
    """Build a Binance-format kline frame from a kline ROW
    (`[open_time, o, h, l, c, v, …]` — the shape every adapter serves).
    The transport twin of the parser below; tests/bench/chaos generate
    their recorded feeds with it (zero egress)."""
    k = {"t": int(row[0]), "s": symbol, "i": interval,
         "o": str(row[1]), "h": str(row[2]), "l": str(row[3]),
         "c": str(row[4]), "v": str(row[5]), "x": bool(closed)}
    if quote_volume is not None:
        k["q"] = str(quote_volume)
    data = {"e": "kline", "E": int(event_ms if event_ms is not None
                                   else row[0]), "s": symbol, "k": k}
    if combined:
        return json.dumps({"stream": f"{symbol.lower()}@kline_{interval}",
                           "data": data})
    return json.dumps(data)


def depth_frame(symbol: str, bids, asks, *, event_ms: int = 0,
                first_id: int = 0, final_id: int = 0,
                snapshot: bool = False, combined: bool = False) -> str:
    """Build a Binance-format depth frame — ``@depth`` diff
    (``depthUpdate``) by default, or a partial-book snapshot
    (``lastUpdateId``) with ``snapshot=True``.  The transport twin of the
    capture parser below; tests and the calibration fixtures generate
    recorded feeds with it (zero egress)."""
    px = lambda lv: [str(lv[0]), str(lv[1])]  # noqa: E731
    if snapshot:
        data: dict = {"lastUpdateId": int(final_id),
                      "bids": [px(b) for b in bids],
                      "asks": [px(a) for a in asks]}
        stream = f"{symbol.lower()}@depth20"
    else:
        data = {"e": "depthUpdate", "E": int(event_ms), "s": symbol,
                "U": int(first_id), "u": int(final_id),
                "b": [px(b) for b in bids], "a": [px(a) for a in asks]}
        stream = f"{symbol.lower()}@depth"
    if combined:
        return json.dumps({"stream": stream, "data": data})
    return json.dumps(data)


class DepthCapture:
    """Bounded depth-frame capture: a drop-oldest ring plus an optional
    checksummed JSONL journal in the `utils/journal` record format (the
    flight-recorder pattern) — the raw material `sim/calibrate.py` fits
    `FlowParams` from and `FakeExchange`'s replay seam serves back.

    Both Binance depth shapes are recorded: ``@depth`` diffs
    (``depthUpdate`` events, update-id continuity checked) and partial
    snapshots (``lastUpdateId`` + top-N bids/asks).  Each record
    normalizes to ``{"symbol", "kind", "E", "U", "u", "bids", "asks"}``
    with float [price, size] levels.  Bounded on BOTH surfaces: the ring
    by ``ring_max`` (drop-oldest — a capture burst must never grow host
    memory; aging out of a keep-last-N ring is RETENTION, not loss, and
    is not counted), the journal by ``journal_max`` records (bounded
    disk).  ``frames_dropped`` counts real capture loss: frames that
    arrived after a configured journal exhausted its budget and were
    therefore never persisted — the `DepthFramesDropping` /
    `DepthCaptureSaturated` alert input."""

    def __init__(self, path: str | None = None, ring_max: int = 1024,
                 journal_max: int = 100_000, symbols=None):
        self.path = path
        self.ring: deque = deque(maxlen=max(int(ring_max), 1))
        self.ring_max = max(int(ring_max), 1)
        self.journal_max = int(journal_max)
        self.symbols = frozenset(symbols) if symbols else None
        self.frames_total = 0
        self.frames_dropped = 0          # unpersisted: journal exhausted
        self.frames_ignored = 0          # off-universe symbol filter
        self.malformed = 0
        self.gaps = 0                    # diff update-id discontinuities
        self.journaled = 0
        self._journal = None
        self._last_u: dict[str, int] = {}

    @property
    def watermark(self) -> float:
        """Ring fill fraction (the `depth_capture_ring_fill` gauge) —
        informational: a long-running capture sits at 1.0 by design
        (keep-last-N); it is NOT an alert input."""
        return len(self.ring) / self.ring_max

    @property
    def journal_exhausted(self) -> bool:
        """True once a configured journal has spent its record budget —
        new frames are no longer persisted (the `DepthCaptureSaturated`
        alert input).  Always False without a journal (ring-only capture
        never 'loses' what it never promised to keep)."""
        return self.path is not None and self.journaled >= self.journal_max

    def _normalize(self, payload: dict) -> dict | None:
        try:
            if payload.get("e") == "depthUpdate":
                return {"symbol": payload["s"], "kind": "diff",
                        "E": int(payload.get("E", 0)),
                        "U": int(payload.get("U", 0)),
                        "u": int(payload.get("u", 0)),
                        "bids": [[float(p), float(q)]
                                 for p, q in payload.get("b", [])],
                        "asks": [[float(p), float(q)]
                                 for p, q in payload.get("a", [])]}
            if "lastUpdateId" in payload:
                return {"symbol": payload.get("s", ""), "kind": "snapshot",
                        "E": int(payload.get("E", 0)), "U": 0,
                        "u": int(payload["lastUpdateId"]),
                        "bids": [[float(p), float(q)]
                                 for p, q in payload.get("bids", [])],
                        "asks": [[float(p), float(q)]
                                 for p, q in payload.get("asks", [])]}
        except (KeyError, TypeError, ValueError):
            return None
        return None

    def ingest(self, payload: dict) -> bool:
        """Record one parsed depth payload; returns True when captured."""
        rec = self._normalize(payload)
        if rec is None:
            self.malformed += 1
            return False
        if self.symbols is not None and rec["symbol"] not in self.symbols:
            self.frames_ignored += 1
            return False
        self.frames_total += 1
        if rec["kind"] == "diff" and rec["symbol"] in self._last_u:
            # Binance diff contract: each event's U must be last u + 1;
            # a break means lost frames — counted, never papered over
            # (the _CandleBook continuity discipline, on the book feed)
            if rec["U"] != self._last_u[rec["symbol"]] + 1:
                self.gaps += 1
        if rec["kind"] == "diff":
            self._last_u[rec["symbol"]] = rec["u"]
        self.ring.append(rec)            # deque evicts the oldest (bounded)
        if self.path is not None:
            if self.journaled < self.journal_max:
                if self._journal is None:
                    from ai_crypto_trader_tpu_torch.utils.journal import (
                        WriteAheadJournal,
                    )
                    self._journal = WriteAheadJournal(self.path)
                self._journal.append("depth", rec)
                self.journaled += 1
            else:
                self.frames_dropped += 1     # journal budget spent: the
                #                              frame was never persisted
        return True

    def records(self) -> list[dict]:
        """The ring's current contents, oldest first."""
        return list(self.ring)

    def calibration_window(self, symbol: str | None = None,
                           min_records: int = 2) -> list[dict]:
        """The snapshot records a `sim/calibrate.fit_flow_params` re-fit
        consumes, newest-last — the rolling-recalibration feed
        (rl/trainer_service.py).  Snapshot-kind only (diffs are size
        CHANGES, not standing books); returns [] when the window is too
        thin to fit, so the caller's last-good fallback triggers without
        a partial-window fit ever running."""
        books = [r for r in self.ring
                 if r.get("kind") == "snapshot"
                 and (symbol is None or r.get("symbol") == symbol)]
        return books if len(books) >= max(int(min_records), 1) else []

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()


def depth_records_from_journal(path: str) -> tuple[list[dict], dict]:
    """Replay a DepthCapture JSONL journal back into normalized records.

    Torn tails and CRC-corrupt lines are SKIPPED, not raised (the WAL
    replay contract): the caller gets every intact depth record plus the
    replay stats — a journal whose corruption emptied the window shows
    ``corrupt_records > 0`` with an empty list, which the recalibration
    service treats as a poisoned source and degrades to last-good."""
    from ai_crypto_trader_tpu_torch.utils.journal import replay

    records, stats = replay(path)
    return [r["data"] for r in records if r.get("kind") == "depth"], stats


class _CandleBook:
    """Continuity-enforced candle window for ONE (symbol, interval) lane.

    ``apply(row)`` classifies each streamed row against the expected next
    open time: an in-progress-bar update replaces the tail, the next
    candle appends, anything else is rejected (`dup` / `out_of_order`) or
    flags the lane for REST backfill (`gap` / `seed_needed`).  The window
    only ever holds a contiguous, time-ordered run of candles — the
    invariant the device ring inherits.

    ``tail_closed`` tracks whether the tail bar's FINAL form was seen
    (the kline `x` flag): appending the next candle onto an unconfirmed
    tail would freeze a torn bar into the window (its final update was
    lost in transit), so that case flags a backfill instead — the lost
    update is repaired over REST, never papered over."""

    __slots__ = ("rows", "limit", "step_ms", "needs_backfill", "tail_closed",
                 "tail_event_ms", "last_recv")

    def __init__(self, limit: int, step_ms: int):
        self.rows: list = []
        self.limit = int(limit)
        self.step_ms = int(step_ms)
        self.needs_backfill = True       # empty lane: seed via REST
        self.tail_closed = True
        self.tail_event_ms = 0           # newest applied exchange event time
        self.last_recv = 0.0             # host time a stream row last landed

    def seed(self, rows: list) -> None:
        self.rows = [list(r) for r in rows[-self.limit:]]
        self.needs_backfill = False
        self.tail_closed = True          # REST is the ground truth
        self.tail_event_ms = 0           # next streamed update re-anchors

    def apply(self, row: list, closed: bool = False,
              event_ms: int | None = None) -> str:
        if not self.rows:
            self.needs_backfill = True
            return "seed_needed"
        t, last = int(row[0]), int(self.rows[-1][0])
        if t == last:
            # within-bar ordering rides the exchange EVENT time: a delayed
            # re-delivery of an older update must not clobber fresher
            # content (open times alone can't order same-bar updates)
            if event_ms is not None and 0 < event_ms < self.tail_event_ms:
                return "out_of_order"
            if event_ms:
                self.tail_event_ms = max(self.tail_event_ms, int(event_ms))
            if row == self.rows[-1]:
                self.tail_closed = self.tail_closed or closed
                return "dup"             # exact re-send: drop, count
            self.rows[-1] = row          # in-progress bar update
            # the stream now OWNS the tail's content: only this update's
            # own flag confirms finality (a seed's trusted-REST flag must
            # not survive a content change, or a later lost final update
            # would freeze a torn bar — found by the chaos soak)
            self.tail_closed = closed
            return "update"
        if t < last:
            return "out_of_order"        # older than the tail: drop, count
        if t != last + self.step_ms:
            self.needs_backfill = True   # missed candle(s): REST refill
            return "gap"
        if not self.tail_closed:
            # the next candle arrived but the tail's final update never
            # did — appending would freeze the torn bar into the window
            self.needs_backfill = True
            return "unconfirmed"
        self.rows.append(row)
        if len(self.rows) > self.limit:
            del self.rows[0]
        self.tail_closed = closed
        self.tail_event_ms = int(event_ms) if event_ms else 0
        return "append"


class _ServedWindow(list):
    """Kline rows + provenance for the fused poll.  ``engine_current=True``
    asserts the tick engine's ring already reflects every row in this
    window (each one was applied via ``TickEngine.ingest_row`` when its
    frame landed), so the monitor may skip the full-window re-diff for
    the lane — the diff would provably find zero changes.  A plain list
    (REST backfill, tests, any non-stream source) carries no such claim
    and always takes the full ingest path."""

    engine_current = False


@dataclass
class MarketStream:
    """Frames → continuity-checked candle books → batched monitor refresh.

    miniTicker frames keep their reference semantics (throttle / volume
    filter / dirty set); kline frames additionally maintain the candle
    books and push applied rows straight into the fused tick engine's
    scatter list (`TickEngine.ingest_row`), so the follow-up drain's
    full-window ingest is an idempotent no-op guard, not the upload."""

    monitor: "MarketMonitor"                     # noqa: F821 (shell.monitor)
    min_quote_volume: float = 0.0                # auto_trader.py:78-88 filter
    throttle_s: float = 5.0                      # market_monitor_service.py:374
    batch_size: int = 5                          # :403 batch cadence
    # REST-backfill cadence bound: at most this many symbols whose lanes
    # need a REST (re)seed enter one drain — after a reconnect gap marks
    # the whole universe dirty, the repair is spread over successive
    # drains instead of bursting universe × intervals get_klines calls
    # into the venue's weight limit in a single tick (the rate-limit
    # hazard this PR exists to remove).  Symbols deferred here stay
    # pending and ride the next drain.  Floored at 1 so drains always
    # make progress.
    backfill_batch: int = 5
    now_fn: any = time.time
    restrict_to_universe: bool = True            # ignore unconfigured symbols
    max_tracked: int = 4096                      # _last_seen bound (LRU)
    # a candle book may serve a drain only while the stream is actually
    # feeding its lane (≥ one applied/confirmed row within this budget,
    # floored at 2 candle steps); anything quieter falls back to a fresh
    # REST fetch — a once-seeded lane whose kline channel isn't in the
    # subscription must never freeze its indicators on stale rows
    book_fresh_s: float = 90.0
    # frame micro-batching (ROADMAP item 4): run() coalesces frames that
    # are already queued — or arrive within ``microbatch_s`` — into ONE
    # ingest burst followed by ONE fused drain, instead of one dispatch
    # per frame.  The wait bounds the added decision latency to
    # microbatch_s per burst, three orders of magnitude under the 2 s
    # event-age budget (obs/tickpath.DEFAULT_EVENT_AGE_BUDGET_MS);
    # ``microbatch`` caps the burst so a firehose can never starve the
    # drain.  microbatch=1 restores strict frame-per-dispatch.
    microbatch: int = 64
    microbatch_s: float = 0.001
    # bounded depth-frame capture (None = depth frames are ignored).  The
    # capture rides the SAME parsed-frame path as klines/miniTickers, so
    # a mixed combined-stream subscription needs no second socket.
    depth: DepthCapture | None = None
    _last_seen: dict = field(default_factory=dict)
    # dict-backed ordered set: O(1) membership + insertion order preserved
    # (the old list scanned O(batch·pending) under burst load)
    _pending: dict = field(default_factory=dict)
    # universe membership is checked once per FRAME — cache the set and
    # rebuild only when the monitor's symbol list is replaced or resized
    # (discovery reassigns it wholesale), not on the hot parse path
    _universe_key: tuple = (0, 0)
    _universe_set: frozenset = frozenset()
    _books: dict = field(default_factory=dict)   # (symbol, interval) → book
    frames_in: int = 0
    ticks_in: int = 0
    malformed_frames: int = 0
    dup_frames: int = 0
    ooo_frames: int = 0
    gaps: int = 0
    backfills: int = 0
    frames_ignored: int = 0                      # off-universe / off-interval
    streamed_rows: int = 0                       # rows applied to the engine
    served_current: int = 0                      # windows served engine-current
    micro_batches: int = 0                       # drains that coalesced > 1
    micro_batched_frames: int = 0                # frames riding those drains
    last_event_ms: int = 0                       # newest exchange event time

    # -- parsing --------------------------------------------------------------
    def ingest_frame(self, frame: str) -> list[str]:
        """Parse one raw frame; returns the symbols newly marked dirty.

        Accepts miniTicker-array frames (JSON list of per-symbol dicts),
        kline frames (`{"e": "kline", "k": {…}}`), and either wrapped in a
        combined-stream envelope.  Malformed frames are dropped and
        counted (the reference's handler logs and continues)."""
        self.frames_in += 1
        try:
            payload = json.loads(frame)
        except (json.JSONDecodeError, TypeError):
            self.malformed_frames += 1
            return []
        stream_name = None
        if isinstance(payload, dict) and "stream" in payload:
            # the envelope's stream name is the ONLY place a partial-depth
            # snapshot carries its symbol — keep it for the depth path
            stream_name = str(payload.get("stream") or "")
            payload = payload.get("data")        # combined-stream envelope
        if isinstance(payload, dict):
            if payload.get("e") == "kline":
                return self._ingest_kline(payload)
            if payload.get("e") == "depthUpdate" or "lastUpdateId" in payload:
                return self._ingest_depth(payload, stream_name)
            payload = payload.get("data", [])    # legacy {"data": [...]}
        if not isinstance(payload, list):
            self.malformed_frames += 1
            return []
        return self._ingest_miniticker(payload)

    def _set_ticker(self, symbol: str, price: float, quote_vol: float,
                    now: float, event_ms: int | None) -> None:
        # push the raw tick immediately (executor SL/TP checks ride
        # sub-candle prices, auto_trader.py:288-316).  BOTH times ride the
        # entry: `event_time` is the EXCHANGE's stamp (`E`, ms) — the
        # staleness fence the executor applies — `recv_time` the host's.
        # A delayed feed is now distinguishable from a fresh one.
        event_t = (event_ms / 1000.0) if event_ms else now
        if event_ms:
            self.last_event_ms = max(self.last_event_ms, int(event_ms))
        self.monitor.bus.set(f"ticker_{symbol}", {
            "symbol": symbol, "price": price, "quote_volume": quote_vol,
            "event_time": event_t, "recv_time": now, "timestamp": now,
        })

    def _universe(self) -> frozenset:
        syms = self.monitor.symbols
        key = (id(syms), len(syms))
        if key != self._universe_key:
            self._universe_key = key
            self._universe_set = frozenset(syms)
        return self._universe_set

    def mark_starved(self, now: float | None = None) -> list[str]:
        """Force-mark universe symbols NO path has published within the
        lane-staleness budget.  While the stream is healthy the launcher
        never runs the full-universe REST poll — so a symbol the
        subscription is silently missing (operator URL drift, a dropped
        channel) would otherwise freeze its market_data forever with
        stream_mode=1 reporting everything fine.  Marking it dirty routes
        it through the next drain, whose `serve_klines` REST-refetches
        quiet lanes (`book_fresh_s`), bounded by `backfill_batch`."""
        now = self.now_fn() if now is None else now
        stale_s = max(self.book_fresh_s, 2.0 * self.throttle_s)
        marked = []
        for s in self.monitor.symbols:
            if now - self.monitor._last_pub.get(s, -1e18) >= stale_s and \
                    self._mark_dirty(s, now):
                marked.append(s)
        return marked

    def _mark_dirty(self, symbol: str, now: float, *,
                    force: bool = False) -> bool:
        """Throttled dirty-set insertion; returns True when newly marked.
        ``_last_seen`` is LRU-bounded so a long-lived stream over a
        churning universe cannot grow it without limit."""
        if not force:
            if now - self._last_seen.get(symbol, -1e18) < self.throttle_s:
                return False
        self._last_seen.pop(symbol, None)        # move-to-end (LRU order)
        self._last_seen[symbol] = now
        while len(self._last_seen) > self.max_tracked:
            self._last_seen.pop(next(iter(self._last_seen)))
        if symbol in self._pending:
            return False
        self._pending[symbol] = True
        return True

    def _ingest_miniticker(self, tickers: list) -> list[str]:
        now = self.now_fn()
        universe = self._universe() if self.restrict_to_universe else None
        marked = []
        for t in tickers:
            try:
                symbol = t["s"]
                price = float(t["c"])
                quote_vol = float(t.get("q", 0.0))
            except (KeyError, TypeError, ValueError):
                continue
            self.ticks_in += 1
            if universe is not None and symbol not in universe:
                continue
            if quote_vol < self.min_quote_volume:
                continue
            event_ms = t.get("E")
            self._set_ticker(symbol, price, quote_vol, now,
                             int(event_ms) if event_ms else None)
            if event_ms and tickpath.active() is not None:
                eng = getattr(self.monitor, "_engine", None)
                if eng is not None:
                    eng.note_event_ms(symbol, float(event_ms))
            if self._mark_dirty(symbol, now):
                marked.append(symbol)
        return marked

    def _ingest_kline(self, d: dict) -> list[str]:
        now = self.now_fn()
        k = d.get("k") or {}
        try:
            symbol = d["s"]
            interval = k["i"]
            row = [int(k["t"]), float(k["o"]), float(k["h"]), float(k["l"]),
                   float(k["c"]), float(k["v"]), 0, 0.0, 0, 0.0, 0.0, 0]
            closed = bool(k.get("x", False))
        except (KeyError, TypeError, ValueError):
            self.malformed_frames += 1
            return []
        self.ticks_in += 1
        in_universe = symbol in self._universe()
        if self.restrict_to_universe and not in_universe:
            self.frames_ignored += 1
            return []
        # NOTE: a kline frame's `q` is the CANDLE's quote volume — never
        # compare it against min_quote_volume, which is the miniTicker
        # 24h-volume discovery filter (auto_trader.py:78-88); doing so
        # would reject virtually every kline frame on a filtered stream
        quote_vol = float(k.get("q", 0.0) or 0.0)
        event_ms = d.get("E")
        self._set_ticker(symbol, float(k["c"]), quote_vol, now,
                         int(event_ms) if event_ms else None)
        if event_ms:
            # frame_wait phase (obs/tickpath.py): venue event time E →
            # host receive, the feed-transit leg of the decision path.
            # A host clock behind the venue reads negative — the scope
            # clamps to 0 and counts tickpath_clock_skew_total.
            tickpath.observe_phase("frame_wait", now - int(event_ms) / 1000.0)
            eng = (getattr(self.monitor, "_engine", None)
                   if tickpath.active() is not None else None)
            if eng is not None:
                # upgrade the engine's candle-open event time to the
                # exchange's true E for the event→decision age SLO
                eng.note_event_ms(symbol, float(event_ms))
        if not in_universe or interval not in self.monitor.intervals:
            self.frames_ignored += 1             # ticker only; no book lane
            return []
        try:
            book = self._book(symbol, interval)
        except ValueError:
            # an unparseable interval must poison THIS frame, not the
            # stage (an escaped exception would quarantine every lane)
            self.malformed_frames += 1
            return []
        status = book.apply(row, closed=closed,
                            event_ms=int(event_ms) if event_ms else None)
        if status in ("append", "update", "dup"):
            book.last_recv = now             # the lane is live-fed
        if status == "dup":
            self.dup_frames += 1
            return []
        if status == "out_of_order":
            self.ooo_frames += 1
            return []
        if status in ("gap", "unconfirmed"):
            self.gaps += 1
            # the missed window (or a bar whose final update was lost) is
            # REST-backfilled at drain time; mark the symbol dirty
            # (bypassing the throttle) so the drain happens promptly
            return [symbol] if self._mark_dirty(symbol, now, force=True) \
                else []
        if status in ("append", "update"):
            # feed the fused engine's scatter list directly: the drain's
            # full-window ingest then diffs to ZERO additional rows
            if self._engine_row(symbol, interval, row):
                self.streamed_rows += 1
        # a CLOSED candle always refreshes (that is the tick the engine
        # exists for); in-progress updates ride the reference throttle
        if self._mark_dirty(symbol, now, force=(closed
                                                or status == "seed_needed")):
            return [symbol]
        return []

    def _ingest_depth(self, payload: dict,
                      stream_name: str | None = None) -> list[str]:
        """Route one depth frame into the capture (never into the candle
        path — depth is flight-recorder material, not a market-data
        publication; no symbols are marked dirty).  Snapshot payloads
        carry no symbol field of their own — recover it from the
        combined-stream channel name (``btcusdc@depth20``)."""
        if self.depth is None:
            self.frames_ignored += 1             # no capture configured
            return []
        if "s" not in payload and stream_name:
            payload = {**payload,
                       "s": stream_name.split("@", 1)[0].upper()}
        self.depth.ingest(payload)               # counts its own outcomes
        return []

    def _book(self, symbol: str, interval: str) -> _CandleBook:
        key = (symbol, interval)
        book = self._books.get(key)
        if book is None:
            book = self._books[key] = _CandleBook(self.monitor.kline_limit,
                                                  interval_ms(interval))
        return book

    def _engine_row(self, symbol: str, interval: str, row: list) -> bool:
        mon = self.monitor
        if not getattr(mon, "fused", False):
            return False
        eng = mon._engine
        if eng is None:
            return False                 # cold engine: first drain seeds it
        try:
            return eng.ingest_row(symbol, interval, row)
        except KeyError:
            return False                 # universe changed under us

    # -- serving (the monitor's injected kline source) ------------------------
    def serve_klines(self, symbol: str, interval: str) -> list | None:
        """Kline source for `MarketMonitor.poll(fetch=…)`: the stream's own
        continuity-checked window on the happy path; breaker-protected REST
        (`monitor._fetch`) ONLY when the lane needs a (re)seed or a gap
        backfill — bounded to one fetch per lane per drain."""
        book = self._book(symbol, interval)
        fresh_s = max(2.0 * book.step_ms / 1000.0, self.book_fresh_s)
        if (book.needs_backfill
                or len(book.rows) < self.monitor.kline_limit
                or self.now_fn() - book.last_recv > fresh_s):
            self.backfills += 1
            rows = self.monitor._fetch(symbol, interval)
            if rows:
                book.seed(rows)
            return rows
        rows = _ServedWindow(book.rows)
        # steady-state fast path: every row in this window already rode
        # ingest_row into the engine's ring, so stamp the provenance that
        # lets the fused poll skip re-parsing + re-diffing all window ×
        # lane rows per tick (the dominant host cost once warm)
        eng = getattr(self.monitor, "_engine", None)
        if eng is not None and eng.lane_synced(symbol, interval):
            rows.engine_current = True
            self.served_current += 1
        return rows

    def _symbol_needs_backfill(self, symbol: str) -> bool:
        """Would serving this symbol hit REST?  (Same predicate
        `serve_klines` applies per lane — used to bound how many
        REST-needing symbols enter one drain.)"""
        now = self.now_fn()
        limit = self.monitor.kline_limit
        for iv in self.monitor.intervals:
            book = self._books.get((symbol, iv))
            if book is None:
                return True
            fresh_s = max(2.0 * book.step_ms / 1000.0, self.book_fresh_s)
            if (book.needs_backfill or len(book.rows) < limit
                    or now - book.last_recv > fresh_s):
                return True
        return False

    # -- draining -------------------------------------------------------------
    async def drain(self, limit: int | None = None) -> int:
        """Refresh up to ``limit`` dirty symbols (default ``batch_size``)
        through the monitor — publication + bus writes ride the existing,
        tested poll path, with `serve_klines` as the kline source so a
        happy-path drain performs zero REST kline calls.  Symbols whose
        lanes would hit REST are additionally bounded to
        ``backfill_batch`` per drain (the rest stay pending), so a
        reconnect gap over a wide universe repairs at the reference's
        batch cadence instead of bursting into the venue's rate limit."""
        if not self._pending:
            return 0
        limit = self.batch_size if limit is None else limit
        budget = max(int(self.backfill_batch), 1)
        batch = []
        for s in list(self._pending):
            if len(batch) >= limit:
                break
            if self._symbol_needs_backfill(s):
                if budget <= 0:
                    continue               # deferred to the next drain
                budget -= 1
            batch.append(s)
            del self._pending[s]
        if not batch:
            return 0
        return await self.monitor.poll(force=True, symbols=batch,
                                       fetch=self.serve_klines)

    async def run(self, frames: AsyncIterator[str]) -> int:
        """Consume a frame source to exhaustion (or cancellation); returns
        the number of updates published.

        Bursty sources micro-batch: after the head frame of a cycle, any
        frames already queued (or arriving within ``microbatch_s``) fold
        into the SAME ingest pass, so the whole burst rides ONE fused
        drain — one dispatch, one readback — instead of a dispatch per
        frame.  A frame that arrives after the budget is never dropped:
        its pending read becomes the next cycle's head."""
        published = 0
        it = frames.__aiter__()
        head_task = None            # a not-yet-arrived frame read, carried
        exhausted = False           # across cycles instead of cancelled
        while not exhausted:
            task = (head_task if head_task is not None
                    else asyncio.ensure_future(it.__anext__()))
            head_task = None
            try:
                frame = await task
            except StopAsyncIteration:
                break
            # one root span per burst: the stream is where a live tick's
            # causal chain begins, so downstream monitor/analyzer/executor
            # spans all hang off this trace
            with tracing.span("stream.frame", service="stream") as sp:
                marked = list(self.ingest_frame(frame))
                burst = 1
                while burst < max(self.microbatch, 1):
                    task = asyncio.ensure_future(it.__anext__())
                    done, _ = await asyncio.wait(
                        {task}, timeout=max(self.microbatch_s, 0.0))
                    if task not in done:
                        head_task = task   # arrives later → next cycle
                        break
                    try:
                        nxt = task.result()
                    except StopAsyncIteration:
                        exhausted = True
                        break
                    marked.extend(self.ingest_frame(nxt))
                    burst += 1
                if burst > 1:
                    self.micro_batches += 1
                    self.micro_batched_frames += burst
                n = await self.drain()
                sp.set_attribute("frames", burst)
                sp.set_attribute("marked", len(marked))
                sp.set_attribute("published", n)
                # fused-monitor drains: how many candle rows this batch
                # actually moved host→device (the ring-buffer delta)
                eng = getattr(self.monitor, "_engine", None)
                if n and eng is not None and eng.last_stats:
                    sp.set_attribute("engine_upload_rows",
                                     eng.last_stats.get("upload_rows"))
                    sp.set_attribute("engine_upload_bytes",
                                     eng.last_stats.get("upload_bytes"))
                published += n
        while self._pending:
            with tracing.span("stream.drain", service="stream"):
                published += await self.drain()
        return published


#: fault vocabulary the supervisor's edge alerts use
_DISCONNECT_ALERT = "StreamDisconnected"
_FLAPPING_ALERT = "StreamFlapping"


@dataclass
class StreamSupervisor:
    """Supervised feed lifecycle: bounded queue, reconnect with backoff +
    jitter, silence watchdog, edge-triggered alerts, `stream_*` gauges.

    Two driving modes share all bookkeeping:

      * **pump mode** (live): `pump()` owns the transport — it builds a
        source from ``source_factory``, reads frames under connect/read
        timeouts into the bounded queue, and reconnects with exponential
        backoff + jitter on any failure.  `TradingSystem.run()` launches
        it as a background task.
      * **push mode** (tests / tick-driven soaks): the harness calls
        `offer(frame)` directly and `connection_lost()` to simulate
        transport failures; the next `offer` marks the connection
        restored.  Deterministic — the clock and sleeps are injectable.

    Either way the launcher drives `step()` once per tick: watchdog →
    queued frames → one batched drain (ONE fused dispatch) → gauge export.
    """

    stream: MarketStream
    source_factory: Callable[[], AsyncIterator[str] | None] | None = None
    bus: object | None = None                    # EventBus for edge alerts
    metrics: object | None = None                # MetricsRegistry
    now_fn: Callable[[], float] = time.time
    queue_max: int = 4096
    max_silence_s: float = 30.0                  # watchdog: forced reconnect
    stale_after_s: float = 30.0                  # degrade-to-poll budget
    connect_timeout_s: float = 10.0
    read_timeout_s: float = 30.0
    backoff_s: float = 1.0
    backoff_max_s: float = 60.0
    jitter: float = 0.25
    flap_window_s: float = 120.0
    flap_threshold: int = 3
    # entropy-seeded by default: jitter exists to DECORRELATE a fleet's
    # reconnect storms — a fixed seed would synchronize the herd.  Tests
    # needing determinism inject rng=random.Random(k).
    rng: random.Random = field(default_factory=random.Random)
    sleep: Callable[[float], "asyncio.Future"] = field(default=asyncio.sleep)

    connected: bool = False
    reconnects: int = 0                          # successful RE-connections
    disconnects: int = 0
    frames_dropped: int = 0                      # queue overflow (drop-oldest)
    frames_offered: int = 0

    def __post_init__(self):
        self._q: deque = deque()
        # bounded: with no bus attached (standalone push mode / bench
        # rigs) nothing drains this — a flapping source must not leak
        self._pending_alerts: deque = deque(maxlen=256)
        self._disconnect_times: deque = deque(maxlen=64)
        self._ever_connected = False
        self._flapping = False
        self._consec_failures = 0
        self._last_frame_at: float | None = None
        self._started_at = self.now_fn()
        self._exported: dict = {}

    # -- transport-facing surface --------------------------------------------
    def offer(self, frame: str) -> None:
        """Enqueue one raw frame (drop-oldest past ``queue_max`` — a burst
        must not outrun a slow drain, the bus's bounded-channel policy)."""
        if len(self._q) >= self.queue_max:
            self._q.popleft()
            self.frames_dropped += 1
        self._q.append(frame)
        self.frames_offered += 1
        self._last_frame_at = self.now_fn()
        self._consec_failures = 0
        if not self.connected:
            self.connected = True
            if self._ever_connected:
                self.reconnects += 1
            self._ever_connected = True

    def connection_lost(self, reason: str = "") -> None:
        """Record a transport failure (edge-triggered alert + flap check).
        Safe to call repeatedly; only the connected→disconnected edge
        counts and alerts."""
        if not self.connected:
            return
        self.connected = False
        self.disconnects += 1
        now = self.now_fn()
        self._disconnect_times.append(now)
        self._pending_alerts.append({
            "name": _DISCONNECT_ALERT, "severity": "warning",
            "service": "stream", "message": reason or "connection lost",
            "at": now})
        recent = [t for t in self._disconnect_times
                  if now - t <= self.flap_window_s]
        if len(recent) >= self.flap_threshold and not self._flapping:
            self._flapping = True
            self._pending_alerts.append({
                "name": _FLAPPING_ALERT, "severity": "warning",
                "service": "stream",
                "message": f"{len(recent)} disconnects in "
                           f"{self.flap_window_s:.0f}s",
                "at": now})
        elif len(recent) < self.flap_threshold:
            self._flapping = False

    # -- health ---------------------------------------------------------------
    def staleness(self, now: float | None = None) -> float:
        """Seconds since the last frame ARRIVED (host receive time — an
        exchange-lagged feed is caught by the ticker event-time fence)."""
        now = self.now_fn() if now is None else now
        anchor = self._last_frame_at if self._last_frame_at is not None \
            else self._started_at
        return max(now - anchor, 0.0)

    def degraded(self, now: float | None = None) -> bool:
        """True while the polling monitor should carry the load: never
        connected, disconnected, or silent past the staleness budget."""
        return (not self.connected) or self.staleness(now) > self.stale_after_s

    # -- the per-tick stage ----------------------------------------------------
    async def step(self) -> int:
        """One supervised drain: watchdog → queued frames → ONE batched
        monitor refresh (one fused dispatch) → alert flush + gauge export.
        Returns #updates published.  Under tracing a ``stream.step`` span
        holds ``stream.parse`` (the queued frames into the candle books and
        the engine's scatter list; attributes ``frames``, ``rows`` applied,
        ``malformed``) and ``stream.drain`` (the monitor's refresh)."""
        now = self.now_fn()
        if (self.connected and self._last_frame_at is not None
                and now - self._last_frame_at > self.max_silence_s):
            # a connected-but-silent socket is a dead peer the TCP stack
            # has not noticed yet; force the reconnect path
            self.connection_lost(
                f"silence watchdog: no frames for "
                f"{now - self._last_frame_at:.0f}s")
        depth = len(self._q)
        published = 0
        st = self.stream
        with tracing.span("stream.step", service="stream") as sp:
            with tracing.span("stream.parse", service="stream") as parse:
                rows, malformed = st.streamed_rows, st.malformed_frames
                while self._q:
                    st.ingest_frame(self._q.popleft())
                parse.set_attribute("frames", depth)
                parse.set_attribute("rows", st.streamed_rows - rows)
                parse.set_attribute("malformed", st.malformed_frames - malformed)
            with tracing.span("stream.drain", service="stream"):
                # a healthy stream must not starve universe lanes its
                # subscription isn't feeding — route them through the drain
                st.mark_starved(now)
                if st._pending:
                    published = await st.drain(limit=len(st._pending))
            sp.set_attribute("frames", depth)
            sp.set_attribute("published", published)
        if self.bus is not None:
            for alert in self._pending_alerts:
                await self.bus.publish("alerts", alert)
            self._pending_alerts.clear()
        self.export(now)
        return published

    def _delta(self, name: str, value: int) -> int:
        """Monotonic-counter delta since the last export (registry counters
        are cumulative; the supervisor's own counters are totals)."""
        prev = self._exported.get(name, 0)
        self._exported[name] = max(value, prev)
        return max(value - prev, 0)

    def export(self, now: float | None = None) -> None:
        """`stream_*` gauges + monotonic counters (delta-exported so the
        Prometheus counters survive repeated calls)."""
        m = self.metrics
        if m is None:
            return
        now = self.now_fn() if now is None else now
        st, d = self.stream, self._delta
        m.set_gauge("stream_connected", 1.0 if self.connected else 0.0)
        m.set_gauge("stream_staleness_seconds", self.staleness(now))
        m.set_gauge("stream_queue_depth", len(self._q))
        m.inc("stream_reconnects_total",
              d("stream_reconnects_total", self.reconnects))
        m.inc("stream_disconnects_total",
              d("stream_disconnects_total", self.disconnects))
        m.inc("stream_frames_dropped_total",
              d("stream_frames_dropped_total", self.frames_dropped))
        m.inc("stream_frames_total", d("stream_frames_total", st.frames_in))
        m.inc("stream_gaps_total", d("stream_gaps_total", st.gaps))
        m.inc("stream_backfills_total",
              d("stream_backfills_total", st.backfills))
        m.inc("stream_dup_frames_total",
              d("stream_dup_frames_total", st.dup_frames))
        m.inc("stream_out_of_order_total",
              d("stream_out_of_order_total", st.ooo_frames))
        m.inc("stream_malformed_frames_total",
              d("stream_malformed_frames_total", st.malformed_frames))
        m.inc("stream_micro_batches_total",
              d("stream_micro_batches_total", st.micro_batches))
        m.inc("stream_micro_batched_frames_total",
              d("stream_micro_batched_frames_total",
                st.micro_batched_frames))
        dc = st.depth
        if dc is not None:
            # depth-capture telemetry rides the same export: totals as
            # monotonic counters, the ring watermark as a gauge (the
            # leading indicator the DepthCaptureSaturated alert watches)
            m.inc("depth_frames_total",
                  d("depth_frames_total", dc.frames_total))
            m.inc("depth_frames_dropped_total",
                  d("depth_frames_dropped_total", dc.frames_dropped))
            m.inc("depth_gaps_total", d("depth_gaps_total", dc.gaps))
            m.set_gauge("depth_capture_ring_fill", dc.watermark)

    # -- the wall-clock transport loop ----------------------------------------
    def _backoff_delay(self) -> float:
        base = min(self.backoff_s * 2.0 ** max(self._consec_failures - 1, 0),
                   self.backoff_max_s)
        return base * (1.0 + self.jitter * self.rng.random())

    async def pump(self) -> None:
        """Own the transport: connect via ``source_factory``, read frames
        under timeouts into the queue, reconnect with backoff + jitter on
        any failure.  A factory returning None ends the pump (scripted
        test sources); cancellation propagates cleanly."""
        if self.source_factory is None:
            raise ValueError("pump() needs a source_factory")
        while True:
            source = self.source_factory()
            if source is None:
                self.connection_lost("source factory exhausted")
                return
            reason = "stream closed"
            try:
                it = source.__aiter__()
                timeout = self.connect_timeout_s
                while True:
                    frame = await asyncio.wait_for(it.__anext__(), timeout)
                    # reads are bounded by the SILENCE budget too: the
                    # watchdog in step() marks a quiet socket dead, and the
                    # pump must actually tear it down on the same clock —
                    # otherwise a late frame on the old socket would be
                    # miscounted as a reconnect of a link that never dropped
                    timeout = min(self.read_timeout_s, self.max_silence_s)
                    self.offer(frame)
            except StopAsyncIteration:
                pass
            except asyncio.CancelledError:
                self.connection_lost("cancelled")
                raise
            except asyncio.TimeoutError:
                reason = f"read timeout ({timeout:.0f}s)"
            except Exception as exc:             # noqa: BLE001 — reconnect on
                reason = f"{type(exc).__name__}: {exc}"
            self.connection_lost(reason)
            self._consec_failures += 1
            await self.sleep(self._backoff_delay())


async def replay_frames(frames: list[str], *,
                        delay_s: float = 0.0) -> AsyncIterator[str]:
    """Recorded-frame source for tests/paper mode (zero egress)."""
    for f in frames:
        if delay_s:
            await asyncio.sleep(delay_s)
        yield f


class BinanceStreamSource:
    """Real-network frame source (used live, not in tests).

    Requires a websocket client library; this environment ships none, so
    construction degrades with a clear message — the seam mirrors
    BinanceExchange's injected-client gate.  The import happens ONCE at
    construction; iteration applies a connect timeout and closes the
    socket explicitly on exit or cancellation (no reliance on GC of the
    `async with` frame)."""

    def __init__(self, url: str = BINANCE_WS, *,
                 ping_interval_s: float = 20.0,
                 connect_timeout_s: float = 10.0):
        try:
            import websockets
        except ImportError as e:
            raise RuntimeError(
                "BinanceStreamSource needs the 'websockets' package (not "
                "installed here). Inject recorded frames via replay_frames "
                "or any async iterator of frame strings instead.") from e
        self._websockets = websockets            # imported once, cached
        self.url = url
        self.ping_interval_s = ping_interval_s
        self.connect_timeout_s = connect_timeout_s

    async def __aiter__(self):
        ws = await asyncio.wait_for(
            self._websockets.connect(self.url,
                                     ping_interval=self.ping_interval_s),
            self.connect_timeout_s)
        try:
            async for frame in ws:
                yield frame
        finally:
            # explicit close even when the consuming task is cancelled
            # mid-read — a GC'd generator would leak the socket
            await ws.close()
