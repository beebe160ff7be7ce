"""Deterministic chaos harness: seed-scheduled fault injection for the
exchange seam and the event bus.

The reference never tests failure paths (its tests hit live Binance —
SURVEY §4).  This module makes failure behavior a FIRST-CLASS test input:

  * ``FaultSchedule`` — a seeded RNG + scripted overrides deciding, per
    adapter call, which fault (if any) fires.  Same seed → same fault
    sequence, so a chaos soak failure replays exactly;
  * ``ChaosExchange`` — wraps any ExchangeInterface: raises connection
    errors, injects latency spikes (through an injectable sleep — virtual
    clocks stay virtual), serves stale/partial/malformed klines, and can
    crash MID-ORDER (after the venue accepted it — the ambiguous failure
    the write-ahead journal + client-id reconciliation exist for);
  * ``ChaosBus`` — EventBus with publish-side drop/duplicate/delay;
  * ``torn_tail`` — truncates a journal file mid-record (the crash-during-
    write(2) signature replay must tolerate).

Everything here is deterministic and wall-clock free; the kill-and-restart
chaos soak in tests/test_chaos.py drives the full stack through a scripted
fault schedule and asserts the recovery invariants.

Port of `ai_crypto_trader_tpu/testing/chaos.py`: the same fault vocabulary
and the same draws (``FaultSchedule`` rides Python's `random`, so one seed
gives one fault sequence in both packages).  The lane poisons write the
port's `TenantEngine` mirrors as the JAX package's do; the member poisons
copy the port's torch tensors of the RL fleet (`rl.population.PopState`).
"""

from __future__ import annotations

import random
from typing import Callable

import torch

from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.exchange import ExchangeInterface

#: fault kinds ChaosExchange understands, and the calls they apply to
READ_FAULTS = ("error", "latency", "stale", "partial", "malformed")
ORDER_FAULTS = ("error", "crash_after_order")
#: reads that can serve NaN/Inf payloads (the lane-poisoning input the
#: tenant engine's quarantine detector exists for)
POISON_FAULTS = ("poison",)

#: ExchangeInterface methods deliberately NOT routed through _fault.
#: Empty ON PURPOSE: every interface method today is fault-eligible, and
#: the drift test (tests/test_chaos.py) fails when a newly added adapter
#: method is neither wired through _fault nor explicitly listed here —
#: the __getattr__ passthrough can no longer silently exempt new surface.
FAULT_EXEMPT: frozenset = frozenset()


def lane_of_coid(client_order_id: str | None) -> int | None:
    """Lane index from a client-order-id in the load harness's per-lane
    namespace (``ld<i>-<tag>-<symbol>-<seq>``) — the key per-lane fault
    targeting routes on.  None for foreign namespaces (``wj-`` object
    lanes, venue-generated ids)."""
    if not client_order_id or not client_order_id.startswith("ld"):
        return None
    head = client_order_id.split("-", 1)[0]
    try:
        return int(head[2:])
    except ValueError:
        return None


class SimulatedCrash(BaseException):
    """The process 'died' here — the harness unwinds the tick and
    restarts the system from its journal.

    Deliberately a BaseException: process death must NOT be catchable by
    the resilience layers under test (ResilientExchange wraps Exception
    into ExchangeUnavailable, the stage supervisor isolates Exception) —
    it unwinds everything, like a real SIGKILL."""


class FaultSchedule:
    """Seed-deterministic fault decisions.

    ``rates`` maps fault kind → probability per eligible call; ``script``
    maps an absolute call index (the Nth adapter call overall) → fault
    kind, overriding the dice for that call.  One shared call counter
    covers all methods so a schedule is a total order of events.
    """

    def __init__(self, seed: int = 0, rates: dict | None = None,
                 script: dict | None = None,
                 outages: tuple = ()):
        self.rng = random.Random(seed)
        self.rates = dict(rates or {})
        self.script = dict(script or {})
        # venue outage windows: (start_call, end_call) half-open ranges of
        # the shared call counter during which EVERY error-eligible call
        # fails — a lane handed an outage-bearing schedule sees its venue
        # down for a deterministic stretch while the rest of the fleet
        # keeps trading
        self.outages = tuple(tuple(w) for w in outages)
        self.calls = 0
        self.injected: list = []          # (call_index, method, fault) log

    def next_fault(self, method: str, eligible: tuple) -> str | None:
        idx = self.calls
        self.calls += 1
        fault = self.script.get(idx)
        if fault is None and any(a <= idx < b for a, b in self.outages):
            fault = "error"
        if fault is None:
            # one draw per call regardless of eligibility → the fault
            # sequence is stable when eligibility sets differ per method
            draw = self.rng.random()
            acc = 0.0
            for kind, p in sorted(self.rates.items()):
                acc += p
                if draw < acc:
                    fault = kind
                    break
        if fault is None or fault not in eligible:
            return None
        self.injected.append((idx, method, fault))
        return fault


class ChaosExchange(ExchangeInterface):
    """Fault-injecting decorator for any ExchangeInterface.

    Sits UNDER ResilientExchange in the stack (chaos is what the breaker
    and retries are being tested against):

        FakeExchange → ChaosExchange → ResilientExchange → TradingSystem
    """

    def __init__(self, inner: ExchangeInterface, schedule: FaultSchedule,
                 sleep: Callable[[float], None] = lambda s: None,
                 latency_s: float = 2.0, lane: int | None = None,
                 lane_schedules: dict | None = None):
        self.inner = inner
        self.schedule = schedule
        self._sleep = sleep
        self.latency_s = latency_s
        self._kline_cache: dict = {}
        # per-lane fault targeting (the vmapped fleet's blast-radius
        # harness): ``lane`` tags a per-lane venue wrapper, and
        # ``lane_schedules`` maps lane -> its own FaultSchedule.  A tagged
        # wrapper with a lane schedule routes EVERY call through it;
        # additionally, order mutations carrying an ``ld<i>-`` client id
        # route to that lane's schedule even on a shared wrapper — faults
        # follow the client-order-id namespace, so "lane 3's venue is
        # broken" is expressible without touching lanes 0-2.
        self.lane = lane
        self.lane_schedules = dict(lane_schedules or {})

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # --- fault plumbing ----------------------------------------------------
    def _sched(self, client_order_id: str | None = None) -> FaultSchedule:
        lane = (lane_of_coid(client_order_id)
                if client_order_id is not None else self.lane)
        if lane is None:
            lane = self.lane
        return self.lane_schedules.get(lane, self.schedule)

    def _fault(self, method: str, eligible: tuple = READ_FAULTS):
        fault = self._sched().next_fault(method, eligible)
        if fault == "latency":
            self._sleep(self.latency_s)   # spike, then the call succeeds
            return None
        if fault == "error":
            raise ConnectionError(f"chaos: injected {method} failure")
        return fault

    # --- reads -------------------------------------------------------------
    def get_ticker(self, symbol):
        fault = self._fault("get_ticker",
                            ("error", "latency") + POISON_FAULTS)
        out = self.inner.get_ticker(symbol)
        if fault == "poison" and isinstance(out, dict):
            # NaN price: the payload poison a lane's mirror ingests if the
            # rim trusts the venue read blindly — the quarantine gate's prey
            out = dict(out)
            for k in ("price", "lastPrice", "last"):
                if k in out:
                    out[k] = float("nan")
        return out

    def get_order_book(self, symbol, limit=20):
        self._fault("get_order_book", ("error", "latency"))
        return self.inner.get_order_book(symbol, limit)

    def get_klines(self, symbol, interval="1m", limit=100):
        fault = self._fault("get_klines")
        key = (symbol, interval, limit)
        if fault == "stale" and key in self._kline_cache:
            return self._kline_cache[key]          # yesterday's answer
        rows = self.inner.get_klines(symbol, interval, limit)
        self._kline_cache[key] = rows
        if fault == "partial":
            return rows[: max(len(rows) // 2, 1)]  # truncated window
        if fault == "malformed":
            # a poisoned payload: NaN close and a short row — consumers
            # must reject/contain it, not trade on it
            bad = [list(r) for r in rows]
            if bad:
                bad[-1][4] = float("nan")
                bad[len(bad) // 2] = bad[len(bad) // 2][:3]
            return bad
        return rows

    def get_balances(self):
        fault = self._fault("get_balances",
                            ("error", "latency") + POISON_FAULTS)
        out = self.inner.get_balances()
        if fault == "poison" and isinstance(out, dict):
            out = {k: float("nan") for k in out} or {"USDC": float("nan")}
        return out

    def order_is_open(self, symbol, order_id):
        self._fault("order_is_open", ("error",))
        return self.inner.order_is_open(symbol, order_id)

    def executed_qty(self, symbol, order_id, assumed_total, is_open):
        self._fault("executed_qty", ("error",))
        return self.inner.executed_qty(symbol, order_id, assumed_total,
                                       is_open)

    def order_state(self, symbol, order_id, assumed_total):
        self._fault("order_state", ("error",))
        return self.inner.order_state(symbol, order_id, assumed_total)

    def find_order_by_client_id(self, symbol, client_order_id):
        self._fault("find_order_by_client_id", ("error",))
        return self.inner.find_order_by_client_id(symbol, client_order_id)

    def list_open_orders(self, symbol=None):
        self._fault("list_open_orders", ("error",))
        return self.inner.list_open_orders(symbol)

    def list_symbols(self, quote=None):
        # previously a bare passthrough — the exact drift the FAULT_EXEMPT
        # registry + drift test now make impossible to reintroduce
        self._fault("list_symbols", ("error", "latency"))
        return self.inner.list_symbols(quote)

    # --- mutations ---------------------------------------------------------
    def place_order(self, symbol, side, order_type, quantity, price=None,
                    stop_price=None, client_order_id=None):
        fault = self._sched(client_order_id).next_fault("place_order",
                                                        ORDER_FAULTS)
        if fault == "error":
            # clean failure: the request never reached the venue
            raise ConnectionError("chaos: order lost before the venue")
        out = self.inner.place_order(symbol, side, order_type, quantity,
                                     price, stop_price,
                                     client_order_id=client_order_id)
        if fault == "crash_after_order":
            # the AMBIGUOUS failure: the venue accepted the order but the
            # caller sees an exception — resolvable only by client id
            raise SimulatedCrash(
                f"chaos: died after {side} {order_type} reached the venue")
        return out

    def cancel_order(self, symbol, order_id):
        fault = self._sched().next_fault("cancel_order", ("error",))
        if fault == "error":
            raise ConnectionError("chaos: injected cancel failure")
        return self.inner.cancel_order(symbol, order_id)


BUS_FAULTS = ("bus_drop", "bus_dup", "bus_delay")


def inject_bus_faults(bus: EventBus, schedule: FaultSchedule,
                      exempt: tuple = ("alerts",)) -> EventBus:
    """Wrap an EventBus instance's publish with drop/duplicate/delay
    fault injection (transport loss the reference's Redis pub/sub can
    exhibit).  Delayed messages are delivered ahead of the next publish.
    ``exempt`` channels are never touched (alerts must stay observable —
    they are how the soak ASSERTS what happened)."""
    orig = bus.publish
    delayed: list = []

    async def publish(channel, message):
        delivered = 0
        if delayed:
            backlog = delayed[:]
            delayed.clear()
            for ch, msg in backlog:
                delivered += await orig(ch, msg)
        if channel in exempt:
            return delivered + await orig(channel, message)
        fault = schedule.next_fault(f"bus:{channel}", BUS_FAULTS)
        if fault == "bus_drop":
            bus.dropped_counts[channel] += 1
            return delivered
        if fault == "bus_delay":
            delayed.append((channel, message))
            return delivered
        delivered += await orig(channel, message)
        if fault == "bus_dup":
            delivered += await orig(channel, message)
        return delivered

    bus.publish = publish
    return bus


class ChaosBus(EventBus):
    """EventBus with publish-side fault injection built in (the standalone
    variant of inject_bus_faults for tests that construct their own bus)."""

    def __init__(self, *args, schedule: FaultSchedule | None = None,
                 exempt: tuple = ("alerts",), **kw):
        super().__init__(*args, **kw)
        inject_bus_faults(self, schedule or FaultSchedule(), exempt)


#: fault kinds ChaosFrameSource understands (the websocket-feed analogue
#: of READ_FAULTS): connection death, a silent-but-connected socket,
#: duplicate / out-of-order / malformed / stale frames, and burst floods.
STREAM_FAULTS = ("fs_disconnect", "fs_silence", "fs_dup", "fs_ooo",
                 "fs_malformed", "fs_stale", "fs_burst")


class ChaosFrameSource:
    """Seeded fault injection for a websocket frame feed (shell/stream.py).

    Works in both of the supervisor's driving modes:

      * **filter mode** (tick-driven soaks): ``filter(frames)`` applies the
        schedule to a batch of frames and returns
        ``(mutated_frames, disconnected)`` — the harness forwards the
        frames to ``StreamSupervisor.offer`` and calls
        ``connection_lost`` on a disconnect;
      * **iterator mode** (``pump()`` tests): ``aiter(inner)`` wraps any
        async frame iterator, applying the same faults per frame and
        raising ConnectionError on a disconnect.

    Faults: ``fs_disconnect`` (connection dies, frame lost),
    ``fs_silence`` (the next ``silence_frames`` frames vanish while the
    socket stays 'connected' — the watchdog's prey), ``fs_dup`` (exact
    re-send), ``fs_ooo`` (frame held and re-emitted AFTER its successor),
    ``fs_malformed`` (truncated JSON), ``fs_stale`` (event/open times
    rewound ``stale_ms`` — an old candle re-served), ``fs_burst``
    (one frame floods ``burst`` copies — the queue bound's prey).
    Deterministic: all decisions come from the shared FaultSchedule.
    """

    def __init__(self, schedule: FaultSchedule, *, silence_frames: int = 8,
                 burst: int = 64, stale_ms: int = 600_000):
        self.schedule = schedule
        self.silence_frames = silence_frames
        self.burst = burst
        self.stale_ms = stale_ms
        self.disconnects = 0
        self.silenced = 0
        self._silence_left = 0
        self._held: str | None = None

    def _restamp_stale(self, frame: str) -> str:
        """Rewind the frame's event/open timestamps — a stale re-send the
        continuity tracker must drop as out-of-order, never apply."""
        import json

        try:
            d = json.loads(frame)
        except ValueError:
            return frame
        body = d.get("data", d) if isinstance(d, dict) else None
        if not isinstance(body, dict):
            return frame
        if "E" in body:
            body["E"] = int(body["E"]) - self.stale_ms
        k = body.get("k")
        if isinstance(k, dict) and "t" in k:
            k["t"] = int(k["t"]) - self.stale_ms
        return json.dumps(d)

    def filter(self, frames: list) -> tuple[list, bool]:
        out: list = []
        disconnected = False
        for f in frames:
            if self._silence_left > 0:
                self._silence_left -= 1
                self.silenced += 1
                continue
            fault = self.schedule.next_fault("stream_frame", STREAM_FAULTS)
            if fault == "fs_disconnect":
                self.disconnects += 1
                disconnected = True
                continue                     # the frame dies with the socket
            if fault == "fs_silence":
                self._silence_left = self.silence_frames
                self.silenced += 1
                continue
            if fault == "fs_ooo":
                if self._held is None:
                    self._held = f           # held: re-emitted out of order
                    continue
                out.append(f)
            elif fault == "fs_dup":
                out.extend((f, f))
            elif fault == "fs_malformed":
                out.append(f[: max(len(f) // 2, 1)])
            elif fault == "fs_stale":
                out.append(self._restamp_stale(f))
            elif fault == "fs_burst":
                out.extend([f] * self.burst)
            else:
                out.append(f)
            if self._held is not None and fault != "fs_ooo":
                out.append(self._held)       # older frame lands AFTER newer
                self._held = None
        return out, disconnected

    async def aiter(self, inner):
        """Wrap an async frame iterator with the same fault schedule
        (ConnectionError on disconnect) — the pump()-mode adapter."""
        async for frame in inner:
            frames, disconnected = self.filter([frame])
            for f in frames:
                yield f
            if disconnected:
                raise ConnectionError("chaos: stream connection dropped")


def kline_frames_for(exchange, symbols, intervals, *, event_ms=None,
                     combined: bool = False) -> list:
    """Current-candle kline frames for every (symbol × interval) straight
    from an exchange's kline surface — the deterministic 'venue side' of a
    recorded feed (tests / soaks / bench; zero egress).

    The `x` (bar-closed) flag is honest, like the real stream's: a
    resampled 3m/5m/15m bar is only final once its last 1m constituent is
    in — the continuity tracker's torn-bar detection keys off it."""
    from ai_crypto_trader_tpu_torch.shell.stream import interval_ms, kline_frame

    frames = []
    for s in symbols:
        cur_1m = exchange.get_klines(s, "1m", 1)
        if not cur_1m:
            continue
        t_1m = int(cur_1m[-1][0])
        for iv in intervals:
            rows = exchange.get_klines(s, iv, 2)
            if not rows:
                continue
            step = interval_ms(iv)
            closed = (t_1m - int(rows[-1][0])) == step - 60_000
            frames.append(kline_frame(s, iv, rows[-1], closed=closed,
                                      event_ms=event_ms, combined=combined))
    return frames


class CountingKlines:
    """Transport-call counter around an exchange: the zero-REST-on-happy-
    path assertion (tests/test_stream.py and bench.py's stream_latency row
    share this ONE definition so they can never assert different things)."""

    def __init__(self, inner):
        self.inner = inner
        self.kline_calls = 0

    def get_klines(self, *a, **kw):
        self.kline_calls += 1
        return self.inner.get_klines(*a, **kw)

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)


def poison_lane_state(engine, lane: int, field: str = "balance",
                      value: float = float("nan")) -> None:
    """Inject NaN/Inf into ONE lane's slice of the tenant engine's donated
    state mirror (the per-lane poison the in-program quarantine detector
    exists for — a corrupted venue read the rim wrote through, a bad
    hot-patch, bit rot).  Array content: the next decide re-seeds and the
    detector trips that lane's `lane_quarantined` gate while every other
    lane stays bit-identical."""
    import numpy as np

    arr = engine._state_np[field]
    arr[lane] = value if arr.ndim == 1 else np.full(arr.shape[1:], value)
    engine._need_seed = True


def poison_lane_params(engine, lane: int, field: str = "conf_threshold",
                       value: float = float("nan")) -> None:
    """Inject NaN/Inf into one lane's strategy-param row — the config-push
    poison path (a bad per-tenant override).  Same containment contract as
    :func:`poison_lane_state`."""
    engine._params_np[field][lane] = value
    engine._need_seed = True


def _tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts, tuples and NamedTuples
    (the port's DQNState); anything else (the draw provider) is kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _set_row(x: torch.Tensor, member: int, value: float) -> torch.Tensor:
    """A copy of ``x`` with row ``member`` set to ``value``; ``x`` itself
    is left as it was."""
    out = x.clone()
    out[member] = value
    return out


def poison_member_state(pop, member: int, field: str = "params",
                        value: float = float("nan")):
    """Inject NaN/Inf into ONE member's slice of a PBT fleet's training
    state (the [P]-axis twin of :func:`poison_lane_state` — a diverged
    optimizer, bit rot in a replay ring, a bad restore).  Like the JAX
    package's, this RETURNS a new PopState and leaves ``pop`` as it was:
    each float tensor under the field is copied with row ``member``
    rewritten, so every other member's values are bit-identical.
    ``field`` names a DQNState field (``params``, ``opt_state``,
    ``replay``, …); every float tensor under it gets the poison.  The next
    generation's in-program finiteness scan (rl/dqn.poisoned_members)
    trips that member's quarantine bit."""

    def hit(x):
        if x.is_floating_point():
            return _set_row(x, member, value)
        return x

    members = pop.members._replace(
        **{field: _tree_map(hit, getattr(pop.members, field))})
    return pop._replace(members=members)


def poison_member_hypers(pop, member: int, field: str = "learning_rate",
                         value: float = float("nan")):
    """Inject NaN/Inf into one member's hyperparameter row — the explore-
    step poison path (a perturbation gone wrong, a corrupted checkpoint
    hyper).  A NaN learning rate NaNs the member's params within one
    learn step, so the same quarantine gate contains it.  Returns a new
    PopState; ``pop`` is left as it was."""
    arr = getattr(pop.hypers, field)
    hypers = pop.hypers._replace(**{field: _set_row(arr, member, value)})
    return pop._replace(hypers=hypers)


def poisoned_depth_records(symbol: str = "BTCUSDC", n: int = 4,
                           mode: str = "nan_spread") -> list:
    """Depth-capture snapshot records carrying the calibration poisons
    `sim/calibrate.validate_depth_records` must refuse: ``nan_spread``
    (NaN price levels), ``zero_depth`` (a side with no standing size —
    the degenerate book a venue serves mid-outage), ``crossed`` (best
    ask ≤ best bid).  Shaped exactly like DepthCapture's normalized
    records, so they feed a capture ring, a journal, or a recalibration
    window directly."""
    records = []
    for i in range(n):
        bids = [[100.0 - 0.5 * j, 2.0] for j in range(4)]
        asks = [[100.5 + 0.5 * j, 2.0] for j in range(4)]
        if mode == "nan_spread":
            bids[0][0] = float("nan")
        elif mode == "zero_depth":
            asks = [[p, 0.0] for p, _ in asks]
        elif mode == "crossed":
            asks[0][0] = bids[0][0] - 0.25
        else:
            raise ValueError(f"unknown poison mode {mode!r}")
        records.append({"symbol": symbol, "kind": "snapshot",
                        "E": 1_700_000_000_000 + i * 1000,
                        "U": i * 10, "u": i * 10 + 9,
                        "bids": bids, "asks": asks})
    return records


def torn_tail(path: str, keep_bytes: int = 17) -> None:
    """Truncate the file's final line mid-record — the on-disk signature
    of a crash during ``write(2)`` that journal replay must tolerate."""
    with open(path, "rb") as f:
        raw = f.read()
    body = raw.rstrip(b"\n")
    cut = body.rfind(b"\n")
    last = body[cut + 1:]
    keep = body[: cut + 1] + last[: min(keep_bytes, max(len(last) - 5, 0))]
    with open(path, "wb") as f:
        f.write(keep)
