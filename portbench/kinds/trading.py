"""The trading cells: a streamed multi-tenant trader, one tick in flight.

Each tick the venue's clock moves one 1-minute candle on a tape made from
the seed (`portbench.traffic.klines`), and the current candle of every
symbol and frame arrives as a kline frame.  From the first frame offered
to the last decision read on the host the tick runs through the port's
serving path: `StreamSupervisor.offer` and `step` (the frames parsed into
the candle books, the drain through `MarketMonitor.poll`, one
`TickEngine.step` over every symbol and frame, the updates published on
the bus), then `TenantEngine.feats_from_tick` and `TenantEngine.decide`
over every tenant and symbol, read once.  The decisions stop there: no
order is sent, so each tenant's state carries only the engine's own
entries from one tick to the next.

Judged afterwards by `portbench.reference.decide`: the features the
program handed to the decide on ticks drawn from the seed against the
reference's features from the same candles; the decisions on those ticks
and the state after the last tick against the reference's decide carried
over every tick from the first, on the program's features.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from portbench import spans
from portbench.kinds import seed_of
from portbench.reference import decide as ref
from portbench.traffic.klines import Tape, interval_minutes



class Cell:
    """One run of a trading cell on ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        self.torch, self.device = torch, torch.device(device)
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.intervals = tuple(config["intervals"])
        self.window = int(config["window"])
        self.tenants = int(traffic["tenants"])
        self.history = self.window * max(interval_minutes(iv) for iv in self.intervals) + 56
        n = (self.history + int(traffic["max_warmup_ticks"]) + int(traffic["warmup_ticks"])
             + int(traffic["max_ticks"]) + 8)
        self.tape = Tape(int(config["symbols"]), n, seed)
        self.tape.advance(self.history)
        self.symbols = self.tape.symbols
        self.spans = spans.Spans(self.device)
        self.clock = 0.0
        self.ticks: list = []         # every decide's features and cursor
        self.kept: list = []          # the reservoir: (tick, outputs)
        self.host_ms: list = []       # a traced run's host times of each tick
        self._step_ms = 0.0
        self._draw = np.random.default_rng(seed_of(seed, 2))
        self.tenant_rows = ref.draw_tenants(config["tenant"], self.tenants, seed_of(seed, 1))
        self._loop = asyncio.new_event_loop()
        self.tracer = None
        self.reference_s = 0.0        # set-up runs nothing of the reference

    def _build(self) -> None:
        from ai_crypto_trader_tpu_torch.config import TradingParams
        from ai_crypto_trader_tpu_torch.ops.tenant_engine import TenantEngine
        from ai_crypto_trader_tpu_torch.shell.bus import EventBus
        from ai_crypto_trader_tpu_torch.shell.monitor import MarketMonitor
        from ai_crypto_trader_tpu_torch.shell.stream import MarketStream, StreamSupervisor
        from ai_crypto_trader_tpu_torch.utils.metrics import MetricsRegistry

        now = lambda: self.clock  # noqa: E731
        t = self.config["tenant"]
        self.metrics = MetricsRegistry(now_fn=now)
        self.bus = EventBus(now_fn=now, metrics=self.metrics)
        self.monitor = MarketMonitor(self.bus, self.tape, symbols=self.symbols,
                                     intervals=self.intervals, kline_limit=self.window,
                                     now_fn=now, device=self.device)
        self.supervisor = StreamSupervisor(MarketStream(self.monitor, now_fn=now), bus=self.bus,
                                           metrics=self.metrics, now_fn=now)
        self.engine = TenantEngine(self.symbols, self.tenants,
                                   trading=TradingParams(min_trade_amount=t["min_trade_amount"]),
                                   confidence_scale=t["confidence_scale"],
                                   fee_rate=t["fee_rate"], containment=self.config["containment"],
                                   quarantine_cooldown=t["quarantine_cooldown"],
                                   device=self.device)
        rows = self.tenant_rows
        for i in range(self.tenants):
            self.engine.set_tenant(i, balance=float(rows["balance"][i]),
                                   **{k: rows[k][i] for k in ("conf_threshold", "min_strength",
                                                              "max_positions", "min_trade")})
        self.updates = self.bus.subscribe("market_updates")

    # -- the timed path ------------------------------------------------------
    async def tick(self) -> tuple[int, float]:
        """One tick: (decisions read, milliseconds from the first frame
        offered to the decisions read)."""
        sp, eng = self.spans, self.engine
        self.clock += float(self.config["tick_step_s"])
        self.tape.advance()
        frames = self.tape.frames(self.intervals)
        t0 = time.perf_counter()
        with sp.label("stream"):
            for f in frames:
                self.supervisor.offer(f)
            await self.supervisor.step()
        t1 = time.perf_counter()
        with sp.label("decide"):
            due = np.zeros(eng.S, bool)
            while not self.updates.empty():
                s = eng.sym_index.get(self.updates.get_nowait()["data"]["symbol"])
                if s is not None:
                    due[s] = True
            decided, out, feats = 0, None, None
            tick_eng = self.monitor._engine
            if due.any() and tick_eng is not None and tick_eng.last_out is not None:
                feats = eng.feats_from_tick(tick_eng.last_out, tick_eng.last_valid, due_mask=due)
                out = eng.decide(feats)
                decided = int((out["gate"][:, :len(self.symbols)] != ref.NO_DECISION).sum())
        t2 = time.perf_counter()
        if feats is not None:
            # the program's host arrays are fresh every tick: kept, not copied
            self.ticks.append((feats, self.tape.cursor))
            self._reservoir(len(self.ticks) - 1, out)
        if sp.enabled:
            self.host_ms.append({"stream": (t1 - t0) * 1e3, "tick": self._step_ms,
                                 "decide": (t2 - t1) * 1e3, "total": (t2 - t0) * 1e3,
                                 "profiled": self.tracer is not None and self.tracer.started})
        return decided, (t2 - t0) * 1e3

    def _reservoir(self, i: int, out: dict) -> None:
        """Keep the outputs of ``check_ticks`` window ticks drawn from the
        seed, and always the newest tick's."""
        self._last = (i, out)
        if not self._timed:
            return
        k, j = int(self.traffic["check_ticks"]), len(self._window_ticks)
        self._window_ticks.append(i)
        if len(self.kept) < k:
            self.kept.append((i, self._last[1]))
        else:
            r = int(self._draw.integers(0, j + 1))
            if r < k:
                self.kept[r] = (i, self._last[1])

    def lanes(self) -> int:
        return self.tenants * len(self.symbols)

    def prepare(self) -> None:
        """Set-up: the candle books seeded and every lane warm (a tick that
        decides every tenant and symbol), then ``warmup_ticks`` more, which
        take every frame's bar across a boundary."""
        self._build()
        self._timed, self._window_ticks, self._last = False, [], None
        for _ in range(int(self.traffic["max_warmup_ticks"])):
            decided, _ = self._loop.run_until_complete(self.tick())
            if decided == self.lanes():
                break
        else:
            raise RuntimeError("the trading cell's lanes did not all warm up")
        for _ in range(int(self.traffic["warmup_ticks"])):
            self._loop.run_until_complete(self.tick())
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self._timed = True

    def trace_steps(self) -> None:
        """Time `TickEngine.step` on the host (a traced run only)."""
        eng = self.monitor._engine
        real = eng.step

        def step():
            t = time.perf_counter()
            try:
                return real()
            finally:
                self._step_ms = (time.perf_counter() - t) * 1e3
        eng.step = step

    def shapes(self) -> dict:
        return {"symbols": len(self.symbols), "frames": len(self.intervals),
                "window": self.window, "tenants": self.tenants}

    # -- after the window ----------------------------------------------------
    def release(self) -> dict:
        """What the judgement reads, on the host; frees the card."""
        kept = sorted(self.kept + ([self._last] if self._last[0] not in
                                   {i for i, _ in self.kept} else []), key=lambda x: x[0])
        records = {"ticks": self.ticks, "kept": kept,
                   "state": {k: np.array(v) for k, v in self.engine._state_np.items()}}
        self._loop.close()
        self.engine = self.monitor = self.supervisor = self.bus = None
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()
        return records

    def judge(self, records: dict) -> tuple[list, dict]:
        """The check's numbers for each kept tick, and notes."""
        t, ticks = self.config["tenant"], records["ticks"]
        n, S = self.tenants, len(self.symbols)
        state = ref.initial_state(self.tenant_rows["balance"], S)
        params = ref.tenant_params(self.tenant_rows, t)
        kept = dict(records["kept"])
        per_tick, notes = [], {"ticks": len(ticks), "kept": sorted(kept)}
        executed = edges = 0
        for i, (feats, cursor) in enumerate(ticks):
            out, state = ref.decide(state, params, {k: v[:S] for k, v in feats.items()},
                                    containment=self.config["containment"])
            executed += int((out["gate"] == ref.EXECUTABLE).sum())
            if i in kept:
                got = decision_numbers(kept[i], out)
                want = self.reference_features(cursor)
                edges += int(want["borderline"].sum())
                got.update(feature_numbers(feats, want))
                if i == len(ticks) - 1:
                    got.update(state_numbers(records["state"], state, n, S))
                per_tick.append(got)
        notes.update(executed=executed, borderline=edges)
        return per_tick, notes

    def reference_features(self, cursor: int, fmt: str = "f32") -> dict:
        """The reference's [S] features of the tape at ``cursor``."""
        here = self.tape.cursor
        self.tape.cursor = cursor
        try:
            rows = [ref.tick_features(self.tape.window(s, self.window), fmt) for s in self.symbols]
        finally:
            self.tape.cursor = here
        return {k: np.array([r[k] for r in rows]) for k in rows[0]}


def _gap(p, r, scale=None) -> float:
    """The largest gap between ``p`` and ``r`` over ``scale`` (per element:
    the larger of |r| and a tiny number); NaN on one side only is infinite."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    both = np.isnan(p) & np.isnan(r)
    den = np.maximum(np.abs(r), 1e-30) if scale is None else scale
    gap = np.where(both, 0.0, np.abs(p - r) / den)
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(gap.max()) if gap.size else 0.0


def feature_numbers(feats: dict, want: dict) -> dict:
    """Stage F: the program's features of one tick against the reference's;
    the signal and its strength on the symbols whose candle is not
    borderline (`reference.decide.BANDS`)."""
    S = want["price"].shape[0]
    got = {k: np.asarray(v)[:S] for k, v in feats.items()}
    clear = ~np.asarray(want["borderline"], bool)
    return {"tick_signal_mismatch": float(np.sum(got["signal"][clear] != want["signal"][clear])),
            "tick_strength_err": _gap(got["strength"][clear], want["strength"][clear], 1.0),
            "tick_feature_err": max(_gap(got[k], want[k])
                                    for k in ("price", "volatility", "avg_volume"))}


def decision_numbers(got: dict, want: dict) -> dict:
    """Stage D: the program's decisions of one tick against the reference's
    decide carried to it."""
    return {"decide_gate_mismatch": float(np.sum(got["gate"] != want["gate"])),
            "decide_confidence_err": _gap(got["confidence"], want["confidence"], 1.0),
            "decide_size_err": max(_gap(got["size"], want["size"]),
                                   _gap(got["equity"], want["equity"]))}


def state_numbers(got: dict, want: dict, n: int, S: int) -> dict:
    """The state after the last tick: open positions that differ count as
    mismatched decisions; the balance and the peak equity by their gap."""
    return {"decide_state_mismatch": float(np.sum(got["open"][:n, :S] != want["open"])),
            "decide_state_err": max(_gap(got[k][:n], want[k])
                                    for k in ("balance", "peak_equity"))}


async def _window(cell: Cell, seconds: float, tracer) -> dict:
    attempted = failed = decisions = 0
    tick_ms = []
    lanes, last = cell.lanes(), int(cell.traffic["max_ticks"])
    t_start = now = time.perf_counter()
    while now - t_start < seconds and attempted < last:
        if tracer is not None:
            tracer.tick(now - t_start)
        decided, ms = await cell.tick()
        attempted += 1
        if decided == lanes:
            decisions += decided
        else:
            failed += 1
        tick_ms.append(ms)
        now = time.perf_counter()
    return {"attempted": attempted, "failed": failed, "decisions": decisions,
            "tick_ms": tick_ms, "elapsed": now - t_start}


def run_window(cell: Cell, seconds: float, tracer=None) -> dict:
    """The measured window: ticks back to back until ``seconds`` have
    passed.  The rate is over all decisions read and all the time."""
    if cell.spans.enabled:
        cell.trace_steps()
    cell.tracer = tracer
    w = cell._loop.run_until_complete(_window(cell, seconds, tracer))
    if tracer is not None:
        tracer.close()
    ms = w["tick_ms"]
    return {"attempted": w["attempted"], "failed": w["failed"], "window_s": w["elapsed"],
            "request_ms": ms,
            "end_to_end": {"decisions_per_s": w["decisions"] / w["elapsed"]}}


def control_numbers(cell: Cell) -> dict:
    """The judgement's numbers with the reference in bfloat16 in the
    program's place, over the first ``control_ticks`` ticks of the cell's
    tape from the set-up's start: its features on ``check_ticks`` ticks
    drawn from the seed, and its decide carried over the reference's
    features of every tick."""
    t = cell.config["tenant"]
    n, S = cell.tenants, len(cell.symbols)
    count = int(cell.traffic["control_ticks"])
    start = cell.tape.cursor
    rng = np.random.default_rng(seed_of(cell.seed, 4))
    checked = set(rng.choice(count, size=min(int(cell.traffic["check_ticks"]), count),
                             replace=False).tolist()) | {count - 1}
    state = low_state = ref.initial_state(cell.tenant_rows["balance"], S)
    params = ref.tenant_params(cell.tenant_rows, t)
    numbers: dict = {}
    worst = lambda got: {k: max(v, numbers.get(k, 0.0)) for k, v in got.items()}  # noqa: E731
    for i in range(count):
        want = cell.reference_features(start + 1 + i)
        feats = {k: want[k] for k in ref.FEATURES[:-1]}
        feats["valid"] = np.ones(S, bool)
        out, state = ref.decide(state, params, feats, containment=cell.config["containment"])
        low_out, low_state = ref.decide(low_state, params, feats,
                                        containment=cell.config["containment"], fmt="bf16")
        numbers.update(worst(decision_numbers(low_out, out)))
        if i in checked:
            low = cell.reference_features(start + 1 + i, "bf16")
            numbers.update(worst(feature_numbers(dict(low, valid=feats["valid"]), want)))
    numbers.update(worst(state_numbers(low_state, state, n, S)))
    return numbers
