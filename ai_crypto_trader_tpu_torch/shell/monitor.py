"""Market monitor service: klines → fused tick engine → market_updates.

Port of `ai_crypto_trader_tpu/shell/monitor.py`.  Per-symbol throttle,
multi-timeframe indicators, publication of `market_updates` and the
historical-data keys, breaker-protected exchange access — the JAX
monitor's host code, copied.

The indicator math runs through the port's FUSED TICK ENGINE
(`ops.tick_engine.TickEngine` on ``device``): the whole universe's poll —
indicators, signal features, volume profile, the 15 combination families,
confluence, for every (symbol × frame) — is ONE tick program against a
device-resident candle ring (three launches of the fused-EWMA kernel on
the card) and ONE host read, whatever the universe's size.  The
per-symbol path (`_features_from_klines`) is kept for off-universe
symbols, ``fused=False``, and the parity tests that pin the two paths
equal: tensors on the monitor's device through `ops.compute_indicators`
(two kernel launches on the card), `volume_profile` and the combination
scores, with ~40 scalar reads per symbol and frame, as in the JAX package.

``device=None`` means the CUDA card (``RuntimeError`` without one);
``device="cpu"`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch import ops
from ai_crypto_trader_tpu_torch.backtest import compute_signal_features, reference_signal
from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.ops.combinations import (
    combination_signal,
    combined_indicators,
)
from ai_crypto_trader_tpu_torch.obs import tickpath
from ai_crypto_trader_tpu_torch.ops.tick_engine import TickEngine
from ai_crypto_trader_tpu_torch.ops.volume_profile import volume_profile
from ai_crypto_trader_tpu_torch.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.shell.exchange import (
    ExchangeInterface,
    ResilientExchange,
)
from ai_crypto_trader_tpu_torch.strategy.generator import StrategyStructure
from ai_crypto_trader_tpu_torch.utils import tracing
from ai_crypto_trader_tpu_torch.utils.circuit_breaker import CircuitBreaker

TREND_LABELS = {1: "uptrend", 0: "sideways", -1: "downtrend"}
SIGNAL_LABELS = {1: "BUY", 0: "NEUTRAL", -1: "SELL"}


@dataclass
class MarketMonitor:
    bus: EventBus
    exchange: ExchangeInterface
    symbols: list[str] = field(default_factory=lambda: ["BTCUSDC"])
    # The reference fetches 1m/3m/5m/15m every pass
    # (`market_monitor_service.py:150-217`); trend blends 0.6·1m + 0.4·5m,
    # the other frames publish their own rsi_/macd_/signal_ columns.
    intervals: tuple = ("1m", "3m", "5m", "15m")
    throttle_s: float = 5.0
    kline_limit: int = 256
    now_fn: any = time.time
    breaker: CircuitBreaker | None = field(
        default_factory=lambda: CircuitBreaker("exchange", failure_threshold=3,
                                               reset_timeout_s=30.0))
    # Fused path: one tick-engine dispatch + one host sync per poll for the
    # whole configured universe.  False = the pre-engine per-symbol loop
    # (kept as the parity oracle and for ad-hoc off-universe polls).
    fused: bool = True
    max_new: int = 8                    # ring rows per (s, f) before re-seed
    # Pipelined tick path (ROADMAP item 4): the engine double-buffers the
    # candle ring and step() returns tick T−1's output while T computes on
    # device; the monitor carries each tick's publish context (due list,
    # fetched klines, wall clock, event-time snapshot) one poll forward so
    # published payloads stay byte-identical to serial mode at matched
    # ticks — the parity-test seam.  False = the serial dispatch+readback.
    pipelined: bool = False
    # Matmul precision for the fused decide program (the names of
    # device.canonical_precision); None = full f32.
    precision: str | None = None
    # where the tick engine and the per-symbol path compute: None = the
    # CUDA card, "cpu" = the plain versions of the kernels
    device: Any = None
    # per-symbol primary-frame feature drift ({symbol: {feature: PSI}}),
    # refreshed by each fused poll from the engine's on-device PSI output
    # (obs/drift.py); the launcher exports feature_psi gauges from this
    last_drift: dict = field(default_factory=dict)
    _engine: TickEngine | None = field(default=None, repr=False)
    _last_pub: dict = field(default_factory=dict)
    _warming: set = field(default_factory=set)
    # the in-flight tick's publish context (pipelined mode): consumed by
    # the NEXT poll's drain, invalidated when a dispatch fails so a
    # re-seeded ring can never pair with a stale context
    _pending_pub: dict | None = field(default=None, repr=False)

    def _note_warmup(self, symbol: str, interval: str, have: int):
        """Surface the cold-start gap (VERDICT r4 weak#5): a frame below the
        fixed window contributes no columns — the 15m frame needs ~2.7 days
        of venue history — and that used to happen silently. Logged once
        per transition; the current gaps live on the bus for /state.json."""
        key = (symbol, interval)
        warmup = self.bus.get(f"monitor_warmup_{symbol}") or {}
        if have < self.kline_limit:
            if key not in self._warming:
                self._warming.add(key)
                logging.getLogger(__name__).warning(
                    "monitor warmup: %s %s has %d/%d candles; frame "
                    "contributes no columns yet", symbol, interval, have,
                    self.kline_limit)
            warmup[interval] = {"have": have, "need": self.kline_limit}
            self.bus.set(f"monitor_warmup_{symbol}", warmup)
        elif key in self._warming:
            self._warming.discard(key)
            logging.getLogger(__name__).info(
                "monitor warmup complete: %s %s", symbol, interval)
            warmup.pop(interval, None)
            self.bus.set(f"monitor_warmup_{symbol}", warmup)

    def __post_init__(self):
        # A ResilientExchange already provides breaker+retry at the adapter
        # seam; stacking this service-level breaker on top would swallow its
        # ExchangeUnavailable (the launcher's skip-and-alert path) and
        # double-count failures. Resolve the question once here.
        if isinstance(self.exchange, ResilientExchange):
            self.breaker = None
        self.device = resolve_device(self.device)

    # -- the per-symbol path (parity oracle / off-universe fallback) ---------
    def _features_from_klines(self, klines: list,
                              with_combo_scores: bool = False) -> dict | None:
        # Fixed-shape discipline, as in the JAX package: exactly
        # kline_limit candles (a shorter window publishes nothing).
        if len(klines) < self.kline_limit:
            return None
        klines = klines[-self.kline_limit:]
        arr = np.asarray([row[1:6] for row in klines], np.float32)
        cols = torch.from_numpy(arr).to(self.device)
        arrays = {k: cols[:, j] for j, k in
                  enumerate(("open", "high", "low", "close", "volume"))}
        ind = ops.compute_indicators(arrays, device=self.device)
        feats = compute_signal_features(ind)
        signal, strength = reference_signal(feats)
        # volume profile (reference cadence: market_monitor_service.py:303-372)
        vp = volume_profile(arrays["high"], arrays["low"], arrays["close"],
                            arrays["volume"])
        combos = combined_indicators(ind)
        confluence = combination_signal(combos)
        i = -1
        close = arr[:, 3]
        def chg(n):
            return float((close[-1] - close[-1 - n]) / close[-1 - n] * 100) \
                if len(close) > n else 0.0
        return {
            "current_price": float(close[-1]),
            "rsi": float(ind["rsi"][i]),
            "stoch_k": float(ind["stoch_k"][i]),
            "macd": float(ind["macd"][i]),
            "williams_r": float(ind["williams_r"][i]),
            "bb_position": float(ind["bb_position"][i]),
            "atr": float(ind["atr"][i]),
            "volatility": float(feats.volatility[i]),
            "trend": TREND_LABELS[int(feats.trend[i])],
            "trend_strength": float(feats.trend_strength[i]),
            "avg_volume": float(feats.volume[i]),
            "signal": SIGNAL_LABELS[int(signal[i])],
            "signal_strength": float(strength[i]),
            "price_change_1m": chg(1), "price_change_3m": chg(3),
            "price_change_5m": chg(5), "price_change_15m": chg(15),
            "volume_profile": {
                "poc_price": float(vp["poc_price"]),
                "value_area_low": float(vp["value_area_low"]),
                "value_area_high": float(vp["value_area_high"]),
            },
            "confluence": float(confluence[i]),
            # latest combination scores, primary frame only (the structure
            # view's input; 15 device→host pulls, skipped for the 3
            # secondary frames whose copy would be discarded).  In key
            # order, as a dict comes back from the JAX package's jitted
            # programs: the first of tied families is the top family.
            **({"_combo_last": {n: float(c[-1])
                                for n, c in sorted(combos.items())}}
               if with_combo_scores else {}),
        }

    # -- the fused path ------------------------------------------------------
    def _get_engine(self) -> TickEngine:
        """Lazy engine keyed to the current universe config; rebuilt when
        symbols/intervals/window change (each sizes the engine's ring)."""
        eng = self._engine
        if (eng is None or eng.symbols != list(self.symbols)
                or eng.intervals != tuple(self.intervals)
                or eng.window != self.kline_limit
                or eng.max_new != self.max_new
                or eng.pipelined != self.pipelined
                or eng.precision != self.precision):
            self._engine = eng = TickEngine(
                self.symbols, self.intervals, window=self.kline_limit,
                max_new=self.max_new, pipelined=self.pipelined,
                precision=self.precision, device=self.device)
            self._pending_pub = None       # stale ctx can't pair with a
            #                                fresh engine's pipeline
        return eng

    def _extract_features(self, out: dict, s: int,
                          with_combo_scores: bool = False) -> dict | None:
        """Host-side slice of the engine's output pytree for one symbol's
        PRIMARY frame — the same payload `_features_from_klines` builds,
        with zero additional device syncs (`out` is already numpy)."""
        eng = self._engine
        f = 0                                   # primary frame lane
        if not eng.last_valid[s, f]:
            return None                         # warming (window < limit)
        def g(key):
            return float(out[key][s, f])
        return {
            "current_price": g("current_price"),
            "rsi": g("rsi"),
            "stoch_k": g("stoch_k"),
            "macd": g("macd"),
            "williams_r": g("williams_r"),
            "bb_position": g("bb_position"),
            "atr": g("atr"),
            "volatility": g("volatility"),
            "trend": TREND_LABELS[int(out["trend"][s, f])],
            "trend_strength": g("trend_strength"),
            "avg_volume": g("avg_volume"),
            "signal": SIGNAL_LABELS[int(out["signal"][s, f])],
            "signal_strength": g("signal_strength"),
            "price_change_1m": g("chg_1"), "price_change_3m": g("chg_3"),
            "price_change_5m": g("chg_5"), "price_change_15m": g("chg_15"),
            "volume_profile": {
                "poc_price": g("poc_price"),
                "value_area_low": g("value_area_low"),
                "value_area_high": g("value_area_high"),
            },
            "confluence": g("confluence"),
            **({"_combo_last": {n: float(c[s, f])      # key order, as above
                                for n, c in sorted(out["combo"].items())}}
               if with_combo_scores else {}),
        }

    def _structure_view(self, combo_last: dict) -> dict:
        """Live evaluation of the ADOPTED strategy structure (the
        generator's hot-swap surface, strategy/generator.py
        GeneratorService): StrategyStructure.blend_signal — the scalar
        twin of the search's own scoring — over the primary frame's latest
        combination scores, so the adopted structure drives the live
        context the analyzer/LLM gate sees."""
        payload = self.bus.get("strategy_structure")
        if not payload:
            return {}
        s = StrategyStructure.from_payload(payload)
        if s is None:
            return {}
        blend, signal = s.blend_signal(combo_last)
        return {"structure_blend": blend,
                "structure_signal": signal,
                "structure_version": payload.get("version")}

    @staticmethod
    def _family_view(combo_last: dict) -> dict:
        """Dominant combination family at this tick (the strongest of the
        15 family scores) — stamped on every update so the analyzer's
        signal, the executor's trade record and the journal closure all
        carry entry-signal provenance for PnL attribution
        (obs/attribution.py)."""
        if not combo_last:
            return {}
        fam = max(combo_last, key=lambda k: combo_last[k])
        return {"top_family": fam,
                "top_family_score": float(combo_last[fam])}

    def _fetch(self, symbol: str, interval: str):
        """Breaker-guarded per-interval fetch. Each frame is requested at
        its NATIVE interval with limit = kline_limit — the reference's
        four separate get_klines calls (`market_monitor_service.py:150-217`)
        and the only shape a real venue serves (Binance caps one request at
        1000 candles; a 15×kline_limit 1m mega-window would exceed it)."""
        if self.breaker is None:          # resilient seam (see __post_init__)
            return self.exchange.get_klines(symbol, interval, self.kline_limit)
        return self.breaker.call(self.exchange.get_klines, symbol, interval,
                                 self.kline_limit)

    async def poll(self, force: bool = False,
                   symbols: list[str] | None = None,
                   fetch=None) -> int:
        """One monitoring pass; returns #updates published.

        ``symbols`` narrows the pass to a subset (the push-feed path:
        shell/stream.py marks symbols dirty and refreshes just those);
        None = the full configured universe (the polling path).

        ``fetch`` overrides the kline source — a ``(symbol, interval) →
        rows`` callable.  The stream passes its continuity-checked candle
        books here (`MarketStream.serve_klines`) so a streamed drain
        publishes through this exact path with ZERO REST kline calls;
        None = the breaker-protected REST fetch (the polling transport).

        Fused mode batches every due in-universe symbol through ONE tick-
        engine dispatch; symbols outside the configured universe (possible
        with ``restrict_to_universe=False`` streams) ride the per-symbol
        path.  Multi-timeframe semantics are identical either way: trend
        strength is the reference's 0.6·primary + 0.4·5m blend, secondary
        frames contribute rsi_/macd_/signal_ columns
        (`market_monitor_service.py:219-301`)."""
        published = 0
        now = self.now_fn()
        due, seen = [], set()
        for symbol in (symbols if symbols is not None else self.symbols):
            if symbol in seen:
                continue
            seen.add(symbol)
            if force or now - self._last_pub.get(symbol, -1e18) >= self.throttle_s:
                due.append(symbol)
        if not due:
            return 0
        rest = due
        if self.fused:
            eng = self._get_engine()
            batch = [s for s in due if s in eng.sym_index]
            rest = [s for s in due if s not in eng.sym_index]
            if batch:
                published += await self._poll_fused(batch, now, fetch=fetch)
        for symbol in rest:
            with tracing.span("monitor.poll", service="monitor",
                              attributes={"symbol": symbol}):
                published += await self._poll_symbol(symbol, now, fetch=fetch)
        return published

    async def _poll_fused(self, due: list, now: float, fetch=None) -> int:
        """Fetch → ingest deltas → ONE dispatch + ONE readback → publish.

        Fetching stays per (symbol × frame) — a real venue serves native
        frames — but ALL device work for the batch is a single program and
        the only device→host sync is the engine's host_read.  Under tracing
        the batch's fetch and ingest is one ``monitor.ingest`` span; a
        symbol's fetches get a ``monitor.fetch`` span of their own only
        when they go to the venue (the monitor's REST `_fetch`), not when a
        stream serves them from its candle books."""
        eng = self._get_engine()
        venue = fetch is None
        fetch = fetch or self._fetch
        iv0 = self.intervals[0]
        fetched: dict = {}
        # Same failure semantics as the per-symbol loop: a raising fetch
        # (ResilientExchange's ExchangeUnavailable after exhausted retries)
        # stops fetching FURTHER symbols, but the symbols already fetched
        # still compute and publish this poll, and the exception re-raises
        # after the batch so the launcher's skip-and-alert path still fires.
        fetch_error: Exception | None = None
        t_parse0 = time.perf_counter()
        with tracing.span("monitor.ingest", service="monitor") as sp:
            counts = {"windows": 0, "rest_fetches": 0}
            rows0 = eng.queued_rows
            for symbol in due:
                # a venue fetch span covers ALL the symbol's frames + ring
                # ingest (hence "frames", not "interval" — see
                # docs/OBSERVABILITY.md)
                with tracing.span_if(venue, "monitor.fetch", service="monitor",
                                     attributes={"symbol": symbol,
                                                 "frames": len(self.intervals)}):
                    try:
                        self._fetch_lanes(eng, symbol, fetch, fetched, counts)
                    except Exception as e:   # noqa: BLE001 — re-raised below
                        fetch_error = e
                        fetched[(symbol, iv0)] = None   # this symbol: no publish
                if fetch_error is not None:
                    break
            sp.set_attribute("symbols", len(due))
            sp.set_attribute("frames", len(self.intervals))
            sp.set_attribute("rows", eng.queued_rows - rows0)
            for k, v in counts.items():
                sp.set_attribute(k, v)
        # parse/backfill phase (obs/tickpath.py): the whole fetch + ingest
        # diffing window for the batch — one fold per poll, one module check
        tickpath.observe_phase("parse", time.perf_counter() - t_parse0)
        ready = [s for s in due
                 if len(fetched.get((s, iv0)) or []) >= self.kline_limit]
        if not ready:
            # outage (every fetch None) or universe-wide cold start: nothing
            # can publish, so skip the dispatch + readback entirely — the
            # per-symbol path did zero device work here too.  Queued ingest
            # deltas stay pending and ride the next poll's step.  A
            # pipelined tick still in flight drains NOW rather than aging
            # behind an idle poll.
            published = 0
            if self.pipelined and self._pending_pub is not None:
                published = await self._flush_fused()
            if fetch_error is not None:
                raise fetch_error
            return published
        try:
            with tracing.span("monitor.tick_engine", service="monitor") as sp:
                out = eng.step()
                sp.set_attribute("symbols", len(due))
                for k, v in eng.last_stats.items():
                    sp.set_attribute(k, v)
        except Exception:
            # the engine dropped everything in flight and will re-seed;
            # its publish context must die with it — a stale context can
            # never pair with a later tick's output (duplicate publish)
            self._pending_pub = None
            raise
        if self.pipelined:
            # carry THIS tick's context forward; publish the PREVIOUS
            # tick's drained output with the context captured at ITS
            # dispatch, so payloads match serial mode byte for byte
            prev = self._pending_pub
            self._pending_pub = {"due": due, "fetched": fetched, "now": now,
                                 "event_ms": dict(eng.last_event_ms)}
            if out is None or prev is None:
                if fetch_error is not None:
                    raise fetch_error
                return 0                   # pipeline fill: nothing drained
            self._expose_drift(eng, prev["due"])
            published = await self._publish_batch(
                eng, out, prev["due"], prev["fetched"], prev["now"],
                event_ms=prev["event_ms"])
            if fetch_error is not None:
                raise fetch_error
            return published
        self._expose_drift(eng, due)
        published = await self._publish_batch(eng, out, due, fetched, now)
        if fetch_error is not None:
            raise fetch_error
        return published

    def _fetch_lanes(self, eng: TickEngine, symbol: str, fetch, fetched: dict,
                     counts: dict) -> None:
        """One symbol's windows of every frame into ``fetched``, each that
        the engine's ring does not already hold diffed into it.  A window
        without a stream's provenance (``engine_current``) came from the
        venue: counted in ``counts["rest_fetches"]``."""
        iv0 = self.intervals[0]
        kl = fetch(symbol, iv0)
        if kl is None:
            fetched[(symbol, iv0)] = None
            return
        # stream-served windows carry provenance: the engine ring already
        # holds every row (applied one-by-one via ingest_row as the frames
        # landed), so the full-window re-diff below would find zero
        # changes — skip the re-parse + re-diff for that lane entirely.
        # Any plain list (REST, tests) still takes the full path.
        current = getattr(kl, "engine_current", None)
        counts["rest_fetches"] += current is None
        kl = kl[-self.kline_limit:]
        fetched[(symbol, iv0)] = kl
        self._note_warmup(symbol, iv0, len(kl))
        if kl and not current:
            eng.ingest(symbol, iv0, kl)
            counts["windows"] += 1
        if len(kl) < self.kline_limit:
            return              # warming: no publish, like the per-symbol
            #                     path — skip secondaries
        for iv in self.intervals[1:]:
            res = fetch(symbol, iv)
            if res:
                cur = getattr(res, "engine_current", None)
                counts["rest_fetches"] += cur is None
                res = res[-self.kline_limit:]
                if not cur:
                    eng.ingest(symbol, iv, res)
                    counts["windows"] += 1
            fetched[(symbol, iv)] = res

    async def flush_pipeline(self) -> int:
        """Drain seam: collect + publish the in-flight pipelined tick, if
        any — the last tick's output at shutdown, the parity tests'
        equalizer, and the idle-poll drain.  No-op in serial mode."""
        if not self.pipelined or self._engine is None:
            return 0
        return await self._flush_fused()

    async def _flush_fused(self) -> int:
        eng = self._engine
        ctx, self._pending_pub = self._pending_pub, None
        out = eng.flush()                  # a failed drain re-seeds + raises
        if ctx is None or out is None:
            return 0
        self._expose_drift(eng, ctx["due"])
        return await self._publish_batch(eng, out, ctx["due"],
                                         ctx["fetched"], ctx["now"],
                                         event_ms=ctx["event_ms"])

    async def _publish_batch(self, eng: TickEngine, out: dict, due: list,
                             fetched: dict, now: float,
                             event_ms: dict | None = None) -> int:
        """Per-symbol feature extraction + bus fan-out for one drained
        tick — shared verbatim by the serial and pipelined paths.
        ``event_ms`` is the pipelined path's event-time snapshot captured
        at the tick's DISPATCH (serial passes None and reads the engine
        live — same values, the snapshot just pins them across the one
        -poll carry)."""
        t_pub0 = time.perf_counter()
        with tracing.span("monitor.publish", service="monitor") as sp:
            published = await self._publish_symbols(eng, out, due, fetched,
                                                    now, event_ms)
            sp.set_attribute("updates", published)
        # publish/fan-out phase: per-symbol feature extraction + bus set
        # + market_updates publish for the whole batch
        tickpath.observe_phase("publish", time.perf_counter() - t_pub0)
        return published

    async def _publish_symbols(self, eng: TickEngine, out: dict, due: list,
                               fetched: dict, now: float,
                               event_ms: dict | None) -> int:
        """`_publish_batch`'s loop: one ``monitor.poll`` span a symbol."""
        iv0 = self.intervals[0]
        ev_src = event_ms if event_ms is not None else eng.last_event_ms
        blend_iv = self._blend_iv()
        published = 0
        for symbol in due:
            kl = fetched.get((symbol, iv0))
            if not kl:
                continue
            with tracing.span("monitor.poll", service="monitor",
                              attributes={"symbol": symbol}):
                s = eng.sym_index[symbol]
                update = self._extract_features(out, s,
                                                with_combo_scores=True)
                if update is None:
                    continue
                combo_last = update.pop("_combo_last", None)
                if combo_last:
                    update.update(self._family_view(combo_last))
                    update.update(self._structure_view(combo_last))
                self.bus.set(f"historical_data_{symbol}_{iv0}", kl)
                # The 0.6/0.4 trend blend pairs the primary frame with 5m
                # specifically (`market_monitor_service.py:273`); other
                # frames contribute their per-interval columns (:285-298).
                for iv in self.intervals[1:]:
                    res = fetched.get((symbol, iv))
                    if not res:
                        continue
                    self.bus.set(f"historical_data_{symbol}_{iv}", res)
                    self._note_warmup(symbol, iv, len(res))
                    if len(res) < self.kline_limit:
                        continue               # frame still warming
                    f = eng.iv_index[iv]
                    if iv == blend_iv:
                        update["trend_strength"] = (
                            0.6 * update["trend_strength"]
                            + 0.4 * float(out["trend_strength"][s, f]))
                    update[f"signal_{iv}"] = SIGNAL_LABELS[
                        int(out["signal"][s, f])]
                    update[f"rsi_{iv}"] = float(out["rsi"][s, f])
                    update[f"macd_{iv}"] = float(out["macd"][s, f])
                update["symbol"] = symbol
                update["timestamp"] = now
                # venue event time (ms) for the event→decision age SLO:
                # the engine's newest candle/stream event time — the
                # analyzer stamps event_age_ms onto the flight-recorder
                # record from this field (obs/tickpath.py)
                ev_ms = ev_src.get(symbol)
                if ev_ms is not None:
                    update["event_ms"] = ev_ms
                self.bus.set(f"market_data_{symbol}", update)
                await self.bus.publish("market_updates", update)
                self._last_pub[symbol] = now
                published += 1
        return published

    def _expose_drift(self, eng: TickEngine, due: list) -> None:
        """Primary-frame PSI per polled symbol from the engine's on-device
        drift output (already in the one host readback — this is a pure
        numpy slice).  Lanes whose reference was captured only THIS step
        are skipped: their PSI was computed against the placeholder."""
        import math

        from ai_crypto_trader_tpu_torch.obs.drift import feature_names

        drift = eng.last_drift
        if not drift:
            return
        psi, ref_set = drift["psi"], drift["ref_set"]
        names = feature_names()
        for symbol in due:
            s = eng.sym_index.get(symbol)
            if s is None or not ref_set[s, 0] or not eng.last_valid[s, 0]:
                continue
            row = {name: float(psi[s, 0, k])
                   for k, name in enumerate(names)
                   if math.isfinite(float(psi[s, 0, k]))}
            if row:
                self.last_drift[symbol] = row

    def _blend_iv(self) -> str | None:
        """The secondary frame the 0.6/0.4 trend blend pairs with: 5m when
        configured (`market_monitor_service.py:273`), else the first
        secondary frame — shared by both poll paths so the rule cannot
        drift between them."""
        return "5m" if "5m" in self.intervals[1:] else (
            self.intervals[1] if len(self.intervals) > 1 else None)

    async def _poll_symbol(self, symbol: str, now: float,
                           fetch=None) -> int:
        """Fetch → features → publish for one symbol — the per-symbol path
        (one indicator pass per frame + scalar reads); the fused engine replaces this
        for in-universe polls, and the parity tests pin the two equal."""
        fetch = fetch or self._fetch
        with tracing.span("monitor.fetch", service="monitor",
                          attributes={"symbol": symbol,
                                      "interval": self.intervals[0]}):
            klines = fetch(symbol, self.intervals[0])
        if klines is None:
            return 0
        self._note_warmup(symbol, self.intervals[0], len(klines))
        with tracing.span("monitor.features", service="monitor",
                          attributes={"symbol": symbol}):
            update = self._features_from_klines(klines[-self.kline_limit:],
                                                with_combo_scores=True)
        if update is None:
            return 0
        combo_last = update.pop("_combo_last", None)
        if combo_last:
            update.update(self._family_view(combo_last))
            update.update(self._structure_view(combo_last))
        self.bus.set(f"historical_data_{symbol}_{self.intervals[0]}",
                     klines[-self.kline_limit:])
        # venue event time: newest candle open across every fetched frame
        # — the same monotone-max rule the fused engine's ingest applies
        # (note_event_ms), so the parity tests pin both paths' payloads
        ev_ms = float(klines[-1][0]) if klines else 0.0
        # The 0.6/0.4 trend blend pairs the primary frame with 5m
        # specifically (`market_monitor_service.py:273` strength_1m*0.6
        # + strength_5m*0.4); other frames contribute their per-interval
        # columns (rsi_3m, macd_5m, …, :285-298) without re-blending.
        blend_iv = self._blend_iv()
        for iv in self.intervals[1:]:
            res = fetch(symbol, iv)
            if not res:
                continue
            res = res[-self.kline_limit:]
            self.bus.set(f"historical_data_{symbol}_{iv}", res)
            self._note_warmup(symbol, iv, len(res))
            ev_ms = max(ev_ms, float(res[-1][0]))
            sec = self._features_from_klines(res)
            if sec is not None:
                if iv == blend_iv:
                    update["trend_strength"] = (
                        0.6 * update["trend_strength"]
                        + 0.4 * sec["trend_strength"])
                update[f"signal_{iv}"] = sec["signal"]
                update[f"rsi_{iv}"] = sec["rsi"]
                update[f"macd_{iv}"] = sec["macd"]
        update["symbol"] = symbol
        update["timestamp"] = now
        if ev_ms > 0.0:
            update["event_ms"] = ev_ms
        self.bus.set(f"market_data_{symbol}", update)
        await self.bus.publish("market_updates", update)
        self._last_pub[symbol] = now
        return 1
