"""Full-service assembly: the reference launcher's complete service roster.

`run_trader.py:1326-1494` starts ~14 services in daemon threads (monitor,
analyzer, executor, social, news, patterns, regime, NN, evolution, grid,
DCA, risk, registry, dashboard).  TradingSystem carries the live signal
path + risk/alerts/metrics natively; everything else is a cadence service
(`.name` / `async run_once()`).  This module provides the two adapters the
roster still lacked — a periodic evolver and a regime cadence — and
`build_full_stack`, which registers the whole roster on a TradingSystem
(used by the CLI's paper mode).

Port of `ai_crypto_trader_tpu/shell/stack.py`: the same roster in the same
order, the same cadence keys and defaults.  Every service is built on the
system's device (``system.device``): the social monitor's analytics and
snapshots, the pattern classifier (trained, loaded or drawn there from a
``torch.Generator`` seeded 0), the regime detectors, the prediction
service, the evolver's GA and the structure search.  The population seam is
the single-device partitioner: a ``"partitioner"`` cadence other than it
raises, as `parallel.partitioner.require_single` does.  A ``"stream"``
cadence attaches `shell.stream`'s market-data path through
`TradingSystem.attach_stream`; its drains run on the system's monitor, so
on its device too.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device


def _pattern_recognizer(seq_len: int, pat_kw: dict, device):
    """Resolve the stack's PatternRecognizer on ``device``, best source
    first:

      1. a saved checkpoint (``checkpoint`` kwarg, default
         models/pattern_<model_type>) — params trained by a previous run;
      2. train on the synthetic generators at startup (the reference's
         only data source) and persist the checkpoint for next time;
      3. random init, marked ``trained=False`` — ChartPatternService tags
         everything it publishes ``model_status: "untrained"`` so nothing
         downstream mistakes noise for a signal.

    Budget knobs ride the ``patterns`` cadence dict: ``checkpoint``
    (None disables persistence), ``train_on_start`` (False skips 2),
    ``train_kwargs`` (epochs/n_per_class/... for train_pattern_model).
    Training and initialisation draw from a ``torch.Generator`` seeded 0.
    A checkpoint the port cannot read (the JAX package's format, a damaged
    or mismatched one) falls through to 2 with a warning."""
    from ai_crypto_trader_tpu_torch.patterns.model import (
        PatternRecognizer, _build, train_pattern_model)
    from ai_crypto_trader_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    model_type = pat_kw.pop("model_type", "cnn")
    ckpt = pat_kw.pop("checkpoint", f"models/pattern_{model_type}")
    train_on_start = pat_kw.pop("train_on_start", True)
    train_kw = {"epochs": 4, "n_per_class": 16,
                **pat_kw.pop("train_kwargs", {})}

    if ckpt and os.path.isdir(ckpt):
        try:
            params, meta = load_checkpoint(ckpt, device=device)
            mt = meta.get("model_type", model_type)
            if meta.get("seq_len") not in (None, seq_len):
                raise ValueError("checkpoint seq_len mismatch")
            # a parameter set that no longer matches the current
            # architecture must fall through to retraining now, not crash
            # ChartPatternService at detect time
            want = {k: tuple(v.shape) for k, v in
                    _build(mt, device="cpu", seq_len=seq_len).named_parameters()}
            got = {k: tuple(v.shape) for k, v in params.items()}
            if got != want:
                raise ValueError(f"parameters {sorted(got)} do not fit the {mt} classifier")
            rec = PatternRecognizer(mt, params=params, trained=True)
            rec.logits(torch.zeros((1, seq_len, 5), device=device))
            return rec
        except Exception as e:                   # noqa: BLE001 — fall through
            logging.getLogger(__name__).warning(
                "pattern checkpoint %s unusable (%s: %s); falling back to "
                "startup training", ckpt, type(e).__name__, e)
    if train_on_start:
        rec = train_pattern_model(torch.Generator(device).manual_seed(0), model_type,
                                  T=seq_len, device=device, **train_kw)
        if ckpt:
            try:
                save_checkpoint(ckpt, rec.params,
                                metadata={"model_type": model_type,
                                          "seq_len": seq_len})
            except Exception as e:               # noqa: BLE001 — best-effort
                logging.getLogger(__name__).warning(
                    "could not persist pattern checkpoint %s (%s: %s)",
                    ckpt, type(e).__name__, e)
        return rec
    model = _build(model_type, torch.Generator().manual_seed(0), device=device,
                   seq_len=seq_len)
    return PatternRecognizer(model_type, params={k: v.detach() for k, v in
                                                 model.named_parameters()},
                             trained=False)


@dataclass
class EvolverService:
    """Periodic strategy evolution (the continuously-scheduled loop of
    `services/strategy_evolution_service.py:1571-1650`: monitor performance
    on a cadence, evolve when warranted, hot-swap the result).

    `StrategyEvolver.evolve` already performs dispatch → optimize → regime
    adjust → registry version → hot swap; this adapter feeds it live bus
    state: recent klines, the current regime, live params (seeded from the
    hot-swap surface so successive evolutions compound, as tensors on
    ``device``), and the executor's realized metrics when published."""

    bus: object
    evolver: object                    # strategy.evolution.StrategyEvolver
    symbol: str = "BTCUSDC"
    interval: str = "1m"
    interval_s: float = 3600.0
    min_candles: int = 128
    now_fn: object = time.time
    name: str = "evolver"
    history: list = field(default_factory=list)
    _last: float = -1e18
    device: Any = None                 # None: the CUDA card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _current_params(self):
        from ai_crypto_trader_tpu_torch.backtest.strategy import (
            StrategyParams, clamp_params, default_params)

        d = default_params(device=self.device)._asdict()
        live = self.bus.get("strategy_params") or {}
        d.update({k: torch.full((), float(v), dtype=torch.float32, device=self.device)
                  for k, v in live.items()
                  if k in d and isinstance(v, (int, float))})
        return clamp_params(StrategyParams(**d))

    async def run_once(self) -> dict:
        now = self.now_fn()
        if now - self._last < self.interval_s:
            return {"ran": False}
        rows = self.bus.get(f"historical_data_{self.symbol}_{self.interval}")
        # drop the venue's in-progress last bar (same rule as
        # GeneratorService._accumulate) — GA/RL fitness must not see a
        # phantom near-empty candle
        rows = (rows or [])[:-1]
        if len(rows) < self.min_candles:
            return {"ran": False, "reason": "insufficient_history"}
        self._last = now
        cols = np.asarray([r[1:6] for r in rows], np.float64)
        ohlcv = {"open": cols[:, 0], "high": cols[:, 1], "low": cols[:, 2],
                 "close": cols[:, 3], "volume": cols[:, 4]}
        regime = (self.bus.get(f"market_regime_{self.symbol}")
                  or self.bus.get("market_regime") or {}).get("regime",
                                                             "ranging")
        metrics = self.bus.get("strategy_metrics")
        out = await self.evolver.evolve(
            ohlcv, current=self._current_params(), metrics=metrics,
            regime=regime, history_length=len(self.history))
        self.history.append({"at": now, "evolved": out.get("evolved"),
                             "method": out.get("method"),
                             "version": out.get("version")})
        return {"ran": True, **{k: out[k] for k in ("evolved",)
                                if k in out}}


@dataclass
class RegimeCadence:
    """Drives MarketRegimeService.update per symbol on an interval (its
    reference runs a collector+detector loop,
    `services/market_regime_service.py` scheduled updates)."""

    svc: object                        # regime.service.MarketRegimeService
    symbols: list = field(default_factory=lambda: ["BTCUSDC"])
    interval_s: float = 300.0
    now_fn: object = time.time
    name: str = "regime"
    _last: dict = field(default_factory=dict)

    async def run_once(self) -> dict:
        now = self.now_fn()
        updated = 0
        for symbol in self.symbols:
            if now - self._last.get(symbol, -1e18) < self.interval_s:
                continue
            self._last[symbol] = now
            await self.svc.update(symbol)
            updated += 1
        return {"updated": updated}


def build_full_stack(system, *, registry=None, llm=None,
                     grid_symbol: str | None = None,
                     dca_symbol: str | None = None,
                     nn: bool = True, generator: bool = True,
                     evolver: bool = True,
                     cadences: dict | None = None) -> list:
    """Register the reference's full service roster on a TradingSystem,
    every service on ``system.device``.

    Returns the list of services added (also appended to
    ``system.extra_services``).  ``cadences`` overrides per-service kwargs
    by service name — a test shrinks training epochs and intervals through
    it; production uses the defaults.  A ``"monitor"`` entry is applied as
    attribute overrides on the system's already-constructed MarketMonitor
    (its dataclass fields only; anything else raises ``TypeError``).  A
    ``"stream"`` entry attaches the streamed market-data path: its keys
    are split between `MarketStream` and `StreamSupervisor` by field name,
    and a key of neither raises ``TypeError``.  A ``"partitioner"`` other
    than the single-device seam raises."""
    from ai_crypto_trader_tpu_torch.parallel.partitioner import require_single
    from ai_crypto_trader_tpu_torch.patterns.service import ChartPatternService
    from ai_crypto_trader_tpu_torch.regime.service import MarketRegimeService
    from ai_crypto_trader_tpu_torch.social.news import NewsService
    from ai_crypto_trader_tpu_torch.social.service import SocialMonitorService
    from ai_crypto_trader_tpu_torch.strategy.evolution import StrategyEvolver
    from ai_crypto_trader_tpu_torch.strategy.generator import GeneratorService

    cadences = cadences or {}
    dev = system.device

    def kw(name, **defaults):
        return {**defaults, **cadences.get(name, {})}

    monitor_fields = {f.name for f in dataclasses.fields(system.monitor)
                      if not f.name.startswith("_")}
    for k, v in cadences.get("monitor", {}).items():
        if k not in monitor_fields:    # fields only — never methods/privates
            raise TypeError(f"unknown monitor override {k!r}")
        setattr(system.monitor, k, v)

    # streaming ingest (shell/stream.py): a "stream" cadence entry attaches
    # the websocket-first market-data path — MarketStream kwargs and
    # StreamSupervisor kwargs share one dict, split by field name; the
    # degrade-to-poll ladder in the launcher keeps REST as the fallback.
    stream_kw = dict(cadences.get("stream") or {})
    if stream_kw.pop("enabled", bool(stream_kw)):
        from ai_crypto_trader_tpu_torch.shell.stream import (
            MarketStream, StreamSupervisor)

        ms_fields = {f.name for f in dataclasses.fields(MarketStream)
                     if not f.name.startswith("_") and f.name != "monitor"}
        sup_fields = {f.name for f in dataclasses.fields(StreamSupervisor)
                      if not f.name.startswith("_") and f.name != "stream"}
        clock = stream_kw.pop("now_fn", system.now_fn)
        ms_kw = {k: stream_kw.pop(k) for k in list(stream_kw)
                 if k in ms_fields and k not in sup_fields}
        unknown = set(stream_kw) - sup_fields
        if unknown:
            raise TypeError(f"unknown stream override(s) {sorted(unknown)!r}")
        stream = MarketStream(system.monitor, now_fn=clock, **ms_kw)
        system.attach_stream(StreamSupervisor(stream, now_fn=clock,
                                              **stream_kw))

    # the population seam of the evolver's GA and the generator's candidate
    # pools: one card
    partitioner = require_single(cadences.get("partitioner"))

    bus, symbols, now_fn = system.bus, system.symbols, system.now_fn
    services = [
        SocialMonitorService(bus, symbols, now_fn=now_fn,
                             **kw("social", device=dev)),
        NewsService(bus, symbols, now_fn=now_fn, **kw("news")),
    ]

    pat_kw = kw("patterns", device=dev)
    seq_len = pat_kw.pop("seq_len", 60)
    rec = _pattern_recognizer(seq_len, pat_kw, pat_kw["device"])
    services.append(ChartPatternService(bus, rec, symbols, seq_len=seq_len,
                                        now_fn=now_fn, **pat_kw))

    regime_kw = kw("regime", device=dev)
    cadence_keys = {k: regime_kw.pop(k) for k in ("interval_s",)
                    if k in regime_kw}
    services.append(RegimeCadence(
        MarketRegimeService(bus, now_fn=now_fn, **regime_kw),
        symbols, now_fn=now_fn, **cadence_keys))

    if nn:
        from ai_crypto_trader_tpu_torch.models.service import PredictionService

        # live quality gate + versioning: the system's scorecard judges
        # HPO winners against the incumbent's live outcomes, the registry
        # records every candidate (blocked ones as "shadow")
        services.append(PredictionService(
            bus, symbols, now_fn=now_fn,
            **kw("nn", scorecard=getattr(system, "scorecard", None),
                 registry=registry, device=dev)))
    if evolver:
        from ai_crypto_trader_tpu_torch.config import EvolutionParams

        ev_cfg = cadences.get("evolution_cfg") or EvolutionParams()
        services.append(EvolverService(
            bus, StrategyEvolver(bus, cfg=ev_cfg, registry=registry,
                                 now_fn=now_fn, partitioner=partitioner,
                                 device=dev),
            symbol=symbols[0], now_fn=now_fn, **kw("evolver", device=dev)))
    if generator:
        services.append(GeneratorService(bus, symbols[0], registry=registry,
                                         llm=llm, now_fn=now_fn,
                                         partitioner=partitioner,
                                         **kw("generator", device=dev)))
    if grid_symbol:
        from ai_crypto_trader_tpu_torch.strategy.grid_live import GridTraderService

        services.append(GridTraderService(system.exchange, grid_symbol,
                                          bus=bus, **kw("grid")))
    if dca_symbol:
        from ai_crypto_trader_tpu_torch.strategy.dca import DCAStrategy
        from ai_crypto_trader_tpu_torch.strategy.grid_live import DCAService

        dca_kw = kw("dca")
        strat_kw = {k: dca_kw.pop(k) for k in
                    ("base_amount", "interval_s", "schedule") if k in dca_kw}
        services.append(DCAService(
            system.exchange, DCAStrategy(symbol=dca_symbol, **strat_kw),
            bus=bus, now_fn=now_fn, **dca_kw))

    system.extra_services.extend(services)
    # register every service's heartbeat up front: one that crashes before
    # its FIRST beat must still appear (unhealthy) in service_health, or
    # ServiceDown can never fire for it (utils/health.py expect())
    for svc in services:
        system.heartbeats.expect(getattr(svc, "name", type(svc).__name__))
    return services
