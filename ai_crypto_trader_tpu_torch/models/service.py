"""NN prediction-service cadence — the loop that drives the model zoo.

Re-expression of `services/neural_network_service.py:1314-1480`
(`prediction_loop`): per (symbol × interval),

  * re-predict only when the stored prediction is older than HALF the
    interval (staleness gate, :1366-1387),
  * periodic retrain every ``retrain_interval_s`` (24 h default —
    ``model_checkpoint_interval``, :1406-1443),
  * on-request hyperparameter optimization via the bus key
    ``nn_optimization_request`` (:1327-1349), recording
    ``nn_last_optimization_{symbol}_{interval}``,
  * regime-tagged model snapshots when a market regime is known
    (:1445-1474), through the framework's single checkpoint story
    (utils/checkpoint.py) instead of scattered .h5 copies.

All wall-clock reads go through ``now_fn`` so tests drive the cadence with
a virtual clock.  Training (`train_model`, one host read an epoch) and
prediction (one `predict_prices_batched` call per architecture group, one
host read) run on ``device`` (None: the CUDA card); this service is
host-side orchestration.

Port of `ai_crypto_trader_tpu/models/service.py`.  Draws come from
``generator`` (a ``torch.Generator`` on the device, seeded 0 by default;
each training continues its stream) where the JAX service splits a key.
The bus is injected and used only through ``get``, ``set`` and ``await
publish`` (the port's `shell.EventBus`, or anything with those three).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device
from ai_crypto_trader_tpu_torch.models.train import (
    TrainResult,
    predict_prices,
    predict_prices_batched,
    train_model,
)
from ai_crypto_trader_tpu_torch.utils import meshprof, tracing
from ai_crypto_trader_tpu_torch.utils.checkpoint import save_checkpoint

INTERVAL_SECONDS = {
    "1m": 60, "3m": 180, "5m": 300, "15m": 900, "30m": 1800,
    "1h": 3600, "2h": 7200, "4h": 14400, "12h": 43200, "1d": 86400,
    "3d": 259200, "1w": 604800,
}


def _features_from_klines(klines: list) -> np.ndarray | None:
    """Bus kline rows → [T, 5] OHLCV feature matrix (close is column 3,
    the prediction target column used throughout models/train.py)."""
    if not klines:
        return None
    arr = np.asarray([row[1:6] for row in klines], np.float32)
    return arr if arr.shape[0] > 0 else None


@dataclass
class PredictionService:
    """Launcher-attachable service; ``run_once`` advances the cadence."""

    bus: Any
    symbols: list[str]
    intervals: tuple = ("1m", "5m")
    now_fn: Any = None
    model_type: str = "lstm"
    seq_len: int = 60
    epochs: int = 20
    units: int = 32
    retrain_interval_s: float = 86_400.0     # model_checkpoint_interval
    hpo_trials: int = 4
    precision: str | None = None             # f32 (default) | bf16 matmuls
    checkpoint_dir: str | None = None
    generator: Any = None                    # torch.Generator on the device (seeded 0 if None)
    device: Any = None                       # None: the CUDA card
    name: str = "nn"
    # Live quality gate (obs/scorecard.py): when attached, an HPO winner
    # of a DIFFERENT architecture must not have a known-worse live score
    # than the incumbent it would replace — the registry/hot-swap quality
    # gate.  `registry` (strategy/registry.py ModelRegistry) versions each
    # HPO winner; blocked candidates are registered as "shadow".
    scorecard: Any = None
    registry: Any = None

    # When True, the synchronous work (training / HPO / inference) runs
    # in a worker thread via asyncio.to_thread so a 24 h-retrain tick cannot
    # stall the trading event loop; bus reads/writes stay on the loop either
    # way. Default False keeps tests single-threaded and deterministic.
    offload: bool = False

    # All due (symbol × interval) pairs sharing a model architecture predict
    # as ONE stacked vmapped program (train.predict_prices_batched) instead
    # of a Python loop of per-pair dispatches — the serving-side twin of the
    # monitor's fused tick engine. False restores per-pair dispatches.
    batched_predict: bool = True

    models: dict = field(default_factory=dict)       # (sym, iv) -> TrainResult
    train_count: int = 0
    predict_count: int = 0
    _last_training: dict = field(default_factory=dict)   # (sym, iv) -> time

    def __post_init__(self):
        if self.now_fn is None:
            import time

            self.now_fn = time.time
        self.device = resolve_device(self.device)
        if self.generator is None:
            self.generator = torch.Generator(device=self.device).manual_seed(0)

    # -- data ----------------------------------------------------------------
    def _features(self, symbol: str, interval: str) -> np.ndarray | None:
        feats = _features_from_klines(
            self.bus.get(f"historical_data_{symbol}_{interval}") or [])
        if feats is None or feats.shape[0] < self.seq_len + 8:
            return None
        return feats

    # -- tracing -------------------------------------------------------------
    def _traced_jax(self, name: str, attrs: dict, fn):
        """Span + kernel-build-vs-execute breakdown around one dispatch
        (`utils.tracing.traced_dispatch`); a plain ``fn()`` when tracing is
        off."""
        return tracing.traced_dispatch(name, fn, service=self.name,
                                       attrs_fn=lambda: attrs, device=self.device)

    # -- training ------------------------------------------------------------
    def _train_one(self, symbol: str, interval: str) -> TrainResult | None:
        feats = self._features(symbol, interval)
        if feats is None:
            return None
        result = self._traced_jax(
            "model.train",
            {"symbol": symbol, "interval": interval,
             "model_type": self.model_type},
            lambda: train_model(self.generator, feats, self.model_type,
                                seq_len=self.seq_len, epochs=self.epochs,
                                units=self.units, target_col=3,
                                precision=self.precision, device=self.device))
        self.models[(symbol, interval)] = result
        self.train_count += 1
        self._snapshot(symbol, interval, result)
        return result

    def _snapshot(self, symbol: str, interval: str, result: TrainResult):
        """Regime-tagged checkpoint (`neural_network_service.py:1445-1474`):
        one atomic pytree per (model, interval, regime)."""
        if self.checkpoint_dir is None:
            return
        regime = (self.bus.get("market_regime") or {}).get("regime")
        tag = f"_{regime}" if regime else ""
        path = os.path.join(
            self.checkpoint_dir,
            f"nn_{self.model_type}_{symbol}_{interval}{tag}.ckpt")
        save_checkpoint(path, result.params, metadata={
            "symbol": symbol, "interval": interval,
            "model_type": self.model_type, "regime": regime or "unknown",
            "best_val_loss": float(result.best_val_loss),
            "trained_at": self.now_fn()})

    # -- cadence ---------------------------------------------------------------
    def _needs_prediction(self, symbol: str, interval: str, now: float) -> bool:
        prev = self.bus.get(f"nn_prediction_{symbol}_{interval}")
        if not prev:
            return True
        half = INTERVAL_SECONDS.get(interval, 3600) / 2.0
        return (now - prev.get("reference_time", -1e18)) >= half

    def _run_hpo(self, symbol: str, interval: str, feats, now: float):
        """HPO + scorecard-gated adoption of the winner; returns the
        optimization record (including the adoption verdict)."""
        from ai_crypto_trader_tpu_torch.models.hpo import optimize_hyperparameters

        # candidates must be RANKED on the same target the final model
        # trains on (close, col 3) — ranking on open while deploying close
        # selects hyperparameters for a different objective
        hpo = self._traced_jax(
            "model.hpo", {"symbol": symbol, "interval": interval,
                          "n_trials": self.hpo_trials},
            lambda: optimize_hyperparameters(
                self.generator, feats, n_trials=self.hpo_trials,
                rung_epochs=(2, max(2, self.epochs // 2)),
                seq_len=self.seq_len, target_col=3,
                precision=self.precision, device=self.device))
        best = hpo["best_params"]
        # live quality gate: the candidate architecture must not be
        # measurably WORSE live than the incumbent it would replace —
        # val loss on the training window says nothing about whether the
        # incumbent's real predictions were coming true (obs/scorecard.py)
        incumbent = self.models.get((symbol, interval))
        adoption, gate_reason = "adopted", None
        if self.scorecard is not None and incumbent is not None:
            allowed, gate_reason = self.scorecard.adoption_gate(
                best["model_type"], incumbent.model_type, symbol, interval)
            if not allowed:
                adoption = "blocked_by_scorecard"
        version = None
        if self.registry is not None:
            version = self.registry.register(
                "nn_model", dict(best),
                metadata={"symbol": symbol, "interval": interval})
            self.registry.update_performance(
                version, {"val_loss": float(hpo["best_val_loss"])})
            self.registry.set_status(
                version, "active" if adoption == "adopted" else "shadow")
        if adoption == "adopted":
            result = train_model(
                self.generator, feats, best["model_type"], seq_len=self.seq_len,
                units=best["units"], dropout=best["dropout"],
                learning_rate=best["learning_rate"],
                batch_size=best["batch_size"], epochs=self.epochs,
                target_col=3, precision=self.precision, device=self.device)
            self.models[(symbol, interval)] = result
            self.train_count += 1
            self._snapshot(symbol, interval, result)
        return {"at": now, "best": best,
                "val_loss": float(hpo["best_val_loss"]),
                "adoption": adoption, "adoption_reason": gate_reason,
                "version": version}

    def _compute(self, now: float, hpo_req: dict | None) -> dict:
        """ALL synchronous device work for one cadence step. Bus access is
        limited to plain key reads (GIL-safe dict lookups); async bus
        operations (publish, request clearing) stay on the event loop in
        run_once, so this can run in a worker thread (see ``offload``)."""
        out = {"predicted": 0, "trained": 0, "hpo": 0,
               "kv": [], "events": [], "hpo_consumed": False}

        if hpo_req and "symbol" in hpo_req and "interval" in hpo_req:
            symbol, interval = hpo_req["symbol"], hpo_req["interval"]
            feats = self._features(symbol, interval)
            if feats is None:
                # data not there yet: leave the request pending for retry
                # rather than dropping it silently
                pass
            else:
                rec = self._run_hpo(symbol, interval, feats, now)
                # this cycle IS the pair's training — adopted or blocked.
                # Without the refresh, a blocked adoption would leave the
                # cadence stale and the retrain loop below could clobber
                # the very incumbent the gate just protected, the same
                # tick, with a default-config model.
                self._last_training[(symbol, interval)] = now
                out["kv"].append(
                    (f"nn_last_optimization_{symbol}_{interval}", rec))
                out["hpo"] = 1
                out["hpo_consumed"] = True
        elif hpo_req:
            out["hpo_consumed"] = True       # malformed: drop it

        # periodic retrain, per (symbol × interval) so one pair's missing
        # data can't starve another's 24 h cadence (:1406-1443)
        for symbol in self.symbols:
            for interval in self.intervals:
                last = self._last_training.get((symbol, interval))
                if last is not None and now - last < self.retrain_interval_s:
                    continue
                # the regular retrain trains the service's DEFAULT
                # architecture — when that would REPLACE a different-arch
                # incumbent (an adopted HPO winner), it is an architecture
                # swap and must pass the same live quality gate as an HPO
                # candidate; blocked = the incumbent keeps serving and is
                # re-vetted next cadence
                incumbent = self.models.get((symbol, interval))
                if (self.scorecard is not None and incumbent is not None
                        and incumbent.model_type != self.model_type
                        and not self.scorecard.adoption_gate(
                            self.model_type, incumbent.model_type,
                            symbol, interval)[0]):
                    self._last_training[(symbol, interval)] = now
                    continue
                if self._train_one(symbol, interval) is not None:
                    self._last_training[(symbol, interval)] = now
                    out["trained"] += 1

        # staleness-gated predictions (:1366-1401); pairs sharing a model
        # architecture run as one stacked predict dispatch (_predict_jobs)
        jobs = []
        for symbol in self.symbols:
            for interval in self.intervals:
                if not self._needs_prediction(symbol, interval, now):
                    continue
                result = self.models.get((symbol, interval))
                if result is None:
                    continue
                feats = self._features(symbol, interval)
                if feats is None:
                    continue
                jobs.append((symbol, interval, result, feats))
        for (symbol, interval, result, feats), pred in zip(
                jobs, self._predict_jobs(jobs)):
            rows = self.bus.get(f"historical_data_{symbol}_{interval}") or []
            payload = {
                "symbol": symbol, "interval": interval,
                "predicted_price": float(np.ravel(pred["predicted_price"])[0]),
                "confidence": pred["confidence"],
                "reference_time": now,
                # explicit outcome-resolution provenance (obs/scorecard.py):
                # the snapshot used to keep only the value, which made
                # "did this prediction come true?" unanswerable — the
                # kline timestamp anchors resolution clock-independently
                "predicted_at": now,
                "horizon_s": float(INTERVAL_SECONDS.get(interval, 3600)),
                "reference_ts": float(rows[-1][0]) if rows else None,
                "reference_price": float(feats[-1, 3]),
                "model_type": result.model_type,
            }
            out["kv"].append((f"nn_prediction_{symbol}_{interval}", payload))
            out["events"].append({"type": "prediction", **payload})
            self.predict_count += 1
            out["predicted"] += 1
        return out

    def _predict_jobs(self, jobs: list) -> list:
        """Predictions for the due (symbol, interval, result, feats) jobs,
        in job order.  Architecture groups of ≥2 run as ONE stacked
        program; singletons go through `predict_prices`.  The
        denormalization column comes from each TrainResult (the close
        column the service trains on)."""
        preds: list = [None] * len(jobs)
        groups: dict = {}
        for i, (_, _, result, _) in enumerate(jobs):
            key = (result.model_type,
                   tuple(sorted(result.model_kwargs.items())))
            groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            if len(idxs) == 1 or not self.batched_predict:
                for i in idxs:
                    symbol, interval, result, feats = jobs[i]
                    preds[i] = self._traced_jax(
                        "model.predict",
                        {"symbol": symbol, "interval": interval,
                         "model_type": result.model_type},
                        lambda result=result, feats=feats: predict_prices(
                            result, feats, seq_len=self.seq_len, device=self.device))
            else:
                rs = [jobs[i][2] for i in idxs]
                fs = [jobs[i][3] for i in idxs]
                outs = self._traced_jax(
                    "model.predict_batch",
                    {"model_type": key[0], "lanes": len(idxs)},
                    lambda rs=rs, fs=fs: predict_prices_batched(
                        rs, fs, seq_len=self.seq_len, device=self.device))
                for i, o in zip(idxs, outs):
                    preds[i] = o
        return preds

    def _compute_offloaded(self, now: float, hpo_req: dict | None) -> dict:
        """`_compute` on a worker thread, beside the loop's device work:
        under `utils.meshprof.sync_gate`, so no sync-guard window arms
        while it runs and its own reads never trip one."""
        with meshprof.sync_gate():
            return self._compute(now, hpo_req)

    async def run_once(self) -> dict:
        now = self.now_fn()
        hpo_req = self.bus.get("nn_optimization_request")
        if self.offload:
            import asyncio

            computed = await asyncio.to_thread(self._compute_offloaded, now, hpo_req)
        else:
            computed = self._compute(now, hpo_req)
        if computed.pop("hpo_consumed"):
            # compare-and-clear: a NEW request posted while the offloaded
            # compute ran must survive for the next cycle, not be dropped
            if self.bus.get("nn_optimization_request") == hpo_req:
                self.bus.set("nn_optimization_request", None)
        for key, value in computed.pop("kv"):
            self.bus.set(key, value)
        for event in computed.pop("events"):
            await self.bus.publish("neural_network_predictions", event)
        return computed
