"""Queued backtest execution.

The port's own copy of `ai_crypto_trader_tpu/backtest/queue.py:20-67`
(BacktestEngine's asyncio task queue, `backtesting/backtest_engine.py:
217-304`: `add_backtest_task` / `process_task_queue`): callers enqueue
named backtest jobs, a worker drains them, results land in a store and on
the bus.  Jobs run `evolvable_backtest` and `compute_metrics` on the
queue's device (on the card: the indicator tables' fused-EWMA launches and
one replay-kernel launch a job), so "queueing" is for orchestration (many
symbols/param sets arriving over time), not for parallelism.  One host
read a job: its metrics, in one vector.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import torch

from ai_crypto_trader_tpu_torch.device import resolve_device


@dataclass
class BacktestQueue:
    bus: object | None = None
    now_fn: any = time.time
    results: dict = field(default_factory=dict)
    _queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    _counter: int = 0
    device: any = None

    def add_backtest_task(self, ohlcv: dict, params=None, *,
                          name: str | None = None, **kw) -> str:
        """Enqueue; returns the task id (`add_backtest_task:217`)."""
        self._counter += 1
        task_id = name or f"bt_{self._counter}"
        self._queue.put_nowait(
            {"id": task_id, "ohlcv": ohlcv, "params": params, "kw": kw,
             "enqueued_at": self.now_fn()})
        return task_id

    async def process_task_queue(self, max_tasks: int | None = None) -> int:
        """Drain the queue (`process_task_queue:268-304`); returns #run."""
        from ai_crypto_trader_tpu_torch.backtest.evolvable import evolvable_backtest
        from ai_crypto_trader_tpu_torch.backtest.metrics import compute_metrics
        from ai_crypto_trader_tpu_torch.backtest.strategy import default_params

        dev = resolve_device(self.device)
        n = 0
        while not self._queue.empty():
            if max_tasks is not None and n >= max_tasks:
                break
            task = self._queue.get_nowait()
            params = task["params"] if task["params"] is not None \
                else default_params(device=dev)
            stats = evolvable_backtest(task["ohlcv"], params, device=dev, **task["kw"])
            m = compute_metrics(stats, device=dev)
            # the job's one host read: every metric in one float64 vector
            # (float32 and int32 values are exact in float64)
            values = torch.stack([v.reshape(()).to(torch.float64)
                                  for v in m.values()]).cpu().tolist()
            metrics = dict(zip(m, values))
            record = {"id": task["id"], "metrics": metrics,
                      "completed_at": self.now_fn(),
                      "queue_latency_s": self.now_fn() - task["enqueued_at"]}
            self.results[task["id"]] = record
            if self.bus is not None:
                await self.bus.publish("backtest_results", record)
            n += 1
        return n

    def get_result(self, task_id: str) -> dict | None:
        return self.results.get(task_id)

    @property
    def pending(self) -> int:
        return self._queue.qsize()
