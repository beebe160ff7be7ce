"""The port's backtest queue (backtest/queue.py) against the JAX package's,
on the CPU.

The same jobs (four symbols' series at T = 1024, default and sampled
parameters, a keyword override, a named job) through both queues, each on
its own package's `EventBus`, with one injected clock shared by queue and
bus: equal task ids and order, `pending` before and after, the
`max_tasks` cut, the number run a drain, the bus envelopes (channel,
time, record) and the queue latencies.  Metrics are held at the tolerance
of the port's `evolvable_backtest` parity tests (tests/test_torch_evolvable.py:
counts exact, floats at rtol 1e-5, atol 1e-6).
"""

import asyncio

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ai_crypto_trader_tpu.backtest import queue as jq  # noqa: E402
from ai_crypto_trader_tpu.backtest import sample_params  # noqa: E402
from ai_crypto_trader_tpu.shell import bus as jbus  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.backtest import queue as tq  # noqa: E402
from ai_crypto_trader_tpu_torch.data import generate_ohlcv  # noqa: E402
from ai_crypto_trader_tpu_torch.shell import bus as tbus  # noqa: E402

T = 1024
COUNTS = {"total_trades", "winning_trades", "losing_trades", "max_win_streak",
          "max_loss_streak"}


class Clock:
    """A clock that moves 0.25 s at every read."""

    def __init__(self):
        self.t = 1_000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _series(seed):
    return {k: v for k, v in generate_ohlcv(n=T, seed=seed).items() if k != "regime"}


@pytest.fixture(scope="module")
def jobs():
    pop = sample_params(jax.random.PRNGKey(3), 2)
    one = [jax.tree.map(lambda x, i=i: x[i], pop) for i in range(2)]
    return [(_series(3), None, {}), (_series(5), one[0], {"name": "eth_sampled"}),
            (_series(7), one[1], {"initial_balance": 5_000.0}),
            (_series(9), None, {})]


def _drive(qmod, busmod, jobs, to_params, **queue_kw):
    clock = Clock()
    bus = busmod.EventBus(now_fn=clock)
    sub = bus.subscribe("backtest_results")
    q = qmod.BacktestQueue(bus=bus, now_fn=clock, **queue_kw)
    ids = [q.add_backtest_task(d, None if p is None else to_params(p), **kw)
           for d, p, kw in jobs]
    pending = [q.pending]
    ran = [asyncio.run(q.process_task_queue(max_tasks=2))]
    pending.append(q.pending)
    ran += [asyncio.run(q.process_task_queue()), asyncio.run(q.process_task_queue())]
    pending.append(q.pending)
    envelopes = []
    while not sub.empty():
        envelopes.append(sub.get_nowait())
    return {"ids": ids, "pending": pending, "ran": ran, "results": q.results,
            "envelopes": envelopes, "missing": q.get_result("nope")}


def _same_record(got, ref):
    assert got.keys() == ref.keys()
    for k in ("id", "completed_at", "queue_latency_s"):
        assert got[k] == ref[k], k
    assert list(got["metrics"]) == list(ref["metrics"])
    for k, r in ref["metrics"].items():
        g = got["metrics"][k]
        assert isinstance(g, float), k
        if k in COUNTS:
            assert g == r, k
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=k)


def test_queue_follows_jax(jobs):
    ref = _drive(jq, jbus, jobs, lambda p: p)
    got = _drive(tq, tbus, jobs, lambda p: convert.params_from_numpy(p, device="cpu"),
                 device="cpu")
    assert got["ids"] == ref["ids"] == ["bt_1", "eth_sampled", "bt_3", "bt_4"]
    assert got["pending"] == ref["pending"] == [4, 2, 0]
    assert got["ran"] == ref["ran"] == [2, 2, 0]
    assert got["missing"] is ref["missing"] is None
    assert list(got["results"]) == list(ref["results"]) == ref["ids"]
    for i in ref["ids"]:
        _same_record(got["results"][i], ref["results"][i])
    assert len(got["envelopes"]) == len(ref["envelopes"]) == 4
    for g, r in zip(got["envelopes"], ref["envelopes"]):
        assert (g["channel"], g["ts"]) == (r["channel"], r["ts"]) == ("backtest_results", r["ts"])
        assert g.keys() == r.keys()
        _same_record(g["data"], r["data"])
    trades = [r["metrics"]["total_trades"] for r in got["results"].values()]
    assert sum(trades) > 0
    assert got["results"]["bt_3"]["metrics"]["initial_balance"] == 5_000.0


def test_queue_without_a_bus_and_one_read_a_job(monkeypatch, jobs):
    """No bus: the records land in the store alone.  A job's metrics come
    back in one host read (one `.cpu()` of one vector)."""
    import torch

    reads = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real(self, *a, **kw)

    q = tq.BacktestQueue(now_fn=Clock(), device="cpu")
    q.add_backtest_task(jobs[0][0])
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    assert asyncio.run(q.process_task_queue()) == 1
    monkeypatch.setattr(torch.Tensor, "cpu", real)
    assert reads == [(22,)]
    assert q.get_result("bt_1")["queue_latency_s"] == 0.5
