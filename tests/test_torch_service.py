"""The port's PredictionService cadence on a virtual clock, and `cli train`,
on the CPU.

The cases of tests/test_prediction_service.py, run on the port's service
with the JAX package's `EventBus` injected (the port's service uses a bus
only through get, set and publish): first tick, the staleness gate, the
24 h retrain, snapshots with and without a regime, HPO adopted and
deferred, no starvation, offload mode, no data.
"""

import asyncio
import glob
import json
import os

import numpy as np
import pytest
import torch

from ai_crypto_trader_tpu.shell.bus import EventBus
from ai_crypto_trader_tpu_torch.models.service import PredictionService
from ai_crypto_trader_tpu_torch.utils.checkpoint import load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (torch's idle threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t0=1_000_000.0):
        self.t = t0

    def __call__(self):
        return self.t


def make_klines(n=160, seed=0):
    rng = np.random.default_rng(seed)
    close = 100.0 * np.cumprod(1 + rng.normal(0, 0.003, n))
    return [[i * 60_000, c * 0.999, c * 1.002, c * 0.997, c, 1000.0 + rng.uniform(0, 10)]
            for i, c in enumerate(close)]


def _service(bus, clock, **kw):
    kw = {"intervals": ("1m",), "seq_len": 24, "epochs": 2, "units": 8, "hpo_trials": 2,
          "device": "cpu", **kw}
    return PredictionService(bus, ["BTCUSDC"], now_fn=clock, **kw)


@pytest.fixture()
def svc(tmp_path):
    bus = EventBus()
    bus.set("historical_data_BTCUSDC_1m", make_klines())
    clock = Clock()
    svc = _service(bus, clock, checkpoint_dir=str(tmp_path))
    svc.clock = clock
    return svc


def test_first_tick_trains_and_predicts(svc):
    out = asyncio.run(svc.run_once())
    assert out["trained"] == 1 and out["predicted"] == 1
    pred = svc.bus.get("nn_prediction_BTCUSDC_1m")
    assert pred["reference_time"] == svc.clock.t
    assert np.isfinite(pred["predicted_price"])
    assert 0.0 < pred["confidence"] <= 1.0
    assert pred["model_type"] == "lstm" and pred["reference_price"] == pytest.approx(
        make_klines()[-1][4], rel=1e-6)
    assert svc.bus.published_counts.get("neural_network_predictions") == 1
    assert svc.models[("BTCUSDC", "1m")].params["Dense_1.bias"].device.type == "cpu"


def test_staleness_gate_half_interval(svc):
    asyncio.run(svc.run_once())
    svc.clock.t += 29          # < 30 s = half of 1m: too fresh
    assert asyncio.run(svc.run_once())["predicted"] == 0
    svc.clock.t += 2           # past the half-interval boundary
    assert asyncio.run(svc.run_once())["predicted"] == 1


def test_retrain_fires_every_24h(svc):
    asyncio.run(svc.run_once())
    assert svc.train_count == 1
    svc.clock.t += 86_399
    asyncio.run(svc.run_once())
    assert svc.train_count == 1      # not yet
    svc.clock.t += 2
    asyncio.run(svc.run_once())
    assert svc.train_count == 2      # 24 h elapsed → retrain


def test_regime_tagged_snapshot(svc, tmp_path):
    svc.bus.set("market_regime", {"regime": "bull"})
    asyncio.run(svc.run_once())
    (snap,) = glob.glob(os.path.join(str(tmp_path), "*_bull.ckpt"))
    params, meta = load_checkpoint(snap, device="cpu")
    assert meta["regime"] == "bull" and meta["model_type"] == "lstm"
    result = svc.models[("BTCUSDC", "1m")]
    assert all(torch.equal(params[k], result.params[k]) for k in result.params)


def test_untagged_snapshot_without_regime(svc, tmp_path):
    asyncio.run(svc.run_once())
    assert any(s.endswith("_1m.ckpt") for s in os.listdir(str(tmp_path)))


def test_hpo_request_adopts_winner(svc):
    asyncio.run(svc.run_once())
    svc.bus.set("nn_optimization_request", {"symbol": "BTCUSDC", "interval": "1m"})
    svc.clock.t += 40
    out = asyncio.run(svc.run_once())
    assert out["hpo"] == 1
    rec = svc.bus.get("nn_last_optimization_BTCUSDC_1m")
    assert rec["at"] == svc.clock.t and rec["adoption"] == "adopted"
    assert svc.models[("BTCUSDC", "1m")].model_type == rec["best"]["model_type"]
    assert svc.bus.get("nn_optimization_request") is None


def test_per_pair_retrain_no_starvation(svc):
    # ETH has no data on the tick BTC trains; when its data arrives on the
    # next tick it must train at once, not wait out the 24 h cadence
    svc.symbols = ["BTCUSDC", "ETHUSDC"]
    assert asyncio.run(svc.run_once())["trained"] == 1          # only BTC has data
    svc.clock.t += 60
    svc.bus.set("historical_data_ETHUSDC_1m", make_klines(seed=1))
    assert asyncio.run(svc.run_once())["trained"] == 1          # ETH trains now
    assert ("ETHUSDC", "1m") in svc.models


def test_hpo_request_deferred_until_data(svc):
    asyncio.run(svc.run_once())
    svc.bus.set("nn_optimization_request", {"symbol": "NODATAUSDC", "interval": "1m"})
    assert asyncio.run(svc.run_once())["hpo"] == 0
    # left pending for retry, not dropped
    assert svc.bus.get("nn_optimization_request") is not None
    svc.bus.set("historical_data_NODATAUSDC_1m", make_klines(seed=2))
    svc.symbols = ["BTCUSDC", "NODATAUSDC"]
    svc.clock.t += 60
    assert asyncio.run(svc.run_once())["hpo"] == 1
    assert svc.bus.get("nn_optimization_request") is None


def test_offload_mode_same_results():
    runs = []
    for offload in (False, True):
        bus = EventBus()
        bus.set("historical_data_BTCUSDC_1m", make_klines())
        svc = _service(bus, Clock(), offload=offload)
        out = asyncio.run(svc.run_once())
        assert out["trained"] == 1 and out["predicted"] == 1
        runs.append(bus.get("nn_prediction_BTCUSDC_1m")["predicted_price"])
    assert runs[0] == runs[1]             # the same seeded generator, the same model


def test_no_data_no_crash():
    svc = PredictionService(EventBus(), ["ETHUSDC"], intervals=("1m",), now_fn=Clock(),
                            seq_len=24, epochs=2, device="cpu")
    out = asyncio.run(svc.run_once())
    assert (out["predicted"], out["trained"], out["hpo"]) == (0, 0, 0)


def test_two_pairs_predict_as_one_batched_group(monkeypatch):
    """Pairs of one architecture predict through one batched call (one
    host read for the group)."""
    from ai_crypto_trader_tpu_torch.models import train

    bus = EventBus()
    for seed, iv in enumerate(("1m", "5m")):
        bus.set(f"historical_data_BTCUSDC_{iv}", make_klines(seed=seed))
    svc = _service(bus, Clock(), intervals=("1m", "5m"))
    reads = []
    real = train.host_read
    monkeypatch.setattr(train, "host_read", lambda rb: reads.append(1) or real(rb))
    out = asyncio.run(svc.run_once())
    assert out["trained"] == 2 and out["predicted"] == 2 and len(reads) == 1


def test_cli_train_on_the_cpu(tmp_path, monkeypatch, capsys):
    from ai_crypto_trader_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    cli.main(["train", "--days", "1", "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert summary["model"] == "lstm" and summary["epochs_run"] == 1
    assert np.isfinite(summary["best_val_loss"]) and np.isfinite(summary["predicted_price"])
    assert 0.0 < summary["confidence"] <= 1.0
    assert "epoch 0: loss=" in out
