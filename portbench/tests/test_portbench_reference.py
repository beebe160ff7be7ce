"""The yardstick on the CPU: the frozen generator, the roofline counts, the
trace reading, and the plain reference against the port at a tiny size."""

import numpy as np
import pytest
import torch

from portbench import trace
from portbench.metrics import _roofline
from portbench.reference import indicators as ref_ind
from portbench.reference import judge
from portbench.reference import metrics as ref_metrics
from portbench.reference import replay as ref_replay
from portbench.reference import signals as ref_sig
from portbench.reference.numerics import BF16, round_bf16
from portbench.traffic.ohlcv import generate_ohlcv

T = 3000


@pytest.fixture(scope="module")
def port_run():
    from ai_crypto_trader_tpu_torch.backtest import (compute_metrics, prepare_inputs,
                                                     sample_params, sweep)
    from ai_crypto_trader_tpu_torch.ops import compute_indicators

    raw = generate_ohlcv(T, 11, base_drift=5e-7, base_vol=0.0006)
    ind = compute_indicators(raw, device="cpu")
    inp = prepare_inputs(ind, device="cpu")
    gen = torch.Generator().manual_seed(7)
    params = sample_params(gen, 12, device="cpu")
    stats = sweep(inp, params, device="cpu")
    return raw, ind, inp, params, stats, compute_metrics(stats, device="cpu")


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 77])
def test_the_frozen_generator_gives_the_programs_candles(seed):
    from ai_crypto_trader_tpu_torch.data.synthetic import generate_ohlcv as program

    ours, theirs = generate_ohlcv(2000, seed), program(n=2000, seed=seed)
    for k in ("open", "high", "low", "close", "volume"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_roofline_counts_are_fixed_numbers_of_the_shapes():
    assert _roofline.replay_work(43_200, 4096) == (4096 * 43_190, (9 * 43_200 + 16 * 4096) * 4)
    seconds, bound = _roofline.least_time(*_roofline.replay_work(43_200, 1))
    assert bound == "bytes" and seconds == pytest.approx((9 * 43_200 + 16) * 4 / 3.35e12)
    seconds, bound = _roofline.least_time(*_roofline.replay_work(43_200, 16_384))
    assert bound == "operations" and seconds == pytest.approx(16_384 * 43_190 / 67e12)
    assert _roofline.share_pct(1e-3, [2.0, 2.0]) == pytest.approx(50.0)
    assert _roofline.share_pct(1e-3, []) is None


def test_the_trace_reading_counts_busy_time_and_names_the_gaps():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.replay", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.read", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 120, "dur": 10},
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(50e-6) and s["window_s"] == pytest.approx(150e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(50e-6)]
    assert dict((k, v) for k, v in s["idle_gaps"]) == {
        "portbench.replay": pytest.approx(60e-6), "portbench.read": pytest.approx(40e-6)}


def test_bf16_rounds_after_every_operation():
    assert round_bf16(np.float32(1.0 + 2**-9)) == np.float32(1.0)
    assert round_bf16(np.float32(1.0 + 3 * 2**-9)) == np.float32(1.0 + 2**-7)
    x = BF16(np.array([256.0, 1.0], np.float32))
    assert float((x + 1.0)[0]) == 256.0 and isinstance(np.where(x > 2, x, 0.0), BF16)


def _gap(p, r):
    """The largest gap over the reference column's largest magnitude."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    return float(np.max(np.abs(p - r))) / max(float(np.max(np.abs(r))), 1e-30)


def test_the_reference_table_agrees_with_the_port(port_run):
    raw, ind = port_run[0], port_run[1]
    ref = ref_ind.indicator_table(*(raw[k].astype(np.float64) for k in ("high", "low", "close", "volume")))
    assert set(ref) == set(ref_ind.NAMES) and all(np.isfinite(v).all() for v in ref.values())
    gaps = {k: _gap(ind[k].numpy(), ref[k]) for k in ref_ind.NAMES}
    assert max(v for k, v in gaps.items() if k not in ("bb_width", "bb_position")) < 1e-3, gaps
    assert max(gaps["bb_width"], gaps["bb_position"]) < 1e-2, gaps


def test_the_reference_rule_gives_the_ports_streams(port_run):
    ind, inp = port_run[1], port_run[2]
    ref = ref_sig.signal_inputs({k: v.numpy() for k, v in ind.items()})
    np.testing.assert_array_equal(inp.signal.numpy(), ref["signal"])
    np.testing.assert_array_equal(inp.volatility.numpy(), ref["volatility"])
    np.testing.assert_array_equal(inp.volume.numpy(), ref["volume"])
    assert np.max(np.abs(inp.strength.numpy() - ref["strength"])) < 1e-4


def test_the_reference_walk_equals_the_ports_replay_bit_for_bit(port_run):
    inp, params, stats = port_run[2], port_run[3], port_run[4]
    streams = {k: getattr(inp, k).numpy() for k in judge.STREAMS}
    gate = ref_sig.entry_gate(streams["signal"], streams["strength"],
                              streams["confidence"], streams["decision"])
    assert gate.any()
    for b in range(params.stop_loss.shape[0]):
        ref = ref_replay.walk(streams["close"], gate, streams["volatility"], streams["volume"],
                              params.stop_loss[b].item(), params.take_profit[b].item())
        for k in ref_replay.FIELDS_F + ref_replay.FIELDS_I:
            assert getattr(stats, k)[b].item() == ref[k], (b, k)


def test_the_stops_are_recomputed_from_the_draw(port_run):
    params = port_run[3]
    u = torch.rand((12, 18), generator=torch.Generator().manual_seed(7)).numpy()
    stops, targets = judge.stops_from_uniforms(u)
    np.testing.assert_array_equal(stops, params.stop_loss.numpy())
    np.testing.assert_array_equal(targets, params.take_profit.numpy())


def test_the_reference_metrics_agree_with_the_ports(port_run):
    stats, metrics = port_run[4], port_run[5]
    s = {k: getattr(stats, k).numpy() for k in stats._fields}
    got = judge.metric_numbers(s, {k: v.numpy() for k, v in metrics.items()})
    assert got["metrics_err"] < 1e-5
    suite = ref_metrics.metric_suite({k: (v.astype(np.int64) if v.dtype.kind == "i" else v.astype(np.float64))
                                      for k, v in s.items()})
    assert set(suite) <= set(metrics)
