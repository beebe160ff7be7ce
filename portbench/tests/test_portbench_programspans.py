"""The join of the program's spans with the profiler's trace, the numbers
read from them, and a cell's run with the program's tracer on, on the
CPU."""

import pytest

from portbench import programspans as ps
from portbench.tests.cells import CELLS, kind_of, small


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def _trace():
    """Two ticks on thread 1, in µs.  Tick 0 at [0, 100): stage [2, 10),
    dispatch [10, 30) with three launches and a runtime copy, read
    [30, 40) with its event wait; a bare sync under the root at 50; the
    decide [60, 90) with one cooperative launch and one wait.  Tick 1 at
    [200, 260) alike but smaller.  The card busy [12, 35) and [212, 232);
    benchmark labels over [0, 45) and [200, 300); a second thread's call
    outside every range."""
    ev = [_x("user_annotation", "portbench.stream", 0, 45),
          _x("user_annotation", "portbench.stream", 200, 100)]
    for t0, n in ((0, 3), (200, 1)):
        ev += [_x("user_annotation", "tick", t0, 100 if t0 == 0 else 60),
               _x("user_annotation", "monitor.tick_engine", t0 + 2, 38),
               _x("user_annotation", "tick.stage", t0 + 2, 8),
               _x("user_annotation", "tick.dispatch", t0 + 10, 20),
               _x("user_annotation", "tick.read", t0 + 30, 10),
               _x("cuda_runtime", "cudaMemcpyAsync", t0 + 11, 1),
               _x("cuda_runtime", "cudaEventSynchronize", t0 + 31, 5)]
        ev += [_x("cuda_runtime", "cudaLaunchKernel", t0 + 12 + i, 1) for i in range(n)]
        ev += [_x("kernel", "k", t0 + 12, 23 if t0 == 0 else 20)]
    ev += [_x("cuda_runtime", "cudaStreamSynchronize", 50, 1),
           _x("user_annotation", "tenant.decide", 60, 30),
           _x("cuda_runtime", "cudaLaunchCooperativeKernel", 65, 1),
           _x("cuda_runtime", "cudaEventSynchronize", 80, 1),
           _x("cuda_runtime", "cudaLaunchKernel", 150, 1, tid=2),
           {"ph": "i", "name": "instant", "ts": 5}]
    return ev


def test_the_join_counts_calls_and_idle_time_by_span():
    j = ps.join(_trace())
    assert j["roots"] == 2 and j["window_s"] == pytest.approx(260e-6)
    assert j["busy_s"] == pytest.approx(43e-6)
    s = j["spans"]
    assert s["tick"] == {"count": 2, "launches": 5, "syncs": 4,
                         "idle_s": pytest.approx(0.0)}
    assert s["monitor.tick_engine"]["launches"] == 4 and s["monitor.tick_engine"]["syncs"] == 2
    assert s["tick.dispatch"]["launches"] == 4 and s["tick.dispatch"]["syncs"] == 0
    assert s["tick.read"]["syncs"] == 2 and s["tenant.decide"] == {
        "count": 1, "launches": 1, "syncs": 1, "idle_s": pytest.approx(30e-6)}
    # idle by innermost span: stage [2,10) and [202,210); dispatch [10,12) twice;
    # read [35,40) and [232,240)
    assert s["tick.stage"]["idle_s"] == pytest.approx(16e-6)
    assert s["tick.dispatch"]["idle_s"] == pytest.approx(4e-6)
    assert s["tick.read"]["idle_s"] == pytest.approx(13e-6)
    # the rest: under the root only or between ticks, split by label
    assert j["idle_s"] == pytest.approx(260e-6 - 43e-6)
    assert j["idle_unattributed_s"] == pytest.approx(j["idle_s"] - 63e-6)
    by = j["unattributed_by_label"]
    # root only under a label: [0,2) [40,45) [200,202) [240,260); the rest
    # [45,60) [90,200) under no label
    assert by["portbench.stream"] == pytest.approx(29e-6)
    assert by["portbench.between_requests"] == pytest.approx(125e-6)
    assert sum(by.values()) == pytest.approx(j["idle_unattributed_s"])


def test_the_join_reads_nothing_without_a_root_or_the_card():
    assert ps.join([e for e in _trace() if e.get("name") != "tick"]) is None
    assert ps.join([e for e in _trace() if e.get("cat") != "kernel"]) is None


def _span(name, trace, parent, start, end, **attrs):
    return {"name": name, "trace_id": trace, "span_id": f"{trace}.{name}",
            "parent_id": parent, "start": start, "end": end, "attributes": attrs}


def test_the_numbers_are_means_over_unprofiled_roots_and_counts_per_root():
    spans = []
    for i, (profiled, stage) in enumerate(((False, 0.002), (False, 0.004), (True, 0.1))):
        t = f"t{i}"
        spans += [_span("tick", t, None, 0.0, 0.05, profiled=profiled),
                  _span("tick.stage", t, f"{t}.tick", 0.001, 0.001 + stage),
                  _span("stream.parse", t, f"{t}.tick", 0.0, 0.001),
                  _span("monitor.ingest", t, f"{t}.tick", 0.01, 0.013)]
    read = ps.NUMBERS["trading"]
    joined = ps.join(_trace())
    assert read["tick.stage_ms"](spans, None) == pytest.approx(3.0)
    assert read["stream.parse_ms"](spans, None) == pytest.approx(4.0)
    assert read["tick.read_ms"](spans, None) is None      # no such span ran
    assert read["tick.launches"](spans, joined) == 2.0
    assert read["device.syncs.trading"](spans, joined) == 2.0
    assert read["decide.launches"](spans, joined) == 0.5
    assert read["tick.launches"](spans, None) is None
    assert read["device.idle_unattributed_pct.trading"](spans, joined) == pytest.approx(
        100.0 * joined["idle_unattributed_s"] / joined["idle_s"])
    assert ps.span_means(spans)["tick"] == pytest.approx(50.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_with_the_programs_spans_on_the_cpu(cell):
    spec = small(cell)
    out = ps.measure(spec, 2**31 + 5, 1.0, "cpu", profile=False, spans=1)
    assert out["attempted"] > 0 and out["failed"] == 0 and out["n_spans"] > 0
    numbers = out["numbers"]
    assert set(numbers) == set(ps.NUMBERS[kind_of(cell)])
    if kind_of(cell) == "trading":
        for k in ("stream.parse_ms", "stream.publish_ms", "tick.stage_ms", "tick.dispatch_ms",
                  "tick.read_ms", "decide.dispatch_ms"):
            assert numbers[k] > 0.0, k
        ms = out["span_ms"]
        assert ms["monitor.tick_engine"] >= ms["tick.stage"] + ms["tick.dispatch"] + ms["tick.read"]
        assert out["host"]["tick.step_ms"] > 0.0
    else:
        assert numbers["replay.stage_ms"] is None     # the CPU's plain loop stages nothing
        assert out["span_ms"]["backtest.sweep"] > 0.0
    # no trace: the counts and the idle shares read nothing
    assert all(v is None for k, v in numbers.items()
               if k.endswith("launches") or k.startswith("device."))
    off = ps.measure(spec, 2**31 + 5, 0.5, "cpu", profile=False, spans=0)
    assert off["n_spans"] == 0 and off["numbers"] == {} and off["attempted"] > 0
    # in turns: the roots of every other tick or request only
    turns = ps.measure(spec, 2**31 + 5, 1.0, "cpu", profile=False, spans=2)
    roots = turns["span_ms"]["tick" if kind_of(cell) == "trading" else "request"]
    assert roots > 0.0 and turns["alternate"]["n"] == turns["attempted"]
    assert turns["alternate"]["on_ms"] > 0.0 and turns["alternate"]["off_ms"] > 0.0
