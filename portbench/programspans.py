"""The program's own spans in a cell's run: their host times, and the
profiler's trace joined with them.

The port opens a span at each layer boundary of a tick and of a sweep
request (`ai_crypto_trader_tpu_torch.utils.tracing`); with
``Tracer(profiler_ranges=True)`` each is also a ``user_annotation`` range
of a `torch.profiler` trace.  `join` reads such a trace (Chrome format,
times in microseconds) over the stretch of its root ranges (``tick`` or
``request``):

  * for each program span name: the ranges (``count``), the CUDA launch
    calls and the synchronizing calls made inside them, their descendants'
    included (``launches``, ``syncs``), and the card's idle time during
    which it was the innermost program span open on the host (``idle_s``);
  * the idle time under no program span below the root
    (``idle_unattributed_s``), split by the ``portbench.*`` label the host
    was in (``unattributed_by_label``).

`NUMBERS` computes the per-layer numbers from the spans and the join: host
milliseconds as means over the ticks or requests the profiler had not yet
slowed (the root's ``profiled`` attribute), counts per root over the
profiled stretch.  The harness's run (`portbench.run`) does not read them
yet: PERF.md §7 says which files would.  Until then the module runs a cell
itself with the program's tracer on:

    python3 -m portbench.programspans --workload <cell> --seed <n> \\
        --seconds <s> [--profile 0|1] [--spans 0|1|2]

and prints one JSON line: the cell's rate, the harness's host times
(``tick.step_ms`` …), the numbers, each span's mean host milliseconds, and
with ``--profile 1`` the join.  Nothing is judged: the harness's runs
judge the same program.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOTS = ("tick", "request")
LABEL_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cuLaunchKernel", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
         "cudaMemcpy")
RING = 1 << 18


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name or name in LAUNCHES


def is_sync(name: str) -> bool:
    return name in SYNCS


def _innermost(ranges: list) -> list:
    """[(a, b, name)]: the innermost of the nested ``ranges`` open over each
    stretch where one is (boundaries swept in time order)."""
    marks = []
    for i, (a, b, name) in enumerate(ranges):
        marks.append((a, 1, -b, i))
        marks.append((b, 0, -a, i))
    marks.sort()
    out, open_ = [], []
    last = None
    for t, kind, _, i in marks:
        if open_ and last is not None and t > last:
            out.append((last, t, ranges[open_[-1]][2]))
        if kind == 1:
            open_.append(i)
        else:
            open_.remove(i)
        last = t
    return out


def _overlay(pieces: list, segments: list) -> list:
    """[(a, b, name or None)]: each interval of ``pieces`` (sorted, disjoint)
    cut by the ``segments`` (sorted, disjoint) it overlaps, None where
    none does."""
    out, j = [], 0
    starts = [s[0] for s in segments]
    for a, b in pieces:
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        cursor = a
        while cursor < b:
            while j < len(segments) and segments[j][1] <= cursor:
                j += 1
            if j >= len(segments) or segments[j][0] >= b:
                out.append((cursor, b, None))
                break
            sa, sb, name = segments[j]
            if sa > cursor:
                out.append((cursor, sa, None))
                cursor = sa
            end = min(sb, b)
            out.append((cursor, end, name))
            cursor = end
    return out


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def join(events: list) -> dict | None:
    """The trace's device intervals, CUDA calls and program ranges, joined
    (module docstring); None without a root range or a device interval."""
    ranges, labels, calls, dev = {}, [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat"), str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((a, b))
        elif cat in CALL_CATS:
            calls.append((a, (e.get("pid"), e.get("tid")), name))
        elif cat == "user_annotation":
            if name.startswith(LABEL_PREFIX):
                labels.append((a, b, name))
            else:
                ranges.setdefault((e.get("pid"), e.get("tid")), []).append((a, b, name))
    roots = [r for rs in ranges.values() for r in rs if r[2] in ROOTS]
    if not roots or not dev:
        return None
    lo, hi = min(r[0] for r in roots), max(r[1] for r in roots)
    spans: dict = {}

    def entry(name):
        return spans.setdefault(name, {"count": 0, "launches": 0, "syncs": 0, "idle_s": 0.0})

    for rs in ranges.values():
        for a, b, name in rs:
            if a >= lo and b <= hi:
                entry(name)["count"] += 1
    # each call counts in every range open around it on its thread
    by_thread: dict = {}
    for t, where, name in sorted(calls):
        launch, sync = is_launch(name), is_sync(name)
        if (launch or sync) and lo <= t <= hi:
            by_thread.setdefault(where, []).append((t, launch, sync))
    for key, rs in ranges.items():
        rs.sort(key=lambda r: (r[0], -r[1]))
        stack, i = [], 0
        for t, launch, sync in by_thread.get(key, ()):
            while i < len(rs) and rs[i][0] <= t:
                while stack and stack[-1][1] <= rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            for _, _, rname in stack:
                entry(rname)["launches"] += launch
                entry(rname)["syncs"] += sync
    busy = _union([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
    idle, cursor = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    host = max(ranges, key=lambda k: sum(1 for r in ranges[k] if r[2] in ROOTS))
    loose = []
    for a, b, name in _overlay(idle, _innermost(ranges[host])):
        if name is None or name in ROOTS:
            loose.append((a, b))
        else:
            entry(name)["idle_s"] += (b - a) / 1e6
    by_label: dict = {}
    for a, b, name in _overlay(loose, _innermost(labels)):
        key = name or LABEL_PREFIX + "between_requests"
        by_label[key] = by_label.get(key, 0.0) + (b - a) / 1e6
    return {"roots": len(roots), "window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "idle_s": sum(b - a for a, b in idle) / 1e6,
            "idle_unattributed_s": sum(b - a for a, b in loose) / 1e6,
            "unattributed_by_label": by_label, "spans": spans}


# -- the per-layer numbers -----------------------------------------------------

def per_root_ms(spans: list, names: tuple) -> list:
    """The host milliseconds of the spans named ``names`` in each
    unprofiled root (summed within the root), in root order; empty where
    no such span ran."""
    roots = {s["trace_id"]: s for s in spans
             if s["parent_id"] is None and s["name"] in ROOTS
             and not s["attributes"].get("profiled")}
    total = {tid: 0.0 for tid in roots}
    found = False
    for s in spans:
        if s["name"] in names and s["trace_id"] in total:
            total[s["trace_id"]] += (s["end"] - s["start"]) * 1e3
            found = True
    return [total[tid] for tid in roots] if found else []


def mean_ms(*names):
    def read(spans, joined):
        ms = per_root_ms(spans, names)
        return sum(ms) / len(ms) if ms else None
    return read


def per_root(name, key):
    def read(spans, joined):
        if not joined or not joined["roots"] or name not in joined["spans"]:
            return None
        return joined["spans"][name][key] / joined["roots"]
    return read


def unattributed_pct(spans, joined):
    if not joined or joined["idle_s"] <= 0:
        return None
    return 100.0 * joined["idle_unattributed_s"] / joined["idle_s"]


NUMBERS = {
    "trading": {
        "stream.parse_ms": mean_ms("stream.parse", "monitor.ingest"),
        "stream.publish_ms": mean_ms("monitor.publish"),
        "tick.stage_ms": mean_ms("tick.stage"),
        "tick.dispatch_ms": mean_ms("tick.dispatch"),
        "tick.read_ms": mean_ms("tick.read"),
        "tick.launches": per_root("monitor.tick_engine", "launches"),
        "decide.dispatch_ms": mean_ms("tenant.dispatch"),
        "decide.launches": per_root("tenant.decide", "launches"),
        "device.syncs.trading": per_root("tick", "syncs"),
        "device.idle_unattributed_pct.trading": unattributed_pct,
    },
    "sweep": {
        "replay.stage_ms": mean_ms("replay.stage"),
        "replay.launches": per_root("backtest.sweep", "launches"),
        "device.idle_unattributed_pct.sweep": unattributed_pct,
    },
}


def span_means(spans: list) -> dict:
    """{span name: mean host ms per unprofiled root}, for every name."""
    names = sorted({s["name"] for s in spans})
    return {n: mean_ms(n)(spans, None) for n in names}


# -- a cell's run with the program's tracer on ---------------------------------

class _KeptTrace:
    """`portbench.trace.Tracer`'s profiler, its Chrome events kept."""

    def __init__(self, base):
        self.base, self.events = base, None

    def __getattr__(self, name):
        return getattr(self.base, name)

    def close(self) -> None:
        base = self.base
        if base._prof is None:
            return
        if base._t0 is not None:
            base._stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            base._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        base._prof = None
        from portbench.trace import summarize

        base.summary = summarize(self.events)


def _rooted(cell, kind: str, profiler, tracer, alternate: bool) -> None:
    """Open the root span around each of ``cell``'s ticks or requests.
    With ``alternate`` the tracer is on for every other one only; each
    one's host seconds go to ``cell.alternated[on]``."""
    from ai_crypto_trader_tpu_torch.utils import tracing

    started = lambda: profiler is not None and profiler.started  # noqa: E731
    order = itertools.count()
    cell.alternated = {True: [], False: []}

    @contextlib.contextmanager
    def root(name):
        on = not alternate or next(order) % 2 == 1
        t = time.perf_counter()
        if on:
            tracing.configure(tracer)
        try:
            with tracing.span(name, attributes={"profiled": started()}):
                yield
        finally:
            if alternate:
                tracing.disable()
            cell.alternated[on].append(time.perf_counter() - t)

    if kind == "trading":
        real = cell.tick

        async def tick():
            with root("tick"):
                return await real()
        cell.tick = tick
    else:
        real = cell.request

        def request(i, keep=True):
            with root("request"):
                return real(i, keep=keep)
        cell.request = request


def measure(spec: dict, seed: int, seconds: float, device: str, profile: bool,
            spans: int) -> dict:
    """One window of ``spec``'s cell with the program's spans off (0), on
    (1) or on for every other tick or request (2), and the profiler over
    its last stretch or not; the numbers of it."""
    import torch

    from ai_crypto_trader_tpu_torch.utils import tracing
    from portbench import run
    from portbench.metrics import _host
    from portbench.trace import Tracer

    kind_name = spec["config"]["kind"]
    kind = importlib.import_module(f"portbench.kinds.{kind_name}")
    cell = kind.Cell(spec["config"], spec["traffic"], seed, device)
    on_card = torch.device(device).type == "cuda"
    profiler = None
    if profile and on_card:
        profiler = _KeptTrace(Tracer(run.PROFILE_STRETCH_S,
                                     max(seconds - run.PROFILE_STRETCH_S - 1.0, 0.0)))
        profiler.warm()
    cell.prepare()
    setup_s = time.perf_counter() - T0 - cell.reference_s
    cell.spans.enabled = True
    tracer = None
    if spans:
        tracer = tracing.Tracer(service=spec["cell"]["name"], now_fn=time.perf_counter,
                                ring_size=RING, profiler_ranges=True)
        tracing.configure(tracer)
        _rooted(cell, kind_name, profiler, tracer, alternate=spans == 2)
    try:
        window = kind.run_window(cell, seconds, profiler)
    finally:
        tracing.disable()
    finished = []
    if tracer is not None:
        tracer.resolve()
        finished = [s.to_dict() for s in tracer.finished]
    joined = join(profiler.events) if profiler is not None and profiler.events else None
    numbers = ({k: f(finished, joined) for k, f in NUMBERS[kind_name].items()}
               if finished else {})
    host = {}
    if kind_name == "trading":
        ticks = getattr(cell, "host_ms", [])
        host = {"tick.step_ms": _host.mean_ms(cell, lambda t: t["tick"]),
                "decide.ms": _host.mean_ms(cell, lambda t: t["decide"]),
                "stream.ingest_ms": _host.mean_ms(cell, lambda t: t["stream"] - t["tick"]),
                "ticks_unprofiled": sum(not t["profiled"] for t in ticks)}
    trace = profiler.summary if profiler is not None else None
    out = {"workload": spec["cell"]["name"], "seed": seed, "spans": spans,
           "profile": bool(profiler), "setup_s": setup_s, "window_s": window["window_s"],
           "attempted": window["attempted"], "failed": window["failed"],
           **window["end_to_end"], "host": host, "numbers": numbers,
           "span_ms": span_means(finished), "n_spans": len(finished),
           "idle_pct": _host.idle_pct(SimpleNamespace(trace=trace)) if trace else None,
           "join": joined}
    if trace:
        out["breakdown"] = {"busy_s": trace["busy_s"], "window_s": trace["window_s"],
                            "idle_gaps": trace["idle_gaps"]}
    if spans == 2:
        # host ms of a tick or request with spans on and off, in turns:
        # means and medians
        out["alternate"] = {"n": sum(len(v) for v in cell.alternated.values())}
        for on, v in cell.alternated.items():
            side = "on" if on else "off"
            out["alternate"][f"{side}_ms"] = 1e3 * sum(v) / max(len(v), 1)
            out["alternate"][f"{side}_median_ms"] = 1e3 * statistics.median(v) if v else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1, 2), default=1,
                    help="the program's spans off, on, or on every other tick or request")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import run

    run.set_cache_dirs()
    spec = run.load_cell(args.workload)
    out = measure(spec, args.seed, args.seconds, args.device, bool(args.profile), args.spans)
    out["card"] = run.power_limit() if args.device == "cuda" else "cpu"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
