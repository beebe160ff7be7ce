"""The traced run's device reading: `torch.profiler` over a steady stretch.

The profiler runs over the window's last stretch: from the first request
that starts ``start_s`` seconds into the window until ``stretch_s`` seconds
have passed (or the window closes), so that the requests before it run as
in an untraced run and host timers read them clean.  From its trace
(Chrome format, written to the run's ``TMPDIR`` and deleted once read):

  * ``busy_s``: the union of the intervals in which a kernel, a copy or a
    memset ran on the card;
  * ``window_s``: from the first ``portbench.*`` label's start to the last
    one's end, the labels the benchmark puts around its calls;
  * ``device_ops``: the ten kernels and copies that took most device time;
  * ``idle_gaps``: the card's idle time, summed by the ``portbench.*`` label
    that the host was inside meanwhile, the ten largest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LABEL_PREFIX = "portbench."


class Tracer:
    def __init__(self, stretch_s: float, start_s: float):
        self.stretch_s, self.start_s = float(stretch_s), float(start_s)
        self._prof = None
        self._t0 = None
        self.summary = None

    def warm(self) -> None:
        """A first profiler run on a trivial kernel, in set-up: the
        profiler's own start-up (CUPTI's) takes seconds the first time."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @property
    def started(self) -> bool:
        """Whether the profiler has started in this run (what runs from then
        on may carry its cost, also once it has stopped)."""
        return self._prof is not None or self.summary is not None

    def tick(self, elapsed: float) -> None:
        """Called before each request of the window with the seconds since
        the window opened."""
        if self._prof is None and elapsed >= self.start_s and self.summary is None:
            import torch

            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            self._t0 = elapsed
        elif self._prof is not None and self._t0 is not None and elapsed - self._t0 >= self.stretch_s:
            self._stop()

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        self._t0 = None

    def close(self) -> None:
        """Stop the profiler if it still runs, then read its trace (after
        the window: the export takes seconds)."""
        if self._prof is None:
            return
        if self._t0 is not None:
            self._stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _split_gap(a: float, b: float, labels: list, starts: list, gaps: dict) -> None:
    """Add the idle interval [a, b] to ``gaps`` by the labels it overlaps
    (the benchmark's labels do not nest); the rest is between requests."""
    covered = 0.0
    for la, lb, name in labels[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if la >= b:
            break
        overlap = min(b, lb) - max(a, la)
        if overlap > 0:
            gaps[name] = gaps.get(name, 0.0) + overlap
            covered += overlap
    if b - a - covered > 0:
        name = LABEL_PREFIX + "between_requests"
        gaps[name] = gaps.get(name, 0.0) + (b - a - covered)


def summarize(events: list) -> dict:
    """The reading of a Chrome-format trace (times in microseconds)."""
    dev, labels, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, a + d))
            name = str(e.get("name", "?"))[:160]
            ops[name] = ops.get(name, 0.0) + d
        elif e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(LABEL_PREFIX):
            labels.append((a, a + d, e["name"]))
    if not labels or not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    lo = min(a for a, _, _ in labels)
    hi = max(b for _, b, _ in labels)
    busy = _union([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
    busy_us = sum(b - a for a, b in busy)
    labels.sort()
    starts = [a for a, _, _ in labels]
    gaps, cursor = {}, lo
    for a, b in busy + [[hi, hi]]:
        if a > cursor:
            _split_gap(cursor, a, labels, starts, gaps)
        cursor = max(cursor, b)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "device_ops": top(ops), "idle_gaps": top(gaps)}
