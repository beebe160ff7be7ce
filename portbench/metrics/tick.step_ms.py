"""tick.step_ms: host milliseconds of one `TickEngine.step` (its uploads,
the tick program's launches over every symbol and frame, its one read);
mean over the unprofiled ticks."""

from portbench.metrics import _host


def read(run):
    return _host.mean_ms(run, lambda t: t["tick"])
