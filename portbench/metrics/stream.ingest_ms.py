"""stream.ingest_ms: host milliseconds from a tick's first frame offered to
its updates published (`StreamSupervisor.offer` and `step`: parsing, the
candle books, the drain through the monitor, the bus), less the
`TickEngine.step` inside it; mean over the unprofiled ticks."""

from portbench.metrics import _host


def read(run):
    return _host.mean_ms(run, lambda t: t["stream"] - t["tick"])
