"""decide.tick_p95_ms: the 95th percentile of the host milliseconds from a
tick's first frame offered to its decisions read (the trading cell's
decision latency), over the unprofiled ticks of the traced window."""

import numpy as np


def read(run):
    ms = [t["total"] for t in run.host_ms if not t["profiled"]]
    return float(np.percentile(ms, 95)) if ms else None
