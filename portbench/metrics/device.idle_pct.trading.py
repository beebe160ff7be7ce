"""device.idle_pct.trading: the share of the profiled stretch of a trading
cell in which no kernel, copy or memset ran on the card, in percent
(`portbench.trace`)."""

from portbench.metrics import _host


def read(run):
    return _host.idle_pct(run)
