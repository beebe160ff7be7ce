"""replay.roofline_pct: the least time of B strategies replayed over T
candles (`_roofline.replay_work`, bound by operations) over the mean device
time of `backtest.sweep`, in percent."""

from portbench.metrics import _roofline


def read(run):
    seconds, _bound = _roofline.least_time(*_roofline.replay_work(run.shapes["T"], run.shapes["B"]))
    return _roofline.share_pct(seconds, run.device_ms.get("replay"))
