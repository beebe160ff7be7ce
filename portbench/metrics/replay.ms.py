"""replay.ms: device ms of one `backtest.sweep` call (CUDA events around
it), mean over the traced window's requests."""


def read(run):
    ms = run.device_ms.get("replay")
    return sum(ms) / len(ms) if ms else None
