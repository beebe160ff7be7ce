"""The host's times of a trading cell's ticks: the benchmark's timers
around the port's calls, in a traced run.  A reader takes the ticks that
ran before the profiler started, whose own cost would be in them."""


def mean_ms(run, part):
    """The mean of ``part(tick)`` over the unprofiled ticks, or None."""
    ms = [part(t) for t in run.host_ms if not t["profiled"]]
    return sum(ms) / len(ms) if ms else None


def idle_pct(run):
    """The share of the profiled stretch in which no kernel, copy or memset
    ran on the card, in percent, or None without a reading."""
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
