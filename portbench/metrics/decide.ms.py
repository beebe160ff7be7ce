"""decide.ms: host milliseconds from a tick's updates published to its
decisions read (`TenantEngine.feats_from_tick` and `decide`, its one
read); mean over the unprofiled ticks."""

from portbench.metrics import _host


def read(run):
    return _host.mean_ms(run, lambda t: t["decide"])
