"""device_idle: the share, in percent, of the profiled stretch (the first
batch's start to the last one's end) in which no kernel, copy or memset ran
on the card (device trace).  Nothing where the trace holds no device
activity."""


def read(run):
    prof = run.profile
    window = prof.window_s()
    if window <= 0 or not prof.device:
        return None
    return 100.0 * (1.0 - prof.busy_s() / window)
