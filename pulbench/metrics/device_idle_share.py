"""device_idle_share: the share of the traced slice in which no kernel,
copy or set ran on the card (the union of the profiler's device intervals
left out), in %."""


def read(run):
    dt = run.device_trace
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
