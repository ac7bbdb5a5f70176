"""tick_ms_p50: the median ``engine/tick`` span of the window, in ms (the
engine and scheduler's step, host clock)."""
import statistics


def read(run):
    ticks = [e - s for name, s, e in run.spans if name == "engine/tick"]
    return statistics.median(ticks) * 1e3 if ticks else None
