"""page_walk_ms_p50: the median over the window's decode ticks of the
host's page walk, in ms: ``engine/decode_pages`` (tail pages, the working
set, ``pool.ensure_hot``) plus ``engine/decode_fill`` (the step buffer with
its page table, and its copy to the card) of the same tick, paired by the
harness tick that contains both."""
import bisect
import statistics

PHASES = ("engine/decode_pages", "engine/decode_fill")


def read(run):
    spans = sorted((s, e, name) for name, s, e in run.spans
                   if name in PHASES)
    starts = [s for s, _, _ in spans]
    walks = []
    for t in run.ticks:
        lo = bisect.bisect_left(starts, t.t0)
        hi = bisect.bisect_right(starts, t.t1)
        inside = [(name, e - s) for s, e, name in spans[lo:hi] if e <= t.t1]
        if sorted(name for name, _ in inside) == sorted(PHASES):
            walks.append(sum(d for _, d in inside))
    return statistics.median(walks) * 1e3 if walks else None
