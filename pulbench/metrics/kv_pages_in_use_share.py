"""kv_pages_in_use_share: the mean over the window's ticks of the engine's
``hot_pages_in_use`` gauge (``KVPagePool.hot_in_use``) over the pool's
usable hot frames, in %."""


def read(run):
    vals = run.counters.get("gauges/hot_pages_in_use", [])
    if not vals or run.pool_capacity <= 0:
        return None
    return 100.0 * sum(vals) / len(vals) / run.pool_capacity
