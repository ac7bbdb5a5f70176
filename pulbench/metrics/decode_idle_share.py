"""decode_idle_share: the share of the window's ``engine/decode`` spans in
which the card ran no decode step, in %: 100 x (1 - the window's summed
``gauges/device_step_ms`` over its summed ``engine/decode`` spans). Read
over the whole traced window from the engine's own CUDA events, not from
the profiled slice."""


def read(run):
    device_ms = run.counters.get("gauges/device_step_ms", [])
    decode_s = sum(e - s for name, s, e in run.spans
                   if name == "engine/decode")
    if not device_ms or decode_s <= 0:
        return None
    return 100.0 * (1.0 - sum(device_ms) / 1e3 / decode_s)
