"""device_step_ms_p50: the median over the window of the engine's
``gauges/device_step_ms`` counter, in ms: the captured decode step's device
time, from the CUDA events the engine records around each replay when its
tracer is on (``serving.capture.StepTimer``)."""
import statistics


def read(run):
    vals = run.counters.get("gauges/device_step_ms", [])
    return statistics.median(vals) if vals else None
