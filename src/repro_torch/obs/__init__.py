"""Tracing and metrics of the port (copies of the reference package's
`obs/tracer.py` and `obs/metrics.py`)."""
from repro_torch.obs.metrics import (
    MetricsRegistry,
    Sample,
    cache_economics,
    economics_into_registry,
    serving_roofline,
)
from repro_torch.obs.tracer import (
    NULL_TRACER,
    NullTracer,
    TraceEvent,
    Tracer,
    load_chrome_trace,
    page_events_from_chrome,
    validate_chrome_trace,
)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "TraceEvent",
    "load_chrome_trace", "validate_chrome_trace", "page_events_from_chrome",
    "MetricsRegistry", "Sample", "cache_economics",
    "economics_into_registry", "serving_roofline",
]
