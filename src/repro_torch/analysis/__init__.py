"""Page-lifecycle events and the DMA-plan verifier (copies of the reference
package's `analysis/events.py` and `analysis/plan_verifier.py`). The
lifecycle sanitizer and the jit lint are not ported yet (ROADMAP)."""
from repro_torch.analysis.events import EventKind, PageEvent, TraceLog
from repro_torch.analysis.plan_verifier import (
    PlanError,
    PlanReport,
    verify_kv_page_plan,
    verify_stream_plan,
)

__all__ = [
    "EventKind", "PageEvent", "TraceLog",
    "PlanError", "PlanReport", "verify_stream_plan", "verify_kv_page_plan",
]
