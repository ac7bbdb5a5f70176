"""Page-lifecycle events, the lifecycle sanitizer and the DMA-plan verifier
(copies of the reference package's `analysis/events.py`,
`analysis/sanitizer.py` and `analysis/plan_verifier.py`; pure Python, no
torch), and the capture-safety lint (`analysis/lint.py`, the reference's
jit lint translated; `python -m repro_torch.analysis.lint`)."""
from repro_torch.analysis.events import EventKind, PageEvent, TraceLog
from repro_torch.analysis.plan_verifier import (
    PlanError,
    PlanReport,
    diff_fifo_occupancy,
    verify_kv_page_plan,
    verify_stream_plan,
)
from repro_torch.analysis.sanitizer import (
    LifecycleChecker,
    LifecycleViolationError,
    Violation,
    check_page_trace,
    format_violations,
)

__all__ = [
    "EventKind", "PageEvent", "TraceLog",
    "LifecycleChecker", "LifecycleViolationError", "Violation",
    "check_page_trace", "format_violations",
    "PlanError", "PlanReport", "verify_stream_plan", "verify_kv_page_plan",
    "diff_fifo_occupancy",
]
