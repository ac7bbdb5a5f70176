"""The benchmark's CPU tests: ``python -m pytest -q pulbench/tests`` from the
root of the repository. The port is imported from ``src/``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _windows_of_whole_steps(monkeypatch):
    """A tiny run's window of 0 seconds holds exactly this many steps, so
    that what a test judges does not depend on the machine's speed."""
    from pulbench import harness
    monkeypatch.setattr(harness, "MIN_WINDOW_STEPS", 24)
