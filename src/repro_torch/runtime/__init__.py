"""Runtime of the port (``repro/runtime``): fault tolerance."""
