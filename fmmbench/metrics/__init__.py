"""Per-layer metrics: one reader each, ``read(trace) -> value or None``."""
