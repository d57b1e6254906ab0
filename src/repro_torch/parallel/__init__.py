"""Cross-process fault tolerance of the port (``resilience``)."""
