"""Observability of the port (:mod:`.profiling`)."""
