"""Observability of the port (own copy of ``repro.obs.trace``)."""
