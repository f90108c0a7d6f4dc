"""Observability seams of the port (the clock; tracing and metrics come
with a later slice)."""
