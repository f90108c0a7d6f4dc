"""Gradient handling of the port (one device; the collectives come with the
distributed slice)."""
