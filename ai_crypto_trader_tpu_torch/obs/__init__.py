"""Observability specs the port's device programs compute against."""
