"""Datasets of the port (the synthetic shapes generator)."""
