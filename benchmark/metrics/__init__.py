"""Metric readers, one per metric: ``<metric>.py`` with ``read(rec)``."""
