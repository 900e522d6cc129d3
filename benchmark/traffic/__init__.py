"""Traffic drivers, one per traffic kind: ``<kind>.py`` with ``run``."""
