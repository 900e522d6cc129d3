"""Operation counts of the configurations' steps and requests, from their
shapes: one file per configuration, ``<config>.py``, with ``step`` and
``request``."""
