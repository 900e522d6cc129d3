"""Data parallelism across processes, one per GPU (``parallel/mesh.py``)."""
