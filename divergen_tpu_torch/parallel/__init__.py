"""Data parallelism over ranks (``mesh.py``)."""
