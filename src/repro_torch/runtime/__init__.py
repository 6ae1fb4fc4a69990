"""Runtime services of the port: the tile scheduler (a copy of
``repro/runtime/scheduler.py``)."""
