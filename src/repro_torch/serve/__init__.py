"""Serving of the port: the online graph-query service
(``graph_service.py``) and its JSON-over-HTTP frontend (``http.py``), and
the language-model engine of the dense decoders (``engine.py``,
``serve_step.py``; the other families are ROADMAP.md A.13.3)."""
