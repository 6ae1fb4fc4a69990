"""Serving of the port: the online graph-query service
(``graph_service.py``) and its JSON-over-HTTP frontend (``http.py``); the
reference's language-model engine is ROADMAP.md queue A.13."""
