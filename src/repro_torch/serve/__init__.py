"""Serving of the port: the online graph-query service
(``graph_service.py``) and its JSON-over-HTTP frontend (``http.py``), and
the language-model engine of every decoder-only family (``engine.py``)
and the prefill/decode functions of every family, the encoder-decoder
included (``serve_step.py``)."""
