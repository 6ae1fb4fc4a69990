"""Graph I/O: SPE preprocessing (``spe``), the tile store and its on-disk
format (``formats``, byte-identical to ``repro.graphio``), and synthetic
graph generators (``synth``).  Submodules are imported explicitly.
"""
