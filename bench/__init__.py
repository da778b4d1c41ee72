"""The benchmark of repro_torch on the card: ``python3 bench/run.py`` (see
its docstring) and the data, readers and reference it finds by name."""
