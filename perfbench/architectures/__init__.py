"""One file an architecture, ``<architecture>.py``, found by the name a
configuration gives under ``architecture`` (``harness.load_module``). Each
gives its convolutions, feature sizes, predictor sources, parameters with
their initialisation rules, the plain float32 forward, and the name of the
port's builder as a string, so that nothing here imports the port.
Modules whose names start with ``_`` are helpers, not architectures."""
