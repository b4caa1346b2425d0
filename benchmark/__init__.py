"""The port's benchmark: one command runs one cell once (``run.py``)."""
