"""Failure detection and fault injection for the serving fleet (copies of
``repro.ft.monitor`` and ``repro.ft.faults``), and elastic rescale of a
training run (``elastic.py``)."""
