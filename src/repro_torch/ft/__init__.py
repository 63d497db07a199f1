"""Failure detection and fault injection for the serving fleet (copies of
``repro.ft.monitor`` and ``repro.ft.faults``)."""
