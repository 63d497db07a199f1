"""Failure detection for the serving fleet (copy of ``repro.ft.monitor``)."""
