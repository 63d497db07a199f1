"""Continuously batched serving engine, sampling and overload control."""
