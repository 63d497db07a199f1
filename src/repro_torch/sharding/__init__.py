"""Serving meshes: the serving-mesh context (a copy of
``repro.sharding.context``) and ``Mesh``, a grid of devices with named
axes (``mesh.py``)."""
