"""Meshes and layouts: the serving-mesh context (a copy of
``repro.sharding.context``) and ``Mesh``, a grid of devices with named
axes (``mesh.py``); the reference's sharding specs (``specs.py``) and the
train state placed by them on a ``torch.distributed`` ``DeviceMesh``,
with the gathers and reductions around it (``placement.py``)."""
