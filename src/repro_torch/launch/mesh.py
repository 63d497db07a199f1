"""Production meshes (the port's copy of ``repro.launch.mesh``), as
``torch.distributed`` ``DeviceMesh``es over the process group's ranks: one
rank a device.  Functions, not constants: importing this module touches no
device and no process group; calling one needs an initialized group
(``launch.multihost.initialize``) whose world is the mesh's size.
"""
from __future__ import annotations

from repro_torch.common.config import ParallelConfig
from repro_torch.sharding.specs import axis_sizes


def _device_type(device) -> str:
    """``"cuda"`` or ``"cpu"``, from a device or its name; ``cuda`` needs a
    card (``resolve_device``)."""
    from repro_torch.common.device import resolve_device
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 devices a pod; multi-pod = 2 pods = 512 devices.  Raises
    ``ValueError`` unless the world is that size."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {world}")
    return _init(device, shape, axes)


def _init(device, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_mesh(dp: int, tp: int, pods: int = 1, device="cuda"):
    if pods > 1:
        return _init(device, (pods, dp, tp), ("pod", "data", "model"))
    return _init(device, (dp, tp), ("data", "model"))


def make_host_mesh(device="cuda"):
    """Every rank of the world on the data axis: ``(world, 1)``."""
    import torch.distributed as dist
    _device_type(device)                   # no card: an error, first
    return make_mesh(dist.get_world_size(), 1, device=device)


def parallel_config_for(mesh) -> ParallelConfig:
    """The layout of ``mesh``: a ``DeviceMesh``, the port's
    ``sharding.mesh.Mesh`` or any object with axis names and sizes."""
    shape = axis_sizes(mesh)
    return ParallelConfig(dp=shape.get("data", 1), tp=shape.get("model", 1),
                          pods=shape.get("pod", 1))
