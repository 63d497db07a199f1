"""Multi-host bring-up (the port's copy of ``repro.launch.multihost``):
everything between ``srun python -m repro_torch.launch.train`` (or
``torchrun``) on N hosts and a live global mesh.

Each process is one rank with one device.  The rendezvous and the rank
come from the scheduler's environment: SLURM, explicit ``REPRO_*``
variables (the card ``REPRO_LOCAL_RANK``, else ``LOCAL_RANK``), or
torchrun's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``;
without any, a single process.

Fleet bring-up mirrors the paper's join protocol:
  1. ``torch.distributed.init_process_group``  (join the job)
  2. certification                          (device profile sanity: card
                                             count/memory as "slots")
  3. UP publisher start                     (heartbeats to the MP table)
  4. mesh construction over the world       (data/model[/pod] axes)
  5. restore-or-init from the checkpoint dir (elastic resume)

A process group on the card uses NCCL and needs one; ``gloo`` is used only
when the caller asks for ``device="cpu"``.  A failed init raises: it never
falls back to another backend or device.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import torch


@dataclass
class ClusterEnv:
    coordinator: str
    num_processes: int
    process_id: int
    local_rank: int = 0       # the process's card on its host

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def detect_cluster() -> ClusterEnv:
    """SLURM first, then explicit REPRO_* vars, then torchrun's, else
    single-process."""
    env = os.environ
    if "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].replace("[", "").split("-")[0] \
            if nodelist else socket.gethostname()
        return ClusterEnv(
            coordinator=f"{head}:{env.get('REPRO_PORT', '8476')}",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env["SLURM_PROCID"]),
            local_rank=int(env.get("SLURM_LOCALID", 0)))
    if "REPRO_NUM_PROCESSES" in env:
        return ClusterEnv(
            coordinator=env["REPRO_COORDINATOR"],
            num_processes=int(env["REPRO_NUM_PROCESSES"]),
            process_id=int(env["REPRO_PROCESS_ID"]),
            local_rank=int(env.get("REPRO_LOCAL_RANK",
                                   env.get("LOCAL_RANK", 0))))
    if "WORLD_SIZE" in env and "RANK" in env:
        return ClusterEnv(
            coordinator=f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            num_processes=int(env["WORLD_SIZE"]),
            process_id=int(env["RANK"]),
            local_rank=int(env.get("LOCAL_RANK", 0)))
    return ClusterEnv(coordinator="", num_processes=1, process_id=0)


def initialize(env: Optional[ClusterEnv] = None, device="cuda", store=None,
               timeout_s: float = 600.0) -> ClusterEnv:
    """Join the job: ``init_process_group`` with NCCL on the card (the
    process's card is ``env.local_rank``), gloo with ``device="cpu"``.  The
    rendezvous is ``store`` when given (a ``FileStore``: no port), else the
    coordinator's TCP address, else, for a single process, an in-process
    store.  A no-op when the group exists."""
    import torch.distributed as dist

    from repro_torch.common.device import resolve_device

    env = env or detect_cluster()
    dev = resolve_device(device)
    if dist.is_initialized():
        return env
    if dev.type == "cuda":
        torch.cuda.set_device(env.local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = dict(rank=env.process_id, world_size=env.num_processes,
              timeout=timedelta(seconds=timeout_s))
    if store is None and env.is_multiprocess:
        kw["init_method"] = f"tcp://{env.coordinator}"
    else:
        kw["store"] = store if store is not None else dist.HashStore()
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", env.local_rank)
    dist.init_process_group(backend, **kw)
    return env


def certify_host(min_devices: int = 1,
                 min_hbm_bytes: int = 0) -> Tuple[bool, str]:
    """The paper's device certification, per host: enough cards and memory
    on each."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < min_devices:
        return False, f"{n} local devices < required {min_devices}"
    for i in range(n if min_hbm_bytes else 0):
        if torch.cuda.get_device_properties(i).total_memory < min_hbm_bytes:
            return False, f"device {i}: insufficient memory"
    return True, "ok"


def global_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                pods: int = 1, device="cuda"):
    """Mesh over every rank of the world; defaults to (world, 1)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    n = dist.get_world_size()
    if dp is None and tp is None:
        dp, tp = n // pods, 1
    elif tp is None:
        tp = n // (dp * pods)
    elif dp is None:
        dp = n // (tp * pods)
    if dp * tp * pods != n:
        raise ValueError(f"mesh {pods} x {dp} x {tp} over a world of {n}")
    return make_mesh(dp, tp, pods, device=device)


def bringup(*, required_apps=None, heartbeat_ms: float = 1000.0,
            mp_table=None, device="cuda"):
    """Full node bring-up; returns (env, mesh, publisher or None)."""
    from repro_torch.common.device import resolve_device
    from repro_torch.core.latency import NodeState
    from repro_torch.core.profile import DeviceProfile
    from repro_torch.core.telemetry import UpdateProfilePublisher

    on_card = resolve_device(device).type == "cuda"
    env = initialize(device=device)
    ok, why = certify_host(min_devices=1 if on_card else 0)
    if not ok:
        raise RuntimeError(f"host certification failed: {why}")
    mesh = global_mesh(device=device)

    publisher = None
    if mp_table is not None:
        prof = DeviceProfile(
            device_id=f"host{env.process_id}",
            slots=torch.cuda.device_count() if on_card else 1,
            apps=required_apps or {})
        publisher = UpdateProfilePublisher(
            prof.device_id, prof,
            lambda: NodeState(running=0, queued=0),
            mp_table, period_ms=heartbeat_ms)
        publisher.start()
    return env, mesh, publisher
