"""Fault-tolerant checkpointing: the port's copy of
``repro.checkpoint.manager``.

  * A checkpoint is one ``step_<N>`` directory holding a ``.npz`` shard
    (flattened path -> array) and a small JSON manifest.
  * **Atomic**: writes land in ``step_<N>.tmp<i>``, the manifest is
    fsynced, and the directory is ``os.replace``d into place, so a killed
    writer never corrupts the latest good checkpoint.
  * **Async**: ``save_async`` snapshots to host memory at once (training
    may then change the state) and writes on a daemon thread.
  * **keep**: only the newest ``keep`` steps stay on disk.

A tree is a nested dict of tensors or numpy arrays (``common.tree``).
numpy has no bfloat16, so a bf16 leaf is refused: the train state is saved
as its float32 masters (``training.steps.checkpoint_tree``), from which
restore rebuilds the bf16 parameters bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_paths, unflatten


def _to_numpy(path: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint: {path} is bfloat16, which numpy "
                            "cannot hold; save its float32 master")
        t = leaf.detach()
        # a host copy either way: a CPU tensor's numpy() would share its
        # memory with a state the caller goes on updating in place
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(path, leaf) for path, leaf in tree_paths(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.directory = directory
        self.keep = keep
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def save(self, step: int, state, extra: Optional[Dict] = None) -> str:
        flat = _flatten(state)
        return self._write(step, flat, extra or {})

    def save_async(self, step: int, state,
                   extra: Optional[Dict] = None) -> None:
        self.wait()                       # one in-flight save at a time
        flat = _flatten(state)            # synchronous host snapshot

        def work():
            try:
                self._write(step, flat, extra or {})
            except BaseException as e:    # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-{step}")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}")

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Dict) -> str:
        final = self._step_dir(step)
        if os.path.exists(os.path.join(final, "manifest.json")):
            return final                   # idempotent re-save of same step
        tmp = final + f".tmp{self.process_index}"
        os.makedirs(tmp, exist_ok=True)
        shard = os.path.join(tmp, f"shard_{self.process_index:05d}.npz")
        np.savez(shard, **{k.replace("/", "__"): v for k, v in flat.items()})
        manifest = {
            "step": step, "time": time.time(), "extra": extra,
            "arrays": sorted(flat.keys()),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)            # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and "tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template):
        """Load ``step`` into the structure of ``template`` (a tree whose
        leaves only name the paths): a tree of CPU tensors.  Raises
        ``KeyError`` when the checkpoint lacks a path of the template."""
        d = self._step_dir(step)
        flat: Dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(d)):
            if name.endswith(".npz"):
                with np.load(os.path.join(d, name)) as z:
                    for k in z.files:
                        flat[k.replace("__", "/")] = z[k]
        paths = [p for p, _ in tree_paths(template)]
        missing = [p for p in paths if p not in flat]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} arrays, e.g. "
                           f"{missing[:3]}")
        return unflatten({p: torch.from_numpy(flat[p]) for p in paths})

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)
