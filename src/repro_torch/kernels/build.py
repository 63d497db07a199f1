"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launcher (pointers and the stream
as ``void*``, sizes as ``int``) that returns ``cudaGetLastError()``.  It is
compiled for Hopper only (``sm_90a``) into ``build/kernels/`` at the root of
the checkout, once per content hash of the sources, so a changed source
rebuilds and an unchanged one loads at once.  ``build_all`` starts one
``nvcc`` per source, all together, so the build takes as long as the
slowest file.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "paged_decode_attention",
           "ssd_scan", "rglru_scan", "rmsnorm", "flash_attention_bwd",
           "rmsnorm_bwd", "ssd_scan_bwd", "rglru_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: dict = {}                 # (name, entry) -> declared C function


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current build of ``name``, or "" if it was never built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in ``names`` (default: all sources),
    one ``nvcc`` process per source, started together.  Returns the wall
    seconds each build took (0.0 for one already built).  Raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {n: 0.0 for n in names}
    t0 = time.perf_counter()
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launchers
    size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launcher.
    PyTorch's own accessor of the raw handle where it has one (it skips
    building a ``Stream`` object: a few microseconds of every launch)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launcher(name: str, entry: str, argtypes):
    """The C function ``entry`` of ``csrc/<name>.cu``'s library (built and
    loaded on first use), with its argument types declared and ``int``
    returned."""
    with _lock:
        fn = _fns.get((name, entry))
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[(name, entry)] = fn
        return fn


def library(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use), with
    ``<name>_launch``'s argument types declared and ``int`` returned."""
    launcher(name, f"{name}_launch", argtypes)
    return _libs[name]
