"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``build/repro_torch/lib<name>-<hash>.so`` (a plain C interface, loaded with
:mod:`ctypes`), at first use.  The hash covers the source and the flags, so
an edited source rebuilds and an unchanged one is reused.  :func:`build`
starts one ``nvcc`` per missing library, all at once, and then waits for
them.  Nothing here runs at import time: the CPU tests import every module
of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

#: library name -> source file under ``csrc/``
SOURCES = {
    "spmv_ell": "spmv_ell.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: ``<checkout>/build/repro_torch``; listed in ``.gitignore``
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every library in ``names`` (default: all) that is missing.

    Returns ``{name: {"seconds": s, "log": nvcc stderr}}`` for the libraries
    compiled by this call; raises ``RuntimeError`` if any compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    done = {}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": seconds, "log": stdout + stderr}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
