"""The one loader of the port's hand-written CUDA kernels.

On first use, every ``.cu`` file under ``repro_torch/csrc`` is compiled by
``nvcc`` into a shared library with a plain C interface (one ``nvcc`` per
source, all started together) and loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source, the shared ``.cuh`` headers beside it and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. ``nvcc``'s own output, including the
``-Xptxas=-v`` register and spill report, is kept beside each library as
``<name>.log``.

Nothing here runs at import time: a machine without ``nvcc`` (a CPU-only test
machine) imports the port freely and only fails if it asks for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "compiled on first use on a machine with the CUDA toolkit"
        )
    return found


def _target(src: Path) -> Path:
    # the shared headers are hashed into every source's name: an edited
    # header rebuilds whatever includes it
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return name -> path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: st for name, st in targets.items() if not st[1].exists()}
    nvcc = nvcc_path() if todo else ""
    procs = {}
    for name, (src, so) in todo.items():
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, so, log,
        )
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(
            f"--- {n}.log ---\n{(BUILD_DIR / f'{n}.log').read_text()[-4000:]}"
            for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return {name: so for name, (_, so) in targets.items()}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built (by :func:`build_all`)."""
    return _target(CSRC / f"{name}.cu")


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` from the build that made it."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if not _libs:
            for lib_name, so in build_all().items():
                _libs[lib_name] = ctypes.CDLL(str(so))
        return _libs[name]
