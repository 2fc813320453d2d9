"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source ``dlrover_tpu_torch/csrc/<name>.cu`` becomes one shared library
with a plain C interface, ``build/kernels/lib<name>_<hash>.so`` at the root
of the checkout, keyed by a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  ``nvcc`` only exists on
the machine with the card: a build there takes seconds, and a missing
compiler or a failed build raises.  ``nvcc``'s report (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the library
as ``<library>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "ring_reduce_scatter", "rdma_ring")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from dlrover_tpu_torch/csrc on the machine with the card"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one nvcc per source, all started
    together; returns ``{name: library path}``.  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    compiler = None
    running = []
    for name, path in paths.items():
        if path.exists():
            continue
        compiler = compiler or nvcc()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_name(path.name + ".log"), "w")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running.append((name, path, tmp, log, proc))
    failed = []
    for name, path, tmp, log, proc in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        details = "\n".join(
            paths[name].with_name(paths[name].name + ".log").read_text()
            for name in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")
    return paths


def build_log(name: str) -> str:
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
