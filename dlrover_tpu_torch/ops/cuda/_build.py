"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each source ``dlrover_tpu_torch/csrc/<name>.cu`` becomes one shared library
with a plain C interface, ``lib<name>_<hash>.so`` in the kernel build
directory, keyed by a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.

That directory is the port's persistent compile cache (``build_dir``,
resolved at each build): an override's directory while
``directory_override`` (``jitscope.persistent_cache_override``) is active,
else ``DLROVER_TPU_COMPILE_CACHE``, else ``build/kernels`` at the root of
the checkout (``BUILD_DIR``).  ``DLROVER_TPU_COMPILE_CACHE=off`` builds
into a directory of this process's own, so nothing is reused across
processes.  ``nvcc`` only exists on
the machine with the card: a build there takes seconds, and a missing
compiler or a failed build raises.  ``nvcc``'s report (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the library
as ``<library>.log``.

Each library ``build`` resolves is reported to the registered listeners
(``add_listener``): ``(name, cached, seconds)``, ``cached`` when its
source-hash file already existed, else the seconds its nvcc ran.  The
compile observatory (``observability/jitscope.py``) counts those as
persistent-cache hits and misses.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

from dlrover_tpu_torch.common import envs

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "ring_reduce_scatter", "rdma_ring")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_listeners: List[Callable[[str, bool, float], None]] = []
_overrides: List[Path] = []  # directory_override's stack, innermost last
_private_dir: Optional[Path] = None  # DLROVER_TPU_COMPILE_CACHE=off


def build_dir() -> Path:
    """The kernel build directory a build resolves now (see the module
    docstring)."""
    global _private_dir
    if _overrides:
        return _overrides[-1]
    configured = envs.get_str("DLROVER_TPU_COMPILE_CACHE")
    if configured.lower() == "off":
        if _private_dir is None:
            _private_dir = Path(tempfile.mkdtemp(prefix="dlrover_kernels_"))
        return _private_dir
    return Path(configured) if configured else BUILD_DIR


@contextlib.contextmanager
def directory_override(path: Union[str, Path]):
    """Build into ``path`` for the duration, with an empty library memo,
    so ``load`` resolves its libraries there.  A library loaded before
    stays mapped and is not rebuilt (ctypes never unloads one): on exit
    the memo is the one from before, and what was loaded inside is
    dropped from it."""
    with _lock:
        saved = dict(_libs)
        _libs.clear()
        _overrides.append(Path(path))
    try:
        yield Path(path)
    finally:
        with _lock:
            _overrides.pop()
            _libs.clear()
            _libs.update(saved)


def add_listener(fn: Callable[[str, bool, float], None]) -> None:
    """Call ``fn(name, cached, seconds)`` for every library a later
    ``build`` resolves, in the thread that called it."""
    _listeners.append(fn)


def remove_listener(fn: Callable[[str, bool, float], None]) -> None:
    if fn in _listeners:
        _listeners.remove(fn)


def _resolved(name: str, cached: bool, seconds: float) -> None:
    for fn in list(_listeners):
        try:
            fn(name, cached, seconds)
        except Exception:  # noqa: BLE001 - a listener never fails a build
            pass


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
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one nvcc per source, all started
    together; returns ``{name: library path}``.  Raises on any failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    compiler = None
    running = []
    for name, path in paths.items():
        if path.exists():
            _resolved(name, True, 0.0)
            continue
        compiler = compiler or nvcc()
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_name(path.name + ".log"), "w")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
        running.append((name, path, tmp, log, proc, time.perf_counter()))
    failed = []
    for name, path, tmp, log, proc, t0 in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
            _resolved(name, False, time.perf_counter() - t0)
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
