"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

A source ``wsunet_tpu_torch/csrc/<name>.cu`` with a plain C interface (no
PyTorch header) is compiled at its first use (several sources at once in
parallel, ``load_all``) into
``build/kernels/lib<name>_<hash>.so`` under the repository root, where the
hash covers the source and the flags, so an edited source never loads a
stale library.  ``nvcc`` is taken from ``$CUDA_HOME/bin``, else
``/usr/local/cuda/bin``, else ``PATH``.  A missing ``nvcc`` or a failed
build raises with nvcc's output: there is no fallback to another
implementation.

Nothing here runs at import; the CPU tests import this module on machines
without ``nvcc``.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_HOME = "/usr/local/cuda"

# name -> (loaded library, build seconds or 0.0 when the .so existed,
# nvcc's output); filled under the lock at the first load of each name
_loaded = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, "
            f"{DEFAULT_CUDA_HOME}/bin and PATH): the CUDA kernels of "
            "wsunet_tpu_torch are built from source at first use and need "
            "the CUDA toolkit")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries
    a hash of the source and the flags."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str, so: pathlib.Path) -> tuple:
    """Start nvcc on ``csrc/<name>.cu``, writing ``so`` under a temporary
    name (renamed when the build succeeds, so a concurrent build never
    loads half a file)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return cmd, proc, tmp, time.perf_counter()


def load_all(names) -> dict:
    """The loaded libraries of ``csrc/<name>.cu`` for each name, by name.
    Those not yet built are built in parallel: one nvcc each, all started
    together.  A failed build raises with nvcc's output, after every
    started build has ended."""
    with _lock:
        jobs = {}
        for name in dict.fromkeys(names):
            if name in _loaded:
                continue
            so = library_path(name)
            if so.exists():
                _loaded[name] = (ctypes.CDLL(str(so)), 0.0, "")
            else:
                jobs[name] = (so, *_start(name, so))
        failed = []
        for name, (so, cmd, proc, tmp, t0) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(
                    f"nvcc failed to build {name} (exit {proc.returncode}):"
                    f"\n{' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, so)
            _loaded[name] = (ctypes.CDLL(str(so)), time.perf_counter() - t0,
                             log)
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: _loaded[name][0] for name in names}


def build_info(name: str) -> dict:
    """Build seconds (0.0 if the library was already on disk) and nvcc's
    output (``-Xptxas -v``: registers, shared memory, spills) of a loaded
    library."""
    _, seconds, log = _loaded[name]
    return {"seconds": seconds, "log": log}
