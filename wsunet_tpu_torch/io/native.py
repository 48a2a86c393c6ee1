"""ctypes binding to the native PNG decoder (port of
``wsunet_tpu/io/native.py``).

The source is the repository's ``native/wsdata.cpp`` (libpng, with
libdeflate and zlib).  The first use builds it with g++ into
``build/native/libwsdata_<hash>.so`` under the repository root (the hash
covers the source and the flags; never into ``native/``), and loads it
with ctypes; a library that is there but does not load (built on another
machine) is built again.  The batch call releases the GIL and decodes
with its own thread pool.  Where it does not build (no g++, libpng or
libdeflate), ``available()`` is false, ``build_error()`` says why, and the data
pipeline decodes with PIL instead: the decoder is host I/O, not a kernel.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "wsdata.cpp"
BUILD_DIR = REPO / "build" / "native"
# no -march=native: the build directory may be copied to another machine
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lpng", "-ldeflate", "-lz", "-lpthread"]

_lib = None
_error = None
_tried = False
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libwsdata_{digest}.so"


def _build(so: pathlib.Path) -> str:
    """Build ``so`` (under a temporary name, renamed on success); return
    '' or the compiler's output."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return "g++ not found"
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                               *LIBS], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (proc.stderr or proc.stdout or
                f"exit {proc.returncode}").strip()
    os.replace(tmp, so)
    return ""


def _load():
    global _lib, _error, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            _error = f"{SOURCE} not found"
            return None
        so = library_path()
        lib = None
        if so.exists():
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                lib = None   # built elsewhere, against libraries not here
        if lib is None:
            err = _build(so)
            if err:
                _error = err
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                _error = str(e)
                return None
        lib.ws_png_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.ws_png_probe.restype = ctypes.c_int
        for fn in (lib.ws_png_decode_gray_batch,
                   lib.ws_png_decode_rgby_batch):
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the decoder built and loaded (builds it at the first call)."""
    return _load() is not None


def build_error() -> str:
    """Why the decoder is unavailable ('' when it loaded)."""
    _load()
    return _error or ""


def probe(path) -> tuple:
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ws_png_probe(str(path).encode(), ctypes.byref(h),
                        ctypes.byref(w)) != 0:
        raise FileNotFoundError(path)
    return h.value, w.value


def _decode_batch(paths, threads: int, fn_name: str, channels: int):
    """Decode same-sized PNGs with the batch call ``fn_name`` into a list
    of [H, W] (``channels`` 1) or [H, W, channels] uint8 arrays, or None if
    the native path cannot serve this batch (the caller uses PIL)."""
    lib = _load()
    if lib is None or not paths:
        return None
    try:
        h, w = probe(paths[0])
    except FileNotFoundError:
        return None
    if h <= 0 or w <= 0 or h * w > 1 << 28:
        # a corrupt header can claim absurd dimensions; PIL, with its own
        # decompression-bomb guard, takes such a batch
        return None
    shape = (len(paths), h, w) + ((channels,) if channels > 1 else ())
    try:
        out = np.empty(shape, dtype=np.uint8)
    except MemoryError:
        return None
    c_paths = (ctypes.c_char_p * len(paths))(
        *[str(p).encode() for p in paths])
    failures = getattr(lib, fn_name)(
        c_paths, len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, threads)
    if failures != 0:
        return None
    return list(out)


def decode_gray_batch(paths, threads: int = 8):
    """Decode same-sized PNGs into a list of [H, W] uint8 arrays, or None
    if the native path cannot serve this batch (the caller uses PIL)."""
    return _decode_batch(paths, threads, "ws_png_decode_gray_batch", 1)


def decode_rgby_batch(paths, threads: int = 8):
    """Decode same-sized PNGs into a list of [H, W, 4] uint8 arrays, planes
    R, G, B, Y (``io.imread4_u8``'s layout), or None if the native path
    cannot serve this batch (the caller uses PIL)."""
    return _decode_batch(paths, threads, "ws_png_decode_rgby_batch", 4)
