"""The port's PNG reader and writer: the standard library's ``zlib`` and a
small C++ unfilter of its own (``csrc/png_unfilter.cpp``), so that images
are read where neither PIL, OpenCV nor libpng is installed.

``read(path)`` parses the chunks in Python, checks every chunk's CRC with
``zlib.crc32``, inflates the joined IDAT with ``zlib.decompress`` and
undoes the scanline filters with ``unfilter`` (both release the GIL, so
decode threads run in parallel).  It reads 8-bit, non-interlaced PNGs of
colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
(RGBA); ``PngImage.pixels`` is the array PIL gives for the file
(``np.array(Image.open(path))``: palette indices for type 3) and
``PngImage.rgb()`` the colour planes OpenCV reads (the palette looked
up, gray repeated, alpha dropped).  Another bit depth or an interlaced
file raises ``UserError`` naming the file and its IHDR; a bad CRC, a
truncated file or a broken stream raises ``PngError``.  ``png_size``
reads only the signature and the IHDR chunk, so it gives the size of any
valid PNG, 16-bit and interlaced ones too, as PIL's ``Image.open(path)
.size`` does.

``write_png(path, u8)`` chooses each row's filter by the least sum of
absolute differences (bytes read as signed), as libpng's heuristic does,
and compresses with zlib at level 6 (strategy ``Z_FILTERED``, as libpng
compresses filtered rows); every filter is a numpy difference of
the original rows, so writing needs no C.

The unfilter is built with g++ (``$CXX``, else ``g++`` on ``PATH``) at
first use into ``build/kernels/libpng_unfilter_<hash>.so`` under the
repository root, the hash covering the source and the flags, and loaded
with ctypes.  A failed build raises with the compiler's first error line:
there is no other decoder to fall back to.  ``unfilter_plain`` is the
same arithmetic in numpy and Python, for the tests.
"""

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import threading
import typing
import zlib

import numpy as np

from ..utils.errors import UserError

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "png_unfilter.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
# no -march=native: the build directory may be copied to another machine
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel by colour type (8-bit samples: bytes a pixel)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# zlib level of the writer (PIL's and libpng's default)
LEVEL = 6

_lib = None
_lock = threading.Lock()


class PngError(ValueError):
    """A file that is not a well-formed PNG: bad signature or CRC,
    truncated, or a broken zlib stream."""


@dataclasses.dataclass
class PngImage:
    """One decoded PNG.

    pixels:     uint8 [H, W] (one sample a pixel) or [H, W, C], as PIL's
                ``np.array(Image.open(path))``: palette indices for
                colour type 3
    color_type: the IHDR colour type (0, 2, 3, 4 or 6)
    palette:    uint8 [N, 3] for colour type 3, else None
    """

    pixels: np.ndarray
    color_type: int
    palette: typing.Optional[np.ndarray] = None

    def rgb(self) -> np.ndarray:
        """uint8 [H, W, 3] R, G, B as OpenCV reads the file: gray
        repeated, the palette looked up, alpha dropped (not composited)."""
        x = self.pixels
        if self.color_type == 3:
            if x.size and int(x.max()) >= len(self.palette):
                raise PngError(f"palette index {int(x.max())} beyond the "
                               f"{len(self.palette)}-entry palette")
            return self.palette[x]
        if x.ndim == 2:
            x = x[..., None]
        if self.color_type in (0, 4):
            return np.repeat(x[..., :1], 3, axis=-1)
        return np.ascontiguousarray(x[..., :3])


# --------------------------------------------------------------------- build

def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpng_unfilter_{digest}.so"


def _build(so: pathlib.Path):
    """Build ``so`` under a temporary name, renamed when g++ succeeds;
    raise with the compiler's first error line when it does not."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            "g++ not found ($CXX, else g++ on PATH): the PNG unfilter of "
            f"wsunet_tpu_torch is built from {SOURCE} at first use")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = (proc.stderr or proc.stdout).splitlines()
        first = next((ln for ln in lines if "error" in ln),
                     lines[0] if lines else f"exit {proc.returncode}")
        raise RuntimeError(f"g++ failed to build {SOURCE.name}: {first}")
    os.replace(tmp, so)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.ws_png_unfilter_batch.argtypes = [
                ctypes.c_int, u8pp, u8pp, i32p, i32p, i32p, i32p]
            lib.ws_png_unfilter_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


# ------------------------------------------------------------------ unfilter

def unfilter(scans: typing.Sequence[bytearray],
             shapes: typing.Sequence[typing.Tuple[int, int, int]]
             ) -> typing.List[np.ndarray]:
    """Undo the scanline filters of inflated IDAT streams: ``scans[k]``
    holds ``h`` rows of one filter byte and ``w * bpp`` bytes, for
    ``shapes[k] = (h, w, bpp)``; the result is uint8 [h, w * bpp] each.
    One C call for the batch (the GIL released); the scans are modified in
    place.  A filter byte above 4 raises ``PngError``."""
    lib = _load()
    n = len(scans)
    outs, bufs = [], []
    for scan, (h, w, bpp) in zip(scans, shapes):
        if len(scan) != h * (1 + w * bpp):
            raise ValueError(f"scan of {len(scan)} bytes for {h}x{w}x{bpp}")
        outs.append(np.empty((h, w * bpp), np.uint8))
        bufs.append((ctypes.c_uint8 * len(scan)).from_buffer(scan))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    scan_ptrs = (u8p * n)(*[ctypes.cast(b, u8p) for b in bufs])
    out_ptrs = (u8p * n)(*[o.ctypes.data_as(u8p) for o in outs])
    dims = np.array(shapes, np.int32).reshape(n, 3)
    hs, ws, bpps = (np.ascontiguousarray(dims[:, i]) for i in range(3))
    status = np.zeros(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ws_png_unfilter_batch(
        n, scan_ptrs, out_ptrs, hs.ctypes.data_as(i32p),
        ws.ctypes.data_as(i32p), bpps.ctypes.data_as(i32p),
        status.ctypes.data_as(i32p))
    if status.any():
        raise PngError(f"bad filter type in stream {int(np.argmax(status))}")
    return outs


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(scan: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """``unfilter``'s arithmetic, row by row in numpy and Python (slow:
    for the tests)."""
    stride = w * bpp
    rows = np.frombuffer(bytes(scan), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        cur = np.zeros(stride, np.int64)
        if f == 0:
            cur = x
        elif f == 2:
            cur = (x + prev) & 255
        elif f in (1, 3, 4):
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                pred = a if f == 1 else (a + b) >> 1 if f == 3 else \
                    _paeth(a, b, c)
                cur[i] = (int(x[i]) + pred) & 255
        else:
            raise PngError(f"bad filter type {f}")
        out[y] = cur
        prev = cur
    return out


# -------------------------------------------------------------------- reader

def _chunks(data: bytes, path) -> typing.Iterator[typing.Tuple[bytes, bytes]]:
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise PngError(f"{path}: not a PNG file (bad signature)")
    off = 8
    while True:
        if off + 12 > len(data):
            raise PngError(f"{path}: truncated (no IEND chunk)")
        length, = struct.unpack(">I", data[off:off + 4])
        end = off + 12 + length
        if end > len(data):
            raise PngError(f"{path}: truncated inside a chunk")
        kind = data[off + 4:off + 8]
        body = data[off + 8:end - 4]
        crc, = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise PngError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        off = end


def read(path) -> PngImage:
    """Decode the PNG file ``path`` (see the module's docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = _chunks(data, path)
    kind, ihdr = next(chunks)
    if kind != b"IHDR" or len(ihdr) != 13:
        raise PngError(f"{path}: the first chunk is not IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if depth != 8 or interlace != 0 or ctype not in CHANNELS:
        raise UserError(
            f"{path}: unsupported PNG (IHDR: {w}x{h}, bit depth {depth}, "
            f"colour type {ctype}, interlace {interlace}); the reader takes "
            "8-bit non-interlaced gray, RGB, palette, gray+alpha and RGBA")
    if comp != 0 or filt != 0 or w == 0 or h == 0:
        raise PngError(f"{path}: bad IHDR ({w}x{h}, compression {comp}, "
                       f"filter method {filt})")
    idat, palette = [], None
    for kind, body in chunks:
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
    if ctype == 3 and palette is None:
        raise PngError(f"{path}: palette image without PLTE")
    bpp = CHANNELS[ctype]
    need = h * (1 + w * bpp)
    try:
        scan = zlib.decompress(b"".join(idat), bufsize=need)
    except zlib.error as e:
        raise PngError(f"{path}: {e}") from None
    if len(scan) < need:
        raise PngError(f"{path}: {len(scan)} bytes of image data, "
                       f"{need} needed")
    pixels = unfilter([bytearray(scan[:need])], [(h, w, bpp)])[0]
    pixels = pixels.reshape(h, w) if bpp == 1 else pixels.reshape(h, w, bpp)
    return PngImage(pixels=pixels, color_type=ctype,
                    palette=palette if ctype == 3 else None)


def png_size(path) -> typing.Tuple[int, int]:
    """(width, height) of the PNG file ``path`` from its IHDR chunk alone
    (its CRC checked), whatever its bit depth, colour type or
    interlacing."""
    with open(path, "rb") as f:
        head = f.read(33)
    kind, ihdr = next(_chunks(head, path))
    if kind != b"IHDR" or len(ihdr) != 13:
        raise PngError(f"{path}: the first chunk is not IHDR")
    w, h = struct.unpack(">II", ihdr[:8])
    if w == 0 or h == 0:
        raise PngError(f"{path}: bad IHDR ({w}x{h})")
    return w, h


def read_png(path) -> np.ndarray:
    """The pixels of the PNG file ``path``, as PIL's
    ``np.array(Image.open(path))``."""
    return read(path).pixels


# -------------------------------------------------------------------- writer

def filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The five filtered forms (None, Sub, Up, Average, Paeth) of every
    row of ``raw`` (uint8 [H, W * bpp]): uint8 [5, H, W * bpp]."""
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    return (out & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body)))


def encode(filtered: np.ndarray, filters: np.ndarray, h: int, w: int,
           color_type: int) -> bytes:
    """The PNG file of 8-bit rows already filtered: ``filtered`` uint8
    [H, W * bpp], ``filters`` the filter type of each row."""
    scan = np.concatenate([filters.astype(np.uint8)[:, None], filtered],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # libpng's stream settings for filtered rows: Z_FILTERED, memLevel 8
    z = zlib.compressobj(LEVEL, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    idat = z.compress(scan.tobytes()) + z.flush()
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) +
            _chunk(b"IEND", b""))


def write_png(path, u8: np.ndarray):
    """Write uint8 [H, W] (gray), or [H, W, C] with C 1, 2, 3 or 4 (gray,
    gray + alpha, RGB, RGBA), as an 8-bit PNG; each row takes the filter
    with the least sum of absolute (signed) differences."""
    x = np.asarray(u8)
    if x.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {x.dtype}")
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim != 3 or x.shape[-1] not in (1, 2, 3, 4) or not x.size:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4] pixels, "
                         f"got {tuple(np.shape(u8))}")
    h, w, bpp = x.shape
    cand = filter_rows(np.ascontiguousarray(x).reshape(h, w * bpp), bpp)
    signed = cand.view(np.int8).astype(np.int32)
    best = np.abs(signed).sum(axis=2).argmin(axis=0)
    rows = cand[best, np.arange(h)]
    data = encode(rows, best, h, w, {1: 0, 2: 4, 3: 2, 4: 6}[bpp])
    with open(path, "wb") as f:
        f.write(data)
