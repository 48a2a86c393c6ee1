"""The benchmark's own inputs, made from a seed: grayscale covers, their
LSB-replacement stego, PNG files of both, and the catalog paths that link
to them.

Covers are mosaics of real photographs: ``covers/tiles.npz`` holds 16
grayscale 256 x 256 tiles (the quadrants of four covers of ws-unet's
reference dataset, the repository's ``data_ablation/p256/images``, kept
here so the yardstick does not move with them), and each cover puts four
of them, drawn with their flips and turns from the seed, in a 2 x 2
mosaic.  So they compress and decode as photographs do, and the trained
detector reads them as it reads its own data, not as noise it saturates
on.  Each image's generator is seeded from (seed, stream, index) alone,
so the same seed gives the same pixels whatever else a cell makes.

The PNG writer is the benchmark's own (stdlib ``zlib``, level 6, a filter
chosen per row by the smallest sum of absolute filtered bytes, as libpng's
default heuristic chooses), so the program's reader is fed files it did
not write.
"""

import concurrent.futures
import functools
import os
import pathlib
import struct
import zlib

import numpy as np

TILES = pathlib.Path(__file__).resolve().parents[1] / "covers" / "tiles.npz"


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's inputs: the run's seed (any
    whole number, taken modulo 2^64) and the stream's own numbers."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, *stream]))


@functools.lru_cache(maxsize=1)
def tiles() -> np.ndarray:
    """The 16 committed grayscale tiles, uint8 [16, 256, 256]."""
    with np.load(TILES) as z:
        return z["tiles"]


def cover(seed: int, index: int, side: int) -> np.ndarray:
    """One uint8 [side, side] cover: a 2 x 2 mosaic of tiles drawn with
    replacement, each flipped and turned at random and, for a side under
    512, cut to side / 2 at a random offset."""
    g = rng(seed, 1, index)
    t = tiles()
    half = side // 2
    parts = []
    for _ in range(4):
        tile = t[g.integers(len(t))]
        if g.random() < 0.5:
            tile = tile[:, ::-1]
        tile = np.rot90(tile, int(g.integers(4)))
        oy, ox = g.integers(0, tile.shape[0] - half + 1, 2)
        parts.append(tile[oy:oy + half, ox:ox + half])
    return np.ascontiguousarray(np.block([parts[:2], parts[2:]]))


def lsbr(x: np.ndarray, alpha: float, seed: int, index: int) -> np.ndarray:
    """LSB replacement at rate ``alpha``: each pixel, with probability
    alpha, takes a fresh random bit as its LSB (so about alpha / 2 of the
    pixels change)."""
    g = rng(seed, 2, index, int(round(alpha * 1e6)))
    embed = g.random(x.shape) < alpha
    bits = g.integers(0, 2, x.shape, dtype=np.uint8)
    return np.where(embed, (x & 0xFE) | bits, x).astype(np.uint8)


def _filtered(img: np.ndarray) -> np.ndarray:
    """The five PNG filters of every row of an 8-bit grayscale image,
    [5, H, W] uint8 (None, Sub, Up, Average, Paeth)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth])
    return (out & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of a uint8 [H, W] image."""
    h, w = img.shape
    cand = _filtered(img)
    signed = cand.astype(np.int8).astype(np.int32)
    choice = np.abs(signed).sum(axis=2).argmin(axis=0)
    rows = cand[choice, np.arange(h)]
    raw = np.concatenate([choice.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_pngs(root: pathlib.Path, files: dict, threads: int = 8) -> None:
    """Write {relative path: uint8 image} as PNG files under ``root``
    (zlib releases the GIL, so the threads compress at once)."""
    root = pathlib.Path(root)
    for rel in files:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)

    def one(item):
        rel, img = item
        (root / rel).write_bytes(encode_png(img))

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, files.items()))


def link(root: pathlib.Path, name: str, target: str) -> None:
    """Make the catalog path ``name`` a hard link to the file ``target``
    (both relative to ``root``): the program's caches key by path, so each
    link is an image of its own to them, and no bytes are copied."""
    dst = pathlib.Path(root) / name
    dst.parent.mkdir(parents=True, exist_ok=True)
    os.link(pathlib.Path(root) / target, dst)
