"""Batched host-side input pipeline (port of
``wsunet_tpu/data/pipeline.py``).

Image names (the ``name`` column of catalog rows) become fixed-size padded
uint8 batches with a validity mask:
the tail batch repeats its first image, and an image that fails to decode
is a zero image with its mask False (the sweeps turn it into a NaN row).
Decoding runs in a background thread one or more batches ahead
(``prefetch``), each batch decoded by a pool of ``threads`` threads with
the port's PNG reader (``io.png``: stdlib zlib and its own unfilter, both
outside the GIL) on every machine; the JAX package's native decoder
(``io.native``) is used only where ``force_native(True)`` asks for it.

Two caches, both keyed by path and bounded by bytes:

- the decode cache (``cache=True``): decoded images, on the host; the
  sweeps decode the same catalog once per (model, method, alpha);
- the device cache (``device_cache=True``): whole padded batches as torch
  tensors on the device, so a sweep's later passes start at the device.
  A batch with a failed decode is never cached.

The pipeline takes a list of image names (a catalog table's ``name``
column); ``sweep_batches`` maps a per-batch step over it
and gives NaN rows where a decode failed.  Under a process group it is
rank-sharded (``parallel.eval_shard``): each rank sweeps its own rows and
the rows are all-gathered back into order; the device cache is then off.

Every batch yields fresh numpy pixels (``np.stack`` copies out of the
decode cache), so a batch handed out is never overwritten by a later one.
Device uploads (the device cache's) happen in the consuming thread, through
the device's two pinned buffers (``_device.to_device``).
"""

import concurrent.futures as _futures
import dataclasses
import os
import pathlib
import threading
import typing

import numpy as np

from .._device import resolve_device, to_device
from ..io.imread import imread_gray_u8
from ..utils.errors import UserError
from .catalog import resolve_path


@dataclasses.dataclass
class Batch:
    """One padded batch of decoded images.

    pixels: [B, H, W] uint8 luminance (numpy, or a torch tensor on the
            device when it came from the device cache)
    mask:   [B] bool, True for real rows, False for padding and failures
    names:  the image names of the real entries
    """

    pixels: typing.Any
    mask: np.ndarray
    names: typing.List[str]


_DECODE_CACHE: dict = {}
_DECODE_CACHE_BYTES = 0
_DECODE_CACHE_BUDGET = 1 << 30   # 1 GiB of decoded pixels
# two prefetch workers may insert at once: the budget check and the byte
# counter are updated under one lock
_DECODE_CACHE_LOCK = threading.Lock()

_DEVICE_CACHE: dict = {}
_DEVICE_CACHE_BYTES = 0
_DEVICE_CACHE_BUDGET = 256 << 20  # 256 MiB of device memory


def clear_decode_cache():
    global _DECODE_CACHE_BYTES, _DEVICE_CACHE_BYTES
    with _DECODE_CACHE_LOCK:
        _DECODE_CACHE.clear()
        _DECODE_CACHE_BYTES = 0
        _DEVICE_CACHE.clear()
        _DEVICE_CACHE_BYTES = 0


def clear_device_cache():
    """Release the device memory of cached batches; the host decode cache
    stays."""
    global _DEVICE_CACHE_BYTES
    with _DECODE_CACHE_LOCK:
        _DEVICE_CACHE.clear()
        _DEVICE_CACHE_BYTES = 0


_FORCE_NATIVE = False


def force_native(enabled):
    """Decode through ``io.native``'s batch calls (``True``; the bench
    compares it with the port's reader), or through the reader given
    (``False`` or ``None``: ``io.png``, the default).  The native decoder
    needs libpng and libdeflate; forced where it does not build, a decode
    raises."""
    global _FORCE_NATIVE
    _FORCE_NATIVE = bool(enabled)


def _decode_native(paths, reader, threads: int) -> typing.List[np.ndarray]:
    """``io.native``'s batch call for ``reader``'s layout; a batch with a
    failed image is decoded one image a call, a failure giving None."""
    from ..io import native

    if not native.available():
        raise RuntimeError(f"io.native was forced but does not build: "
                           f"{native.build_error()}")
    batch_call = getattr(native, {
        "imread_gray_u8": "decode_gray_batch",
        "imread4_u8": "decode_rgby_batch"}[reader.__name__])
    out = batch_call([str(p) for p in paths], threads)
    if out is None:
        out = [(batch_call([str(p)], 1) or [None])[0] for p in paths]
    return out


def _decode_many(paths, reader, threads: int,
                 cache: bool = False) -> typing.List[np.ndarray]:
    """Decode every path with ``reader`` in a pool of ``threads`` threads
    (``io.png`` releases the GIL while it inflates and unfilters); a file
    that fails to decode gives None.  ``UserError`` (a format the reader
    does not take) is raised, not turned into a failed image."""
    global _DECODE_CACHE_BYTES
    # more decode threads than cores is a loss from contention alone
    threads = max(1, min(threads, os.cpu_count() or 1))
    if cache:
        keys = [(str(p), reader.__name__) for p in paths]
        with _DECODE_CACHE_LOCK:
            missing = [p for p, k in zip(paths, keys)
                       if k not in _DECODE_CACHE]
        if missing:
            decoded = _decode_many(missing, reader, threads, cache=False)
            lookup = {(str(p), reader.__name__): d
                      for p, d in zip(missing, decoded)}
            with _DECODE_CACHE_LOCK:
                # failures are never cached: a transient error would drop
                # the image from every later configuration
                fresh = {k: d for k, d in lookup.items()
                         if k not in _DECODE_CACHE and d is not None}
                new_bytes = sum(d.nbytes for d in fresh.values())
                if _DECODE_CACHE_BYTES + new_bytes <= _DECODE_CACHE_BUDGET:
                    _DECODE_CACHE.update(fresh)
                    _DECODE_CACHE_BYTES += new_bytes
            return [_DECODE_CACHE.get(k, lookup.get(k)) for k in keys]
        return [_DECODE_CACHE[k] for k in keys]
    if _FORCE_NATIVE and paths:
        return _decode_native(paths, reader, threads)

    def safe(p):
        try:
            return reader(p)
        except UserError:
            raise
        except Exception:
            return None

    if threads <= 1 or len(paths) <= 1:
        return [safe(p) for p in paths]
    with _futures.ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(safe, paths))


def load_images(root: pathlib.Path, names: typing.Sequence[str],
                reader: typing.Callable = imread_gray_u8,
                threads: int = 8) -> np.ndarray:
    """Decode ``names`` under ``root`` into one stacked array."""
    paths = [resolve_path(root, n) for n in names]
    return np.stack(_decode_many(paths, reader, threads))


def iterate_batches(
    root: pathlib.Path,
    names: typing.Sequence[str],
    batch_size: int,
    reader: typing.Callable = imread_gray_u8,
    threads: int = 8,
    prefetch: int = 1,
    cache: bool = False,
    device_cache: bool = False,
    device=None,
    allow_empty: bool = False,
) -> typing.Iterator[Batch]:
    """Fixed-size padded ``Batch``es over the images ``names`` under
    ``root`` (catalog rows: ``list(df["name"])``), decoded in the
    background ``prefetch`` batches ahead.  With ``device_cache=True`` a
    batch without failed decodes is also kept on ``device`` (None = CUDA)
    as a torch tensor, and a later pass over the same rows yields that
    tensor.  Images are taken as immutable for the process's lifetime
    (the caches key by path); ``clear_decode_cache()`` forgets them.  A
    batch with no decodable image raises ``FileNotFoundError``, or with
    ``allow_empty`` gives ``pixels=None`` and an all-False mask."""
    from ..parallel.eval_shard import cache_on_device

    names = list(names)
    n = len(names)
    if n == 0:
        return
    # under ranks the device cache is off, as the JAX package's
    # multi-process sweeps disable theirs
    device_cache = device_cache and cache_on_device()
    dev = resolve_device(device) if device_cache else None
    reader_name = getattr(reader, "__name__", repr(reader))

    def dkey(chunk):
        return (str(root), reader_name, batch_size, tuple(chunk), str(dev))

    def make(start: int) -> Batch:
        chunk = names[start:start + batch_size]
        if device_cache:
            with _DECODE_CACHE_LOCK:
                hit = _DEVICE_CACHE.get(dkey(chunk))
            if hit is not None:
                return Batch(pixels=hit[0], mask=hit[1].copy(), names=chunk)
        paths = [resolve_path(root, nm) for nm in chunk]
        decoded = _decode_many(paths, reader, threads, cache=cache)
        mask = np.ones(batch_size, dtype=bool)
        template = next((d for d in decoded if d is not None), None)
        if template is None and allow_empty:
            return Batch(pixels=None, mask=np.zeros(batch_size, dtype=bool),
                         names=chunk)
        if template is None:
            raise FileNotFoundError(
                f"no decodable image among {chunk[:3]}...")
        imgs = []
        for i, d in enumerate(decoded):
            if d is None:
                mask[i] = False
                d = np.zeros_like(template)
            imgs.append(d)
        pixels = np.stack(imgs)
        pad = batch_size - len(chunk)
        if pad:
            pixels = np.concatenate(
                [pixels, np.repeat(pixels[:1], pad, axis=0)], axis=0)
            mask[len(chunk):] = False
        return Batch(pixels=pixels, mask=mask, names=chunk)

    def to_cache(batch: Batch) -> Batch:
        """Upload a complete host batch (in this, the consuming thread)
        and keep it, within the budget."""
        global _DEVICE_CACHE_BYTES
        n_real = len(batch.names)
        if not isinstance(batch.pixels, np.ndarray) or \
                not bool(batch.mask[:n_real].all()):
            return batch
        x = to_device(batch.pixels, dev)
        key = dkey(batch.names)
        with _DECODE_CACHE_LOCK:
            if key not in _DEVICE_CACHE and \
                    _DEVICE_CACHE_BYTES + batch.pixels.nbytes \
                    <= _DEVICE_CACHE_BUDGET:
                _DEVICE_CACHE[key] = (x, batch.mask.copy())
                _DEVICE_CACHE_BYTES += batch.pixels.nbytes
        return Batch(pixels=x, mask=batch.mask, names=batch.names)

    starts = list(range(0, n, batch_size))
    with _futures.ThreadPoolExecutor(max_workers=max(1, prefetch)) as pool:
        pending = [pool.submit(make, s) for s in starts[:1 + prefetch]]
        next_idx = len(pending)
        while pending:
            batch = pending.pop(0).result()
            if next_idx < len(starts):
                pending.append(pool.submit(make, starts[next_idx]))
                next_idx += 1
            yield to_cache(batch) if device_cache else batch


def sweep_batches(root: pathlib.Path, names: typing.Sequence[str],
                  step: typing.Callable, batch_size: int, threads: int = 8,
                  device_cache: bool = False, device=None,
                  reader: typing.Callable = imread_gray_u8) -> np.ndarray:
    """``step`` over the padded batches of ``names`` (decoded once per
    process, ``cache=True``): ``step(pixels)`` gives a tuple of [B]
    tensors, and the result is float64 [len(names), len(tuple)], one row an
    image in order, NaN where the image failed to decode.

    Under a process group each rank runs ``step`` on batches of
    ``batch_size`` of its own strided rows (``parallel.host_shard``; the
    device cache off) and every rank gets every row back in order
    (``parallel.allgather_rows``); at a world of one the sweep is the
    process's own."""
    from ..parallel import allgather_rows, host_shard

    names = list(names)
    if not names:
        return np.zeros((0, 0))
    local, n_true = host_shard(names)
    outs = []
    for batch in iterate_batches(root, local, batch_size,
                                 reader=reader, threads=threads, prefetch=2,
                                 cache=True, device_cache=device_cache,
                                 device=device):
        outs.append((step(batch.pixels), batch.mask[:len(batch.names)]))
    rows = []
    for vals, mask in outs:
        v = np.stack([t.cpu().numpy()[:len(mask)] for t in vals], axis=1)
        v = v.astype("float64")
        v[~mask] = np.nan
        rows.append(v)
    return allgather_rows(np.concatenate(rows)[:n_true], len(names))
