"""One-image-at-a-time U-Net WS serving (port of ``wsunet_tpu/serve.py``).

- The conv stack runs in ``compute_dtype`` (bf16 by default, from a copy
  of the model cast once at construction); the WS reduction stays f32:
  the predictor feeding a change-rate estimate must not lose mantissa in
  the residual.
- The weights stay on the device across requests.
- ``predict_many`` keeps ``depth`` requests in flight: each image is
  copied into a pinned host buffer, sent with an asynchronous copy, and
  its step and result copy are queued on the current stream; only taking
  the oldest result waits.  CUDA launches return before the work is
  done, which takes the place of JAX's asynchronous dispatch.

``rtt_floor_ms`` is the time of one empty launch and synchronize, measured
the same way as the serving step.
"""

import collections
import copy
import pathlib
import time
import typing

import numpy as np
import torch

from ._device import resolve_device
from .io import imread_gray_u8
from .ops.ws import ws_estimate_unet
from .utils.errors import UserError


class _Pending:
    """One request in flight: its result lies in a (pinned) host tensor
    once ``event`` has completed (no event on the CPU: already done)."""

    def __init__(self, host: torch.Tensor, event):
        self.host, self.event = host, event

    def result(self) -> typing.Tuple[float, float]:
        if self.event is not None:
            self.event.synchronize()
        beta, l1 = self.host.tolist()
        return beta, l1


class UNetWSServer:
    """WS estimation service over a U-Net.

    ``predict(image_u8)`` returns ``(beta_hat, l1)`` floats for a single
    [size, size] uint8 grayscale image.  ``device=None`` means CUDA.
    """

    def __init__(self, model, size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.size = size
        self.model = copy.deepcopy(model).to(
            device=self.device, dtype=compute_dtype).eval()
        self.model.compute_dtype = compute_dtype
        self._cuda = self.device.type == "cuda"
        self._slots = []
        # warm up at the serving shape so the first request is not the
        # one that selects cuDNN's algorithms
        self.predict(np.zeros((size, size), np.uint8))

    @torch.no_grad()
    def _step(self, x_u8: torch.Tensor) -> torch.Tensor:
        """[1, H, W] uint8 on the device -> [2] f32 (beta_hat, l1)."""
        x = x_u8.to(torch.float32)
        y = self.model((x / 255.0)[:, None])
        x_hat = y[:, 0, 1:-1, 1:-1].to(torch.float32) * 255.0
        beta, l1 = ws_estimate_unet(x, x_hat)
        return torch.stack([beta[0], l1[0]])

    def _submit(self, image_u8: np.ndarray, slot: int) -> _Pending:
        img = np.asarray(image_u8, np.uint8)
        if img.shape != (self.size, self.size):
            raise ValueError(
                f"expected {self.size}x{self.size}, got "
                f"{img.shape[0]}x{img.shape[1]}")
        if not self._cuda:
            return _Pending(self._step(torch.from_numpy(img)[None]), None)
        while len(self._slots) <= slot:
            self._slots.append(
                (torch.empty((1, self.size, self.size), dtype=torch.uint8,
                             pin_memory=True),
                 torch.empty(2, dtype=torch.float32, pin_memory=True)))
        host_in, host_out = self._slots[slot]
        host_in[0].numpy()[...] = img
        out = self._step(host_in.to(self.device, non_blocking=True))
        host_out.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Pending(host_out, event)

    def predict(self, image_u8: np.ndarray) -> typing.Tuple[float, float]:
        return self._submit(image_u8, 0).result()

    def predict_many(self, images: typing.Iterable[np.ndarray],
                     depth: int = 4) -> typing.Iterator[
                         typing.Tuple[float, float]]:
        """Pipelined streaming inference; results yield in input order.

        Request n uses host buffer slot n % depth; the request that used
        the slot before it (n - depth) has been taken out of the queue,
        and so has completed, before the slot is written again."""
        q = collections.deque()
        for n, img in enumerate(images):
            while len(q) >= depth:
                yield q.popleft().result()
            q.append(self._submit(img, n % depth))
        while q:
            yield q.popleft().result()


def load_server(model_dir, train_method: str = "LSBR", size: int = 512,
                compute_dtype: torch.dtype = torch.bfloat16,
                fast_conv=False, device=None
                ) -> typing.Tuple[UNetWSServer, str]:
    """The server of ``serve``: the trained run of ``train_method`` found
    by name under ``model_dir`` (``weights/unet``), loaded on ``device``
    (None = CUDA) and served at ``size`` in ``compute_dtype``; returns it
    with the run's name."""
    from .utils.registry import get_model_name
    from .ws.unet_eval import load_pretrained_unet

    dev = resolve_device(device)
    name = get_model_name(model_dir, train_method)
    model, _ = load_pretrained_unet(
        pathlib.Path(model_dir) / train_method, name,
        compute_dtype=compute_dtype, fast_conv=fast_conv, device=dev)
    return UNetWSServer(model, size=size, compute_dtype=compute_dtype,
                        device=dev), name


def stream_paths(server: UNetWSServer, paths: typing.Iterable[str],
                 reader: typing.Callable = None, threads: int = 2,
                 depth: int = 4) -> typing.Iterator[dict]:
    """Streaming serve loop over image paths: background-threaded decode
    feeds ``predict_many``-style pipelining.  Yields one dict per path in
    order, ``{"name", "beta_hat", "l1"}`` or ``{"name", "error"}``, and
    never aborts on a per-image failure (a file the reader cannot read
    included).  The default reader is the port's PNG reader
    (``io.imread_gray_u8`` on ``io.png``), which decodes outside the
    GIL."""
    import concurrent.futures as futures

    if reader is None:
        reader = imread_gray_u8

    def decode(path):
        img = reader(path)
        if img.ndim == 3:
            img = img[..., 0]
        if img.shape != (server.size, server.size):
            raise ValueError(
                f"expected {server.size}x{server.size}, got "
                f"{img.shape[0]}x{img.shape[1]} (one serving shape; "
                "restart with --size to change)")
        return img

    def error(name, e):
        return {"name": name,
                "error": f"{type(e).__name__}: {str(e)[:300]}"}

    # one ordered queue carries both requests in flight and decode
    # failures, so rows always yield in input order
    q = collections.deque()
    n = 0
    with futures.ThreadPoolExecutor(max_workers=threads) as pool:
        dq = collections.deque()
        it = iter(paths)
        done = False
        while True:
            while not done and len(dq) < depth:
                try:
                    path = next(it)
                except StopIteration:
                    done = True
                    break
                dq.append((path, pool.submit(decode, path)))
            if not dq and not q:
                break
            if dq:
                name, fut = dq.popleft()
                try:
                    q.append((name, server._submit(fut.result(), n % depth)))
                    n += 1
                except (OSError, ValueError, UserError) as e:
                    q.append((name, e))
            while len(q) >= depth or (done and not dq and q):
                name, pending = q.popleft()
                if isinstance(pending, Exception):
                    yield error(name, pending)
                    continue
                beta, l1 = pending.result()
                yield {"name": name, "beta_hat": beta, "l1": l1}


def serve_lines(server: UNetWSServer, lines: typing.Iterable[str],
                reader: typing.Callable = None) -> typing.Iterator[dict]:
    """The serial serve loop of ``serve`` with no paths: one path a line,
    each answered before the next line is read (a pipelined loop would
    hold answers back behind later lines).  Yields ``{"name", "beta_hat",
    "l1"}`` or, for an image that fails or has the wrong shape, ``{"name",
    "error"}``, and never stops on one.  The default reader is the port's
    PNG reader (``io.imread_gray_u8``)."""
    if reader is None:
        reader = imread_gray_u8
    for path in (line.strip() for line in lines):
        if not path:
            continue
        try:
            img = reader(path)
            if img.shape != (server.size, server.size):
                raise ValueError(
                    f"expected {server.size}x{server.size}, got "
                    f"{'x'.join(map(str, img.shape))} (one serving shape; "
                    "restart with --size to change)")
            beta, l1 = server.predict(img)
            out = {"name": path, "beta_hat": beta, "l1": l1}
        except Exception as e:  # noqa: BLE001 -- the loop's contract:
            # a failed request is answered inline, the next one is served
            out = {"name": path,
                   "error": f"{type(e).__name__}: {str(e)[:300]}"}
        yield out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_latency(server: UNetWSServer, reps: int = 30) -> dict:
    """Median blocking latency of the serving step, plus the launch floor
    (one empty launch and synchronize, measured identically)."""
    x = np.zeros((server.size, server.size), np.uint8)
    server.predict(x)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        server.predict(x)
        lat.append(time.perf_counter() - t0)

    small = torch.zeros((8, 128), device=server.device)
    small.add_(1)
    _sync(server.device)
    rtt = []
    for _ in range(reps):
        t0 = time.perf_counter()
        small.add_(1)
        _sync(server.device)
        rtt.append(time.perf_counter() - t0)

    med = 1e3 * float(np.median(lat))
    floor = 1e3 * float(np.median(rtt))
    return {
        "latency_ms_b1": med,
        "rtt_floor_ms": floor,
        "latency_ms_b1_net": max(med - floor, 0.0),
        **measure_streaming(server),
    }


def measure_streaming(server: UNetWSServer, n: int = 48) -> dict:
    """Streamed vs serial serving throughput over distinct host images
    (fresh transfers, like real traffic); the two must agree."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (server.size, server.size), dtype=np.uint8)
            for _ in range(n)]
    server.predict(imgs[0])

    t0 = time.perf_counter()
    serial = [server.predict(im) for im in imgs]
    dt_serial = time.perf_counter() - t0

    t0 = time.perf_counter()
    streamed = list(server.predict_many(iter(imgs)))
    dt_stream = time.perf_counter() - t0

    if not np.allclose(np.asarray(serial), np.asarray(streamed)):
        raise RuntimeError("pipelined serving changed results")
    return {
        "serial_images_per_sec": n / dt_serial,
        "streamed_images_per_sec": n / dt_stream,
        "stream_speedup": dt_serial / dt_stream,
    }
