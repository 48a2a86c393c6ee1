"""What both trainers share around their steps: the experiment directory,
the metric log, an epoch's image order, the validation generators, the
batches a rank feeds its step (``rank_batches``), and what rank 0 alone
does under a process group (``on_rank0``, ``run_dir``, ``rank_writer``)."""

import pathlib
import time
import typing

import numpy as np
import torch

from .._device import to_device
from ..data.pipeline import iterate_batches
from ..utils import create_run_name
from ..utils.profiling import span


class MetricWriter:
    """CSV scalars always, TensorBoard's as well when torch's writer
    imports (the JAX trainer's rule)."""

    def __init__(self, log_dir: pathlib.Path):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._csv = open(self.log_dir / "scalars.csv", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=str(self.log_dir))
        except Exception:
            self._tb = None

    def add_scalar(self, tag, value, global_step):
        self._csv.write(f"{global_step},{tag},{value}\n")
        self._csv.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def close(self):
        self._csv.close()
        if self._tb is not None:
            self._tb.close()


def epoch_names(names: list, rng: np.random.Generator,
                steps_per_epoch: int = None, batch_size: int = 1) -> list:
    """One epoch's image order: the JAX trainer's ``df.sample(frac=1,
    random_state=rng.integers(2**31))`` (which is
    ``RandomState(s).permutation(n)``), repeated to ``steps_per_epoch *
    batch_size`` names when that is set."""
    names = list(names)
    if len(names) > 1:
        order = np.random.RandomState(rng.integers(2 ** 31)).permutation(
            len(names))
        names = [names[i] for i in order]
    return repeat_names(names, steps_per_epoch, batch_size)


def repeat_names(names: list, steps: int, batch_size: int) -> list:
    """``names`` repeated and cut to ``steps * batch_size`` (all of them,
    once, when ``steps`` is not set)."""
    if not steps:
        return names
    need = steps * batch_size
    reps = max(1, -(-need // len(names)))
    return (names * reps)[:need]


def val_generator(seed: int, batch_index: int, device) -> torch.Generator:
    """The fixed generator of validation batch ``batch_index`` (the JAX
    trainer's ``fold_in(PRNGKey(seed), vb)``)."""
    state = np.random.SeedSequence([seed, batch_index]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def experiment_dir(output_dir, method: str, platform: str,
                   cfg: dict) -> pathlib.Path:
    """``<output_dir>/<method>/<%y%m%d%H%M%S>-<platform>-<run name>``;
    a second run started in the same second waits for the next stamp."""
    while True:
        run_name = (time.strftime("%y%m%d%H%M%S") + f"-{platform}-"
                    + create_run_name(cfg))
        exp_dir = pathlib.Path(output_dir) / method / run_name
        if not exp_dir.exists():
            return exp_dir
        time.sleep(0.25)


class _NoWriter:
    """The metric log of a rank other than 0: writes nothing."""

    def add_scalar(self, tag, value, global_step):
        pass

    def close(self):
        pass


def on_rank0(mesh, fn, *args, **kwargs) -> None:
    """``fn(*args, **kwargs)`` on rank 0 alone (it writes the run's
    files); the other ranks wait for it at a barrier."""
    try:
        if mesh.rank == 0:
            fn(*args, **kwargs)
    finally:
        mesh.barrier()


def run_dir(mesh, output_dir, method: str, platform: str,
            cfg: dict) -> pathlib.Path:
    """The experiment directory (``experiment_dir``), chosen by rank 0
    and the same on every rank."""
    return mesh.broadcast_object(
        experiment_dir(output_dir, method, platform, cfg)
        if mesh.rank == 0 else None)


def rank_writer(mesh, log_dir: pathlib.Path):
    """The metric log: a ``MetricWriter`` on rank 0, nothing elsewhere."""
    return MetricWriter(log_dir) if mesh.rank == 0 else _NoWriter()


def rank_batches(mesh, root, names: list, batch_size: int,
                 reader: typing.Callable, device) -> typing.Iterator[tuple]:
    """(mask, pixels, pixel_mask) of each batch of ``batch_size`` of
    ``names``: ``mask`` the global batch's [batch_size] numpy bool (False
    on padding and failed decodes), ``pixels`` and ``pixel_mask`` what
    this rank feeds its step, on ``device``.  Without a process group
    that is the whole batch; under one, this rank's contiguous block of
    it, and the rank decodes only that block.  A short last batch is
    padded by its first name, as ``iterate_batches`` pads by its first
    image, and a failed decode is zeros, as there, so the blocks of every
    rank make up the one-process batch (a block with no decodable image
    too).

    Each batch, from asking the pipeline for it to its pixels and mask on
    ``device``, is the span ``train.fetch`` (``utils.profiling``); the
    mask's copy is its child ``train.mask``."""
    batches = _rank_batches(mesh, root, names, batch_size, reader, device)
    while True:
        with span("train.fetch"):
            out = next(batches, None)
        if out is None:
            return
        yield out


def _rank_batches(mesh, root, names, batch_size, reader, device):
    if mesh.group is None:
        for batch in iterate_batches(root, names, batch_size, reader=reader,
                                     cache=True):
            pixels = to_device(batch.pixels, device)
            with span("train.mask"):
                mask = torch.as_tensor(batch.mask, device=device)
            yield batch.mask, pixels, mask
        return
    block = mesh.block(batch_size)
    local, real = [], []
    for start in range(0, len(names), batch_size):
        chunk = list(names[start:start + batch_size])
        real += [i < len(chunk) for i in range(batch_size)][block]
        local += (chunk + chunk[:1] * (batch_size - len(chunk)))[block]
    b = block.stop - block.start
    for i, batch in enumerate(iterate_batches(root, local, b, reader=reader,
                                              cache=True, allow_empty=True)):
        # one all-gather a batch: each rank's image shape (none where no
        # image of its block decoded) and mask
        mask = batch.mask & real[i * b:(i + 1) * b]
        dims = () if batch.pixels is None else batch.pixels.shape[1:]
        row = list(dims) + [0] * (3 - len(dims)) + [len(dims)]
        every = [e.cpu().numpy() for e in mesh.all_gather(torch.tensor(
            row + mask.tolist(), dtype=torch.int64, device=device))]
        shapes = [tuple(e[:e[3]]) for e in every if e[3]]
        if not shapes:
            raise FileNotFoundError(
                f"no decodable image among {local[i * b:i * b + 3]}...")
        pixels = batch.pixels if batch.pixels is not None else \
            np.zeros((b,) + shapes[0], np.uint8)
        yield np.concatenate([e[4:] for e in every]).astype(bool), \
            to_device(pixels, device), torch.as_tensor(mask, device=device)
