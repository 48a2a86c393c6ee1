"""What both trainers share around their steps: the experiment directory,
the metric log, an epoch's image order and the validation generators."""

import pathlib
import time

import numpy as np
import torch

from ..utils import create_run_name


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
