"""Recalibrate a trained B0's batch-norm running statistics (port of
``scripts/bn_recalibrate.py``).

The parameters stay frozen; ``num_batches`` batches of ``batch_size``
full-size cover/stego pairs go through the model in training mode, and
each forward moves the running statistics as Flax's ``BatchNorm`` does
(``models.b0.FlaxBatchNorm``: momentum 0.9, the biased batch variance).
The pairs are made as the trainer makes them, without crop or
augmentation: each image's rate drawn from the run's ``alpha`` mixture,
LSBr, or HILLr at the listed rate nearest the drawn one, then the run's
preprocessing.  The result is a sibling run ``<run>-bnrecal`` holding the
source's files, ``model/best`` (torch state) and ``best.npz`` with the new
statistics, and no ``model/latest``.

    python -m wsunet_tpu_torch.train.bn_recalibrate <family_dir> <method> \\
        <run> [num_batches] [batch_size] [--data DIR] [--device cpu]

``recalibrate`` reads the training split of the run's ``dataset`` (or of
``data_path`` when given: the committed configs name a dataset path of
the machine they were trained on) with pandas; ``recalibrate_names``
takes image names and a reader, so it runs where pandas is not.
"""

import argparse
import pathlib
import shutil
import sys
import typing

import torch

from .._device import resolve_device, to_device
from ..data.pipeline import iterate_batches
from ..detect.b0_eval import load_pretrained_b0
from ..io.imread import imread_gray_u8
from ..utils.errors import UserError
from .checkpoint import (load_checkpoint, load_config, save_checkpoint,
                         save_params)
from .common import repeat_names
from .train_b0 import B0Sampler, b0_params_tree

SUFFIX = "-bnrecal"


def recalibrate_names(src: pathlib.Path, data_path: pathlib.Path,
                      names: typing.Sequence[str], num_batches: int = 80,
                      batch_size: int = 4, device=None, seed: int = 7,
                      reader: typing.Callable = imread_gray_u8
                      ) -> pathlib.Path:
    """Recalibrate the run ``src`` over the images ``names`` under
    ``data_path`` (repeated to ``num_batches * batch_size``), drawing from
    a generator seeded with ``seed``; returns the ``-bnrecal`` run."""
    dev = resolve_device(device)
    src = pathlib.Path(src)
    cfg = load_config(src)
    model, _ = load_pretrained_b0(src.parent, src.name, device=dev)
    if not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        raise UserError(f"{src}: the model has no batch statistics "
                        "(norm is not batch)")
    sampler = B0Sampler(model, cfg.get("stego_method", "LSBR"),
                        cfg.get("alpha"),
                        use_lsbr_reference=cfg.get("lsbr_reference", False))
    generator = torch.Generator(device=dev).manual_seed(seed)
    model.train()
    model.dropout.eval()     # head dropout does not touch the statistics
    n = 0
    with torch.no_grad():
        for batch in iterate_batches(
                data_path, repeat_names(list(names), num_batches, batch_size),
                batch_size, reader=reader, cache=True):
            x = to_device(batch.pixels, dev)
            model(sampler.pair(x, sampler.draw(x.shape, generator))[0])
            n += 1
    print(f"recalibrated over {n} batches of {batch_size} pairs")

    dst = src.parent / (src.name + SUFFIX)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("model"))
    state = (dict(load_checkpoint(src, "best"))
             if (src / "model").exists() else {})
    state["params"] = model.state_dict()
    save_checkpoint(dst, state, is_best=True)
    # save_checkpoint writes 'latest' too; the sibling keeps best only
    shutil.rmtree(dst / "model" / "latest")
    save_params(dst, b0_params_tree(model))
    print("saved:", dst)
    return dst


def recalibrate(family_dir, method: str, run_name: str,
                num_batches: int = 80, batch_size: int = 4,
                data_path=None, device=None) -> pathlib.Path:
    """Recalibrate ``<family_dir>/<method>/<run_name>`` over the training
    split (``tr_csv``) of its dataset, or of ``data_path`` when given."""
    from ..data.catalog import precovers

    resolve_device(device)
    src = pathlib.Path(family_dir) / method / run_name
    cfg = load_config(src)
    data = pathlib.Path(data_path or cfg.get("dataset", "data"))
    names = list(precovers(data, split=cfg.get("tr_csv",
                                                "split_tr.csv"))["name"])
    return recalibrate_names(src, data, names, num_batches, batch_size,
                             device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wsunet_tpu_torch.train.bn_recalibrate",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("family_dir", type=pathlib.Path)
    ap.add_argument("method")
    ap.add_argument("run")
    ap.add_argument("num_batches", type=int, nargs="?", default=80)
    ap.add_argument("batch_size", type=int, nargs="?", default=4)
    ap.add_argument("--data", type=pathlib.Path, default=None,
                    help="dataset root (default: the run's config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    recalibrate(args.family_dir, args.method, args.run, args.num_batches,
                args.batch_size, data_path=args.data, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
