"""EfficientNet-B0 detector inference (port of
``wsunet_tpu/detect/b0_eval.py``).

- ``infer_b0``: center-crop 512, /255, the optional LSBr-reference plane,
  ImageNet green-channel normalisation -> model -> softmax P(stego), with
  subnormal probabilities flushed to 0 as XLA does.
- ``load_pretrained_b0`` / ``get_b0_detector``: a trained run from its
  ``config.json`` and ``best.npz`` (parameters and batch-norm running
  statistics, ``train.checkpoint``), read with numpy and json alone.
- ``score_sweep``: P(stego) over image names, NaN where a decode failed
  (numpy and torch only, so it runs on the card from ``.npy`` files);
  rank-sharded under a process group (``parallel``), each rank scoring
  its own rows.
- ``_score_frame`` / ``run``: the ``detector-eval`` sweep over a catalog,
  giving the rows (a ``utils.table.Table``) of ``detection/b0.csv``.
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_model_device
from ..data.transforms import center_crop, lsbr_reference, normalize
from ..io.imread import imread_gray_u8
from ..models import b0_state_dict_from_flax, get_b0
from ..train.checkpoint import load_config, load_params
from ..utils.errors import UserError
from ..utils.registry import get_model_name
from ..utils.table import Table, concat

# ImageNet green-channel moments (the reference takes [1:2] of timm's
# IMAGENET_DEFAULT_MEAN / STD)
IMAGENET_GREEN_MEAN = 0.456
IMAGENET_GREEN_STD = 0.224


@torch.no_grad()
def infer_b0(model, x, use_lsbr_reference: bool = False,
             device=None) -> torch.Tensor:
    """[B, H, W] pixels (0..255) -> softmax P(stego) [B], f32, on
    ``device`` (None = CUDA)."""
    x = to_model_device(model, x, device).to(torch.float32)
    xc = center_crop(x, 512)[:, None] / 255.0
    if use_lsbr_reference:
        xc = lsbr_reference(xc)
    xc = normalize(xc, IMAGENET_GREEN_MEAN, IMAGENET_GREEN_STD)
    p = torch.softmax(model(xc), dim=1)[:, 1]
    # XLA flushes f32 subnormals to zero (the JAX package's P(stego) of a
    # logit gap beyond about 87 is exactly 0), and the ROC's lowest
    # threshold, tau = 0, tells 0 from a subnormal: flush them here too
    return torch.where(p < torch.finfo(p.dtype).tiny, 0.0, p)


def b0_in_channels(config: dict) -> int:
    """Input planes of a run: 1 (grayscale) or 3, plus 3 demosaic planes
    and 1 LSBr-reference plane where the config sets them."""
    n = 1 if config.get("grayscale", True) else 3
    n += 3 if config.get("demosaic_oracle") else 0
    return n + (1 if config.get("lsbr_reference") else 0)


def load_pretrained_b0(model_dir: pathlib.Path, model_name: str,
                       compute_dtype: torch.dtype = torch.float32,
                       device=None):
    """(model, config) of the run ``model_dir / model_name``: the B0 its
    config describes, its ``best.npz`` weights and running statistics, in
    eval mode on ``device`` (None = CUDA), computing in
    ``compute_dtype``."""
    dev = resolve_device(device)
    exp_dir = pathlib.Path(model_dir) / model_name
    if not (exp_dir / "config.json").exists():
        raise UserError(f"no model run at {exp_dir} (config.json missing)")
    config = load_config(exp_dir)
    model = get_b0(
        in_channels=b0_in_channels(config),
        no_stem_stride=config.get("no_stem_stride", False),
        quadratic_stem=config.get("quadratic_stem", False),
        parity_features=config.get("parity_features", False),
        norm=config.get("norm", "batch"),
        compute_dtype=compute_dtype)
    model.load_state_dict(b0_state_dict_from_flax(*load_params(exp_dir)))
    return model.to(dev).eval(), config


def get_b0_detector(model_dir: pathlib.Path, model_name: str,
                    lsbr_reference: bool = False,
                    device=None) -> typing.Callable:
    """Detector callable: [B, H, W] pixels (an array, or a tensor on
    ``device``) -> P(stego) [B] on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    model, _ = load_pretrained_b0(model_dir, model_name, device=dev)

    def detect(x):
        return infer_b0(model, x, use_lsbr_reference=lsbr_reference,
                        device=dev)

    return detect


def score_sweep(root, names, detect: typing.Callable, batch_size: int,
                threads: int = 8,
                reader: typing.Callable = imread_gray_u8,
                device=None) -> np.ndarray:
    """P(stego), f32 [len(names)], of the images ``names`` under
    ``root``, NaN where an image failed to decode.  Batches stay on the
    device after their first pass (``device_cache``); ``reader`` decodes a
    file.  Under a process group each rank scores batches of
    ``batch_size`` (per rank) of its own rows, without the device cache,
    and every rank returns every row."""
    from ..data.pipeline import sweep_batches

    out = sweep_batches(root, names, lambda px: (detect(px),), batch_size,
                        threads=threads, device_cache=True,
                        device=resolve_device(device), reader=reader)
    return out.reshape(len(names)).astype(np.float32)


def _score_frame(root, df: Table, detect, batch_size: int, threads: int,
                 device=None) -> Table:
    """The rows of ``df`` with ``output`` (P(stego), NaN for a failed
    decode) and ``prediction`` (output > 0.5)."""
    out = df.copy()
    out["output"] = score_sweep(root, list(df["name"]), detect, batch_size,
                                threads, device=device)
    out["prediction"] = out["output"] > 0.5
    return out


def run(data_path: pathlib.Path, model_dir: pathlib.Path,
        stego_method: str = "LSBR", eval_methods=("LSBR", "HILLR"),
        model_name: str = None, no_stem_stride: bool = False,
        lsbr_reference: bool = False, batch_size: int = 8,
        threads: int = 8, split: str = None, take_num_images: int = None,
        device=None) -> Table:
    """Covers and stego sweeps scored by one trained B0, the rows of
    ``detection/b0.csv``; without ``model_name`` the registry picks the
    run under ``model_dir / stego_method`` with the given switches."""
    from ..data.catalog import precovers, stego_spatial

    model_dir = pathlib.Path(model_dir)
    if model_name is None:
        model_name = get_model_name(
            model_dir, stego_method,
            no_stem_stride=no_stem_stride, lsbr_reference=lsbr_reference)
    detect = get_b0_detector(model_dir / stego_method, model_name,
                             lsbr_reference=lsbr_reference, device=device)
    select = dict(split=split, take_num_images=take_num_images)
    frames = [_score_frame(data_path, precovers(data_path, **select),
                           detect, batch_size, threads, device=device)]
    for sm in eval_methods:
        df_s = stego_spatial(data_path, stego_method=sm, **select)
        if len(df_s):
            frames.append(_score_frame(data_path, df_s, detect, batch_size,
                                       threads, device=device))
    return concat(frames)
