"""U-Net inference + WS prediction error (port of
``wsunet_tpu/ws/unet_eval.py``).

- ``infer_unet``: center-crop 512, /255 -> model -> crop 1-px border ->
  x255, batched.
- ``predict_batch``: uint8 [B, H, W] -> (beta_hat, l1) per image with the
  unweighted, unclipped U-Net WS variant (the step of ``_predict_frame``).
- ``load_pretrained_unet`` / ``get_unet_estimator``: a trained run from its
  ``config.json`` and ``best.npz`` (``train.checkpoint``), read with numpy
  and json alone.
- ``predict_sweep``: (beta_hat, l1) over image names, NaN where a decode
  failed (numpy and torch only); rank-sharded under a process group
  (``parallel``), each rank running the model, on B1 with
  ``fast_conv=True``, over its own rows.
- ``_predict_frame`` / ``run``: the ``unet-eval`` sweep over a catalog,
  giving the rows of ``ws_<method>.csv`` (pandas at this edge only).
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device, to_model_device
from ..data.transforms import center_crop
from ..io.imread import imread_gray_u8
from ..models import get_model, unet_state_dict_from_flax
from ..ops.ws import ws_estimate_unet
from ..train.checkpoint import load_config, load_params
from ..utils.errors import UserError
from ..utils.registry import get_model_name


@torch.no_grad()
def infer_unet(model, x, device=None) -> torch.Tensor:
    """[B, H, W] f32 pixels (0..255) -> [B, 510, 510] prediction
    (0..255), on ``device`` (None = CUDA)."""
    x = to_model_device(model, x, device).to(torch.float32)
    xc = center_crop(x, 512)[:, None] / 255.0
    y = model(xc)
    return y[:, 0, 1:-1, 1:-1].to(torch.float32) * 255.0


@torch.no_grad()
def predict_batch(model, pixels_u8, device=None
                  ) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W] -> (beta_hat [B], l1 [B]), on ``device``."""
    x = to_model_device(model, pixels_u8, device).to(torch.float32)
    x_hat = infer_unet(model, x, device=x.device)
    return ws_estimate_unet(center_crop(x, 512), x_hat)


def load_pretrained_unet(model_path: pathlib.Path, model_name: str,
                         compute_dtype: torch.dtype = torch.float32,
                         fast_conv=False, device=None):
    """(model, config) of the run ``model_path / model_name``: the network
    its config names, one input and one output channel, no dropout, its
    ``best.npz`` weights, in eval mode on ``device`` (None = CUDA).
    ``fast_conv=False`` pads and convolves with cuDNN; ``True`` runs every
    3x3 conv through kernel B1."""
    dev = resolve_device(device)
    exp_dir = pathlib.Path(model_path) / model_name
    if not (exp_dir / "config.json").exists():
        raise UserError(f"no model run at {exp_dir} (config.json missing)")
    config = load_config(exp_dir)
    model = get_model(config["network"], in_channels=1, out_channels=1,
                      compute_dtype=compute_dtype, fast_conv=fast_conv)
    model.load_state_dict(unet_state_dict_from_flax(load_params(exp_dir)[0]))
    return model.to(dev).eval(), config


def get_unet_estimator(model_path: pathlib.Path, model_name: str,
                       compute_dtype: torch.dtype = torch.float32,
                       fast_conv=False, device=None) -> typing.Callable:
    """Pixel-estimator callable for ``ws_attack``: f32 [B, H, W] on the
    device -> [B, 510, 510]."""
    model, _ = load_pretrained_unet(model_path, model_name,
                                    compute_dtype=compute_dtype,
                                    fast_conv=fast_conv, device=device)

    def predict(x):
        return infer_unet(model, x, device=x.device)

    return predict


def predict_sweep(root, names, model, batch_size: int, threads: int = 8,
                  device=None, reader: typing.Callable = imread_gray_u8
                  ) -> typing.Tuple[np.ndarray, np.ndarray]:
    """(beta_hat, l1), f32 [len(names)], of the images ``names`` under
    ``root``, NaN where an image failed to decode.  Batches stay on the
    device after their first pass (``device_cache``), so the next sweep
    over the same images starts there; ``reader`` decodes a file.  Under
    a process group each rank runs batches of ``batch_size`` (per rank) of
    its own rows, without the device cache, and every rank returns every
    row."""
    from ..data.pipeline import sweep_batches

    dev = resolve_device(device)
    out = sweep_batches(root, names,
                        lambda px: predict_batch(model, px, device=dev),
                        batch_size, threads=threads, device_cache=True,
                        device=dev, reader=reader).reshape(len(names), 2)
    return out[:, 0].astype(np.float32), out[:, 1].astype(np.float32)


def _predict_frame(root, df, model, batch_size: int, threads: int,
                   device=None):
    """Per-image (beta_hat, l1) over catalog rows: the rows of ``df`` with
    two more columns; a failed decode gives NaN."""
    import pandas as pd

    beta, l1 = predict_sweep(root, list(df["name"]), model, batch_size,
                             threads, device=device)
    out = df.reset_index(drop=True).copy()
    out["beta_hat"] = pd.Series(beta, index=out.index)
    out["l1"] = pd.Series(l1, index=out.index)
    return out


def run(data_path: pathlib.Path, model_dir: pathlib.Path, stego_method: str,
        eval_methods=("LSBR", "HILLR"), model_name: str = None,
        batch_size: int = 8, threads: int = 8, split: str = None,
        take_num_images: int = None, fast_conv=False, device=None):
    """Cover + stego sweeps of one trained model: the rows of
    ``estimation/ws_<method>.csv``; ``fast_conv=True`` runs the U-Net's
    3x3 convs through kernel B1."""
    import pandas as pd

    from ..data.catalog import precovers, stego_spatial

    model_dir = pathlib.Path(model_dir)
    if model_name is None:
        model_name = get_model_name(model_dir, stego_method)
    model, _ = load_pretrained_unet(model_dir / stego_method, model_name,
                                    fast_conv=fast_conv, device=device)
    select = dict(split=split, take_num_images=take_num_images)
    frames = [_predict_frame(data_path, precovers(data_path, **select),
                             model, batch_size, threads, device=device)]
    for sm in eval_methods:
        df_s = stego_spatial(data_path, stego_method=sm, **select)
        if len(df_s):
            frames.append(_predict_frame(data_path, df_s, model, batch_size,
                                         threads, device=device))
    return pd.concat(frames).reset_index(drop=True)
