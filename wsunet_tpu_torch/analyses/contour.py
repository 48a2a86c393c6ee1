"""Difference-image contour maps (port of
``wsunet_tpu/analyses/contour.py``): ``x[1:-1, 1:-1] - x_hat`` of one image
for a named filter or a trained U-Net (``difference_image``, on the
device), and ``|d|`` drawn as an inverted-gray image (``plot_contour``,
where matplotlib is installed; otherwise one line on stderr says the
figure was not drawn).
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device
from ..io import imread_gray_u8
from ..ops.filters import NAMED_FILTERS_2D, filter_predict
from ..utils.figures import plotting
from ..utils.registry import get_model_name
from ..ws.unet_eval import get_unet_estimator


def difference_image(
    fname: pathlib.Path,
    model_name: str = "KB",
    model_dir: pathlib.Path = None,
    stego_method: str = "LSBR",
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> np.ndarray:
    """x[1:-1, 1:-1] - x_hat for a named filter or, for any other
    ``model_name``, the trained U-Net of ``stego_method`` found by name
    under ``model_dir``; computed on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    x = reader(fname).astype("float32")
    xt = torch.from_numpy(x[None]).to(dev)
    if model_name in NAMED_FILTERS_2D:
        x_hat = filter_predict(xt, NAMED_FILTERS_2D[model_name])
    else:
        exp_name = get_model_name(model_dir, stego_method)
        predictor = get_unet_estimator(
            pathlib.Path(model_dir) / stego_method, exp_name,
            fast_conv=fast_conv, device=dev)
        x_hat = predictor(xt)
    return x[1:-1, 1:-1] - x_hat[0].cpu().numpy()


def plot_contour(fname, d: np.ndarray, model_name: str,
                 outdir: pathlib.Path) -> typing.Optional[pathlib.Path]:
    """Save |d| as ``contour_<model>_<stem>.png`` and return its path;
    without matplotlib, say on stderr that it was not drawn and return
    None."""
    outdir = pathlib.Path(outdir)
    outname = outdir / f"contour_{model_name}_{pathlib.Path(fname).stem}.png"
    mods = plotting("contour", outname, "matplotlib.pyplot")
    if mods is None:
        return None
    _, plt = mods
    outdir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    ax.imshow(np.abs(d), vmin=0, vmax=60, cmap="gray_r",
              interpolation="nearest")
    ax.set_axis_off()
    fig.savefig(outname, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return outname
