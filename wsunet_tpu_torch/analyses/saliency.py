"""Gradient saliency of the U-Net predictor (port of
``wsunet_tpu/analyses/saliency.py``).

- ``saliency_patch``: the gradient of one output pixel of a torch ``UNet``
  with respect to the input image, by ``torch.autograd`` where JAX takes
  ``jax.grad``.  With ``fast_conv=True`` the forward runs kernel B1 and
  the backward the VJP of its plain version (``ops.fused_reflect_conv``),
  as JAX's custom VJP does.
- ``unet_saliency``: the JAX signature: the trained run of
  ``stego_method`` is found by name under ``model_dir``
  (``utils.registry``, the exported runs of ``weights/unet``) and loaded
  with ``ws.unet_eval.load_pretrained_unet``; ``saliency_patches`` loads it
  once for several points.
- ``sobel_locations``: the interesting-point finder (Sobel gradients
  through ``ops.filter_predict`` on the device, then ratio maxima and
  box-filtered gradient-magnitude extrema).
- ``render_dots``: the image with the points as red pixels, an RGB PNG
  written by ``io.png.write_png`` (the pixels of the JAX package's PIL
  file; the bytes are the port's own encoder's).
- ``plot_saliency_grid``: the patches, then their figure where matplotlib
  is installed (otherwise one line on stderr says it was not drawn).
"""

import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device
from ..io import imread_gray_u8
from ..io.png import write_png
from ..ops.filters import filter_predict
from ..utils.errors import UserError
from ..utils.figures import plotting
from ..utils.registry import get_model_name
from ..ws.unet_eval import load_pretrained_unet

SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype="float32")
SOBEL_V = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype="float32")
BOX9 = np.ones((3, 3), dtype="float32")


def sobel_locations(fname, reader: typing.Callable = imread_gray_u8,
                    device=None) -> typing.Dict[str, tuple]:
    """gh_max / gv_max / g_max / g_min interesting points of an image
    file (indices into the VALID filter grid, as in the JAX package),
    filtered on ``device`` (None = CUDA)."""
    dev = resolve_device(device)

    def predict(x: np.ndarray, kernel) -> np.ndarray:
        return filter_predict(torch.from_numpy(x[None]).to(dev),
                              kernel)[0].cpu().numpy()

    x = reader(fname).astype("float32")
    gh = predict(x, SOBEL_H)
    gv = predict(x, SOBEL_V)
    g = predict(np.sqrt(gh ** 2 + gv ** 2), BOX9)
    return {
        "gh_max": np.unravel_index(np.abs(gh / (.1 + gv)).argmax(), gh.shape),
        "gv_max": np.unravel_index(np.abs(gv / (.1 + gh)).argmax(), gv.shape),
        "g_max": np.unravel_index(g.argmax(), g.shape),
        "g_min": np.unravel_index(g.argmin(), g.shape),
    }


def render_dots(fname, outfile: pathlib.Path,
                reader: typing.Callable = imread_gray_u8,
                device=None) -> pathlib.Path:
    """``saliency_image_dots.png``: the image with the four interesting
    points as single red pixels.  As in the JAX package, the valid-grid
    indices are applied to the full image without the +1 border offset,
    so the figure matches its pixels."""
    x = reader(fname)
    y = np.repeat(x[..., None] if x.ndim == 2 else x, 3, axis=-1)
    for loc in sobel_locations(fname, reader=reader,
                               device=device).values():
        y[loc[:2]] = [255, 0, 0]
    outfile = pathlib.Path(outfile)
    outfile.parent.mkdir(parents=True, exist_ok=True)
    write_png(outfile, y)
    return outfile


def saliency_patch(model, image_u8: np.ndarray, i: int, j: int, n: int = 8,
                   device=None) -> np.ndarray:
    """(2n+1)x(2n+1) patch around (i, j) of the gradient of output pixel
    (i, j) with respect to the input pixels (0..255), times 255: the
    gradient with respect to the model's input x/255.  ``image_u8`` is
    [H, W]; ``device=None`` means CUDA, and the model must lie there."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise UserError(f"the model is on {p.device}, the call asks for "
                        f"{dev}; move it with model.to(device)")
    img = np.asarray(image_u8)
    if img.ndim != 2:
        raise ValueError(f"expected an [H, W] image, got {img.shape}")
    x = torch.as_tensor(img, dtype=torch.float32, device=dev)
    x.requires_grad_(True)
    y = model((x / 255.0)[None, None])
    (grad,) = torch.autograd.grad(y[0, 0, i, j], x)
    slc = grad.cpu().numpy() * 255.0
    return slc[i - n:i + n + 1, j - n:j + n + 1]


def saliency_patches(
    fname,
    points: typing.Sequence[typing.Tuple[int, int]],
    model_dir: pathlib.Path,
    stego_method: str = "LSBR",
    n: int = 8,
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> typing.List[np.ndarray]:
    """``unet_saliency`` at each of ``points``, the run loaded once."""
    dev = resolve_device(device)
    name = get_model_name(model_dir, stego_method)
    model, _ = load_pretrained_unet(pathlib.Path(model_dir) / stego_method,
                                    name, fast_conv=fast_conv, device=dev)
    img = reader(fname)
    return [saliency_patch(model, img, i, j, n, device=dev)
            for i, j in points]


def unet_saliency(
    fname,
    i: int,
    j: int,
    model_dir: pathlib.Path,
    stego_method: str = "LSBR",
    n: int = 8,
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> np.ndarray:
    """(2n+1)x(2n+1) gradient patch of output pixel (i, j) of the trained
    U-Net of ``stego_method`` with respect to the image ``fname``."""
    return saliency_patches(fname, [(i, j)], model_dir, stego_method, n,
                            fast_conv=fast_conv, reader=reader,
                            device=device)[0]


def plot_saliency_grid(
    fname,
    model_dir: pathlib.Path,
    stego_method: str,
    points: typing.Sequence[typing.Tuple[int, int]],
    outfile: pathlib.Path,
    vlim: float = None,
    fast_conv=False,
    reader: typing.Callable = imread_gray_u8,
    device=None,
) -> typing.Optional[pathlib.Path]:
    """2x2 coolwarm grid of the patches at four points, saved to
    ``outfile`` (returned).  The JAX package reloads the run for each
    point; here it is loaded once, with the same numbers.  The patches
    are computed in any case; without matplotlib, one line on stderr says
    the figure was not drawn, and the result is None."""
    if vlim is None:
        vlim = 1.0 if stego_method == "dropout" else 0.5
    patches = saliency_patches(fname, points, model_dir, stego_method,
                               fast_conv=fast_conv, reader=reader,
                               device=device)
    mods = plotting("saliency", outfile, "matplotlib.pyplot")
    if mods is None:
        return None
    _, plt = mods
    fig, ax = plt.subplots(2, 2)
    im = None
    for idx, sal in enumerate(patches):
        im = ax[idx // 2, idx % 2].imshow(
            sal, vmin=-vlim, vmax=vlim, cmap="coolwarm")
    fig.subplots_adjust(right=0.85)
    cbar_ax = fig.add_axes([0.88, 0.15, 0.04, 0.7])
    fig.colorbar(im, cax=cbar_ax)
    outfile = pathlib.Path(outfile)
    outfile.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(outfile, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return outfile
