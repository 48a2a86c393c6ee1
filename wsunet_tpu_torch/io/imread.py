"""Image readers (port of ``wsunet_tpu/io/imread.py``), on the port's
own PNG decoder (``io.png``): no PIL or OpenCV.  ``image_size`` reads a
PNG's size from its IHDR chunk (any bit depth, interlaced or not), and
opens any other format with PIL where PIL is installed; otherwise it
raises ``UserError`` naming the file.

Each returns what the JAX package's reader returns for the same file:
``imread_u8`` PIL's array (palette indices for a palette image) with a
channel axis; ``imread4_*`` stacks [R, G, B, Y] where R, G, B are the
planes OpenCV reads (gray repeated, the palette looked up, alpha
dropped) and Y is OpenCV's BGR->GRAY luminance; ``imread_gray_u8`` is
PIL's array for a one-sample image, else the same BT.601 fixed-point
luminance of its first three planes (for grayscale PNGs all four planes
are equal).
"""

import pathlib
import typing

import numpy as np

from ..utils.errors import UserError
from .png import png_size, read, read_png


def _luma(r, g, b) -> np.ndarray:
    """OpenCV's BT.601 luminance: shift-15 coefficients, round half up."""
    r, g, b = (v.astype("int64") for v in (r, g, b))
    y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
    return y.clip(0, 255).astype("uint8")


def imread_u8(fname) -> np.ndarray:
    """Read image to HxWxC uint8 (C=1 for grayscale)."""
    x = read_png(fname)
    if x.ndim == 2:
        x = x[..., None]
    return x


def imread_f32(fname) -> np.ndarray:
    return imread_u8(fname).astype("float32")


def imread4_u8(fname) -> np.ndarray:
    """Read image to HxWx4 uint8 channels [R, G, B, Y]."""
    rgb = read(fname).rgb()
    y = _luma(rgb[..., 0], rgb[..., 1], rgb[..., 2])[..., None]
    return np.concatenate([rgb, y], axis=-1)


def imread4_f32(fname) -> np.ndarray:
    return imread4_u8(fname).astype("float32")


def imread_gray_u8(fname) -> np.ndarray:
    """Luminance plane as HxW uint8; colour sources use OpenCV's BT.601
    fixed-point rounding (shift-15 coefficients, round half up)."""
    x = read_png(fname)
    if x.ndim == 2:
        return x
    return _luma(x[..., 0], x[..., 1], x[..., 2])


def image_size(path) -> typing.Tuple[int, int]:
    """(width, height) of an image file, as PIL's ``Image.open(path).size``
    gives it: a PNG's from its IHDR, any other format's through PIL."""
    path = pathlib.Path(path)
    if path.suffix.lower() == ".png":
        return png_size(path)
    try:
        from PIL import Image
    except ImportError:
        raise UserError(f"{path}: only PNG sizes are read without PIL, "
                        f"which is not installed") from None
    with Image.open(path) as im:
        return im.size
