"""Image readers (port of ``wsunet_tpu/io/imread.py``).

``imread4_*`` stacks [R, G, B, Y] where Y is OpenCV's BGR->GRAY
luminance; ``imread_gray_u8`` decodes the Y plane alone (for grayscale
PNGs all four planes are equal).  PIL and cv2 are imported inside the
functions that read a file, so importing this module needs neither: the
card's machine has no PIL, and decodes with ``io.native`` where it builds.
"""

import numpy as np


def imread_u8(fname) -> np.ndarray:
    """Read image to HxWxC uint8 (C=1 for grayscale)."""
    from PIL import Image

    x = np.array(Image.open(fname))
    if x.ndim == 2:
        x = x[..., None]
    return x


def imread_f32(fname) -> np.ndarray:
    return imread_u8(fname).astype("float32")


def imread4_u8(fname) -> np.ndarray:
    """Read image to HxWx4 uint8 channels [R, G, B, Y]."""
    import cv2

    x_bgr = cv2.imread(str(fname))
    if x_bgr is None:
        raise FileNotFoundError(fname)
    x_y = cv2.cvtColor(x_bgr, cv2.COLOR_BGR2GRAY)[..., None]
    return np.concatenate([x_bgr[..., ::-1], x_y], axis=-1)


def imread4_f32(fname) -> np.ndarray:
    return imread4_u8(fname).astype("float32")


def imread_gray_u8(fname) -> np.ndarray:
    """Luminance plane as HxW uint8; colour sources use OpenCV's BT.601
    fixed-point rounding (shift-15 coefficients, round half up)."""
    from PIL import Image

    x = np.array(Image.open(fname))
    if x.ndim == 2:
        return x
    r, g, b = (x[..., i].astype("int64") for i in range(3))
    y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
    return y.clip(0, 255).astype("uint8")
