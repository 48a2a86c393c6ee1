"""Image reading (the part of ``wsunet_tpu/io/imread.py`` the port needs).

PIL is imported inside the function that reads a file, so importing this
module needs no PIL.
"""

import numpy as np


def imread_gray_u8(path) -> np.ndarray:
    """Luminance plane as HxW uint8; colour sources use OpenCV's BT.601
    fixed-point rounding (as ``wsunet_tpu/io/imread.py``)."""
    from PIL import Image

    x = np.array(Image.open(path))
    if x.ndim == 2:
        return x
    r, g, b = (x[..., i].astype("int64") for i in range(3))
    y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
    return y.clip(0, 255).astype("uint8")
