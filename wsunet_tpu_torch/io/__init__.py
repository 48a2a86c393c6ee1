from .imread import (image_size, imread4_f32, imread4_u8, imread_f32,
                     imread_gray_u8, imread_u8)

__all__ = [
    "imread_u8",
    "imread_f32",
    "imread4_u8",
    "imread4_f32",
    "imread_gray_u8",
    "image_size",
]
