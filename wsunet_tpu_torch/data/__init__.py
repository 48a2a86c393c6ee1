from .catalog import (collect_files, cover_stego_pairs, covers, order_rows,
                      precovers, resolve_path, stego_spatial)
from .pipeline import Batch, iterate_batches, load_images
from .transforms import center_crop

__all__ = [
    "collect_files",
    "precovers",
    "covers",
    "stego_spatial",
    "cover_stego_pairs",
    "order_rows",
    "resolve_path",
    "load_images",
    "iterate_batches",
    "Batch",
    "center_crop",
]
