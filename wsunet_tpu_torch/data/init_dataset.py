"""Dataset bootstrap (port of ``wsunet_tpu/data/init_dataset.py``): the
``files.csv`` catalog of a folder of cover images and the split CSVs.

    data/
      images/           <- the covers (png/jpg)
      images/files.csv  <- written here
      split_tr.csv / split_va.csv / split_te.csv

Splits are deterministic by the hash of the file stem (the per-image
seed), so re-running never reshuffles membership.  Sizes come from
``io.image_size``: a PNG's from its IHDR chunk (any bit depth, interlaced
or not, as PIL reads it); the other extensions of ``IMAGE_EXTS`` through
PIL where it is installed, and otherwise a ``UserError`` naming the file.
The CSVs are ``utils.table`` tables, and the files equal the JAX
package's byte for byte.
"""

import pathlib

import numpy as np

from ..io import image_size
from ..utils.seeding import filename_to_image_seed
from ..utils.table import Table, concat, from_rows, read_csv

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".pgm", ".tif", ".tiff"}


def init_dataset(
    data_root: pathlib.Path,
    images_dir: str = "images",
    split_fractions=(0.6, 0.2, 0.2),
) -> Table:
    """Write files.csv for ``data_root/images_dir`` and the split CSVs;
    return the catalog table.  The rows of ``stego*`` subdirectories with
    their own files.csv join the splits of their covers' stems (as
    ``pandas.concat`` joins them: a column the covers lack is empty in
    their rows, and an integer column a stego table lacks turns float)."""
    data_root = pathlib.Path(data_root)
    img_dir = data_root / images_dir
    rows = []
    for p in sorted(img_dir.iterdir()):
        if p.suffix.lower() not in IMAGE_EXTS:
            continue
        w, h = image_size(p)
        rows.append({"name": f"{images_dir}/{p.name}",
                     "height": h, "width": w})
    if not rows:
        raise FileNotFoundError(f"no images under {img_dir}")
    df = from_rows(rows)
    df.to_csv(img_dir / "files.csv")

    # deterministic split by stem hash
    tr_f, va_f, _ = split_fractions
    u = np.array([
        (filename_to_image_seed(n) % 10 ** 6) / 10 ** 6 for n in df["name"]])
    split = np.where(u < tr_f, "tr", np.where(u < tr_f + va_f, "va", "te"))

    stego_tables = []
    for sdir in sorted(data_root.glob("stego*")):
        fcsv = sdir / "files.csv"
        if fcsv.exists():
            stego_tables.append(read_csv(fcsv))
    for which in ["tr", "va", "te"]:
        names = set(df["name"][split == which])
        stems = {pathlib.Path(n).stem for n in names}
        parts = [df[np.isin(df["name"], list(names))]]
        for sf in stego_tables:
            parts.append(sf[np.array([pathlib.Path(n).stem in stems
                                      for n in sf["name"]], bool)])
        concat(parts).to_csv(data_root / f"split_{which}.csv")
    return df
