"""Dataset bootstrap (port of ``wsunet_tpu/data/init_dataset.py``): the
``files.csv`` catalog of a folder of cover images and the split CSVs.

    data/
      images/           <- the covers (png/jpg)
      images/files.csv  <- written here
      split_tr.csv / split_va.csv / split_te.csv

Splits are deterministic by the hash of the file stem (the per-image
seed), so re-running never reshuffles membership.  Host only: PIL reads
the image sizes and pandas writes the CSVs, both imported inside the
function; the files equal the JAX package's byte for byte.
"""

import pathlib

import numpy as np

from ..utils.seeding import filename_to_image_seed

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".pgm", ".tif", ".tiff"}


def init_dataset(
    data_root: pathlib.Path,
    images_dir: str = "images",
    split_fractions=(0.6, 0.2, 0.2),
):
    """Write files.csv for ``data_root/images_dir`` and the split CSVs;
    return the catalog frame.  The rows of ``stego*`` subdirectories with
    their own files.csv join the splits of their covers' stems."""
    import pandas as pd
    from PIL import Image

    data_root = pathlib.Path(data_root)
    img_dir = data_root / images_dir
    rows = []
    for p in sorted(img_dir.iterdir()):
        if p.suffix.lower() not in IMAGE_EXTS:
            continue
        with Image.open(p) as im:
            w, h = im.size
        rows.append({"name": f"{images_dir}/{p.name}",
                     "height": h, "width": w})
    if not rows:
        raise FileNotFoundError(f"no images under {img_dir}")
    df = pd.DataFrame(rows)
    df.to_csv(img_dir / "files.csv", index=False)

    # deterministic split by stem hash
    tr_f, va_f, _ = split_fractions
    u = np.array([
        (filename_to_image_seed(n) % 10 ** 6) / 10 ** 6 for n in df["name"]])
    split = np.where(u < tr_f, "tr", np.where(u < tr_f + va_f, "va", "te"))

    stego_frames = []
    for sdir in sorted(data_root.glob("stego*")):
        fcsv = sdir / "files.csv"
        if fcsv.exists():
            stego_frames.append(pd.read_csv(fcsv))
    for which in ["tr", "va", "te"]:
        names = set(df["name"][split == which])
        stems = {pathlib.Path(n).stem for n in names}
        parts = [df[df["name"].isin(names)]]
        for sf in stego_frames:
            parts.append(sf[sf["name"].apply(
                lambda n: pathlib.Path(n).stem in stems)])
        out = pd.concat(parts).reset_index(drop=True)
        out.to_csv(data_root / f"split_{which}.csv", index=False)
    return df
