"""A small catalog for the port's parity tests: the first ``n`` covers of
``data_ablation/p128`` (128x128 grayscale PNGs) with their ``files.csv``,
and LSBr stego made by the JAX package's own ``simulate`` command, whose
``files.csv`` rows say ``stego_LSBR_...`` while the directories are
``stego_LSBr_...``."""

import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[1]
P128 = REPO / "data_ablation" / "p128"


def make_catalog(root: pathlib.Path, n: int = 12,
                 alphas=(0.1, 0.01)) -> pathlib.Path:
    from wsunet_tpu.cli import main as jax_main

    root = pathlib.Path(root)
    (root / "images").mkdir(parents=True)
    names = sorted(p.name for p in (P128 / "images").glob("*.png"))[:n]
    lines = ["name,height,width"]
    for name in names:
        shutil.copyfile(P128 / "images" / name, root / "images" / name)
        lines.append(f"images/{name},128,128")
    (root / "images" / "files.csv").write_text("\n".join(lines) + "\n")
    jax_main(["simulate", "--data", str(root), "--method", "LSBr",
              "--alphas", *map(str, alphas)])
    return root
