"""Deterministic seeding helpers (port of ``wsunet_tpu/utils/seeding.py``).

``filename_to_image_seed`` is the JAX package's per-image seed, unchanged:
sha256 of the file stem, reduced mod 2**31.  ``seed_everything`` seeds
Python's and numpy's global generators and returns a seeded
``torch.Generator`` (the JAX version returns a ``PRNGKey``); randomness
in the port is drawn from explicit generators.
"""

import hashlib
import os
import pathlib
import random

import numpy as np
import torch


def filename_to_image_seed(filename) -> int:
    """Derive a deterministic 31-bit seed from a filename stem."""
    stem = pathlib.Path(filename).stem
    sha256 = hashlib.sha256(stem.encode("utf-8")).hexdigest()
    return int(sha256, base=16) % (2 ** 31)


def seed_everything(seed: int, device=None) -> torch.Generator:
    """Seed python/numpy global RNGs and return a torch generator on
    ``device`` (default: the CPU) seeded with ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)
