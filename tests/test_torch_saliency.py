"""Port parity of the saliency analysis (wsunet_tpu_torch.analyses) against
wsunet_tpu.analyses.saliency, on the CPU, f32.

``unet_saliency`` runs on the committed LSBR ``unet_2`` checkpoint: the JAX
side restores it itself (``unet_saliency(fname, i, j, "models/unet",
"LSBR")``), the port gets the same params through ``models.convert``.
Tolerance on the (2n+1)^2 gradient patch (values up to ~0.8): atol 1e-6
for ``fast_conv=False``, the route the JAX side takes on the CPU (<=2e-7
seen).  The fast routes sum their convs in another order; where a 2x2
max-pool window holds two values within ~1e-6 of each other, that can
move the pooled maximum, and the gradient, to the other element: 4.6e-5
seen at (20, 30), <=2e-7 elsewhere.  So atol 1e-4 there.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax

from wsunet_tpu.analyses.saliency import sobel_locations as jax_sobel
from wsunet_tpu.analyses.saliency import unet_saliency as jax_saliency
from wsunet_tpu.ws.unet_eval import load_pretrained_unet
from wsunet_tpu_torch.analyses import sobel_locations, unet_saliency
from wsunet_tpu_torch.io import imread_gray_u8
from wsunet_tpu_torch.models import get_model, unet_state_dict_from_flax
from wsunet_tpu_torch.ops import fused_reflect_conv
from wsunet_tpu_torch.utils.errors import UserError

REPO = pathlib.Path(__file__).resolve().parents[1]
MODEL_DIR = REPO / "models" / "unet"
IMAGE = REPO / "data_ablation" / "p128" / "images" / "6_00.png"
POINTS = [(20, 30), (64, 64), (100, 110)]


@pytest.fixture(scope="module")
def state_dict():
    ckpt = MODEL_DIR / "LSBR"
    run = sorted(p.name for p in ckpt.iterdir())[0]
    _, variables, config = load_pretrained_unet(ckpt, run)
    assert config["network"] == "unet_2"
    return unet_state_dict_from_flax(
        jax.tree.map(np.asarray, variables["params"]))


@pytest.fixture(scope="module")
def jax_patches():
    return {p: jax_saliency(IMAGE, *p, MODEL_DIR, "LSBR") for p in POINTS}


@pytest.mark.parametrize("fast_conv, atol", [
    (False, 1e-6), ("borderfix", 1e-4), (True, 1e-4)])
def test_unet_saliency_matches_jax(state_dict, jax_patches, fast_conv, atol):
    model = get_model("unet_2", fast_conv=fast_conv)
    model.load_state_dict(state_dict)
    img = imread_gray_u8(IMAGE)
    fused_reflect_conv.reset_launches()
    for (i, j), want in jax_patches.items():
        got = unet_saliency(model, img, i, j, device="cpu")
        assert got.shape == (17, 17) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert fused_reflect_conv.launches == 0  # the CPU takes the plain version


def test_unet_saliency_patch_size_and_model_left_clean(state_dict):
    model = get_model("unet_2", fast_conv=True)
    model.load_state_dict(state_dict)
    img = imread_gray_u8(IMAGE)
    got = unet_saliency(model, img, 64, 64, n=3, device="cpu")
    assert got.shape == (7, 7) and np.abs(got).max() > 0
    assert all(p.grad is None for p in model.parameters())


def test_sobel_locations_match_jax():
    want = jax_sobel(IMAGE)
    got = sobel_locations(IMAGE)
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(map(int, got[key])) == tuple(map(int, want[key])), key


def test_unet_saliency_device_rule():
    model = get_model("unet_0")
    img = np.zeros((16, 16), np.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(UserError, match="device='cpu'"):
            unet_saliency(model, img, 8, 8)
    with pytest.raises(UserError):
        unet_saliency(model.to("meta"), img, 8, 8, device="cpu")
    with pytest.raises(ValueError):
        unet_saliency(get_model("unet_0"), np.zeros((1, 16, 16), np.uint8),
                      8, 8, device="cpu")
