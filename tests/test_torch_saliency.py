"""Port parity of the saliency analysis (wsunet_tpu_torch.analyses) against
wsunet_tpu.analyses.saliency, on the CPU, f32.

The patches come from the committed LSBR ``unet_2`` checkpoint: the JAX
side restores it itself (``unet_saliency(fname, i, j, "models/unet",
"LSBR")``); the port's model-level ``saliency_patch`` gets the same params
through ``models.convert``, its name-based ``unet_saliency`` (and the
``saliency`` subcommand) reads the exported run under ``weights/unet``.
Tolerance on the (2n+1)^2 gradient patch (values up to ~0.8): atol 1e-6
for ``fast_conv=False``, the route the JAX side takes on the CPU (<=2e-7
seen).  The fast routes sum their convs in another order; where a 2x2
max-pool window holds two values within ~1e-6 of each other, that can
move the pooled maximum, and the gradient, to the other element: 4.6e-5
seen at (20, 30), <=2e-7 elsewhere.  So atol 1e-4 there.

``render_dots`` writes its RGB PNG with the port's own encoder
(``io.png.write_png``): its pixels are JAX's PIL file's, its bytes need
not be.  Where matplotlib cannot be imported, ``saliency`` still computes
the patches, says on stderr that the grid was not drawn, and writes the
dots file.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax

from wsunet_tpu.analyses.saliency import sobel_locations as jax_sobel
from wsunet_tpu.analyses.saliency import unet_saliency as jax_saliency
from wsunet_tpu.ws.unet_eval import load_pretrained_unet
from wsunet_tpu.analyses.saliency import render_dots as jax_render_dots
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu_torch.analyses import (saliency_patch, sobel_locations,
                                       unet_saliency)
from wsunet_tpu_torch.analyses.saliency import (plot_saliency_grid,
                                                render_dots)
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.io import imread_gray_u8
from wsunet_tpu_torch.models import get_model, unet_state_dict_from_flax
from wsunet_tpu_torch.ops import fused_reflect_conv
from wsunet_tpu_torch.utils.errors import UserError
from torch_p128 import run_without_host_packages

REPO = pathlib.Path(__file__).resolve().parents[1]
MODEL_DIR = REPO / "models" / "unet"
PORT_MODELS = REPO / "weights" / "unet"
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
        got = saliency_patch(model, img, i, j, device="cpu")
        assert got.shape == (17, 17) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert fused_reflect_conv.launches == 0  # the CPU takes the plain version


def test_unet_saliency_patch_size_and_model_left_clean(state_dict):
    model = get_model("unet_2", fast_conv=True)
    model.load_state_dict(state_dict)
    img = imread_gray_u8(IMAGE)
    got = saliency_patch(model, img, 64, 64, n=3, device="cpu")
    assert got.shape == (7, 7) and np.abs(got).max() > 0
    assert all(p.grad is None for p in model.parameters())


def test_sobel_locations_match_jax():
    want = jax_sobel(IMAGE)
    got = sobel_locations(IMAGE, device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(map(int, got[key])) == tuple(map(int, want[key])), key


def test_unet_saliency_device_rule():
    model = get_model("unet_0")
    img = np.zeros((16, 16), np.uint8)
    if not torch.cuda.is_available():
        with pytest.raises(UserError, match="device='cpu'"):
            saliency_patch(model, img, 8, 8)
    with pytest.raises(UserError):
        saliency_patch(model.to("meta"), img, 8, 8, device="cpu")
    with pytest.raises(ValueError):
        saliency_patch(get_model("unet_0"), np.zeros((1, 16, 16), np.uint8),
                       8, 8, device="cpu")


@pytest.mark.parametrize("fast_conv, atol", [(False, 1e-6), (True, 1e-4)])
def test_named_unet_saliency_matches_jax(jax_patches, fast_conv, atol):
    """The JAX signature: the run found by name under weights/unet."""
    for (i, j), want in jax_patches.items():
        got = unet_saliency(IMAGE, i, j, PORT_MODELS, "LSBR",
                            fast_conv=fast_conv, device="cpu")
        assert got.shape == (17, 17)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_sobel_locations_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UserError, match="device='cpu'"):
        sobel_locations(IMAGE)
    with pytest.raises(UserError, match="device='cpu'"):
        unet_saliency(IMAGE, 20, 30, PORT_MODELS)


def test_render_dots_writes_jax_pixels(tmp_path):
    from PIL import Image

    got = render_dots(IMAGE, tmp_path / "port.png", device="cpu")
    want = jax_render_dots(IMAGE, tmp_path / "jax.png")
    a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
    assert a.shape == (128, 128, 3)
    np.testing.assert_array_equal(a, b)
    assert (a == [255, 0, 0]).all(-1).sum() >= 1


def test_cli_saliency_writes_jax_files(jax_patches, tmp_path):
    """``saliency`` at four points of a p128 cover: the grid and the dots
    figure, the dots pixel for pixel JAX's; the grid's patches are
    ``plot_saliency_grid``'s (one load for the four points)."""
    from PIL import Image

    points = json.dumps([list(p) for p in POINTS] + [[9, 25]])
    args = ["--data", str(IMAGE.parents[1]), "--image", "images/6_00.png",
            "--points", points]
    assert jax_main(["saliency", *args, "--results", str(tmp_path / "jax"),
                     "--model-dir", str(MODEL_DIR)]) == 0
    assert torch_main(["saliency", *args, "--results", str(tmp_path / "pt"),
                       "--device", "cpu", "--fast-conv"]) == 0
    names = sorted(p.name for p in (tmp_path / "pt/prediction").iterdir())
    assert names == sorted(
        p.name for p in (tmp_path / "jax/prediction").iterdir()) == [
            "saliency_LSBR.png", "saliency_image_dots.png"]
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "pt/prediction/"
                              "saliency_image_dots.png")),
        np.asarray(Image.open(tmp_path / "jax/prediction/"
                              "saliency_image_dots.png")))
    with pytest.raises(SystemExit, match="does not support --split"):
        torch_main(["saliency", *args, "--split", "split_tr.csv",
                    "--device", "cpu"])


def test_plot_saliency_grid_loads_the_run_once(tmp_path, monkeypatch):
    from wsunet_tpu_torch.analyses import saliency

    loads = []
    load = saliency.load_pretrained_unet

    def counting(*args, **kwargs):
        loads.append(args)
        return load(*args, **kwargs)

    monkeypatch.setattr(saliency, "load_pretrained_unet", counting)
    out = plot_saliency_grid(IMAGE, PORT_MODELS, "LSBR",
                             POINTS + [(9, 25)], tmp_path / "g.png",
                             device="cpu")
    assert out.stat().st_size > 0 and len(loads) == 1


def test_cli_saliency_without_host_packages(tmp_path):
    """``saliency --fast-conv`` in a process where pandas, PIL, cv2,
    matplotlib and seaborn cannot be imported: the grid is named on
    stderr as not drawn, and the dots file decodes to JAX's pixels, red
    at the four points."""
    from PIL import Image

    from wsunet_tpu_torch.io.png import read_png

    points = json.dumps([list(p) for p in POINTS] + [[9, 25]])
    proc = run_without_host_packages(
        ["saliency", "--data", IMAGE.parents[1], "--image",
         "images/6_00.png", "--points", points, "--results", tmp_path,
         "--device", "cpu", "--fast-conv"], tmp_path)
    assert "saliency_LSBR.png not drawn" in proc.stderr
    out = tmp_path / "prediction"
    assert sorted(p.name for p in out.iterdir()) == [
        "saliency_image_dots.png"]
    want = jax_render_dots(IMAGE, tmp_path / "jax.png")
    got = read_png(out / "saliency_image_dots.png")
    np.testing.assert_array_equal(got, np.asarray(Image.open(want)))
    for loc in jax_sobel(IMAGE).values():
        assert tuple(got[tuple(map(int, loc[:2]))]) == (255, 0, 0)
