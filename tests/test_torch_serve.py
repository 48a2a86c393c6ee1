"""The slice as a whole: U-Net WS serving, the U-Net batch step and the
filter attack sweep of wsunet_tpu_torch against wsunet_tpu, on the CPU;
the device rule of the entry points; and the port's imports.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsunet_tpu.models import get_model as jax_get_model
from wsunet_tpu.ops import (NAMED_FILTERS_2D, ws_attack, ws_attack_sca,
                            ws_estimate_unet)
from wsunet_tpu.serve import UNetWSServer as JaxServer
from wsunet_tpu.ws.unet_eval import infer_unet as jax_infer_unet
from wsunet_tpu_torch.models import get_model, unet_state_dict_from_flax
from wsunet_tpu_torch.ops import fused_ws
from wsunet_tpu_torch.serve import (UNetWSServer, measure_latency,
                                    stream_paths)
from wsunet_tpu_torch.utils.errors import UserError
from wsunet_tpu_torch.ws import (attack_batches, infer_unet,
                                 parse_filter_model, predict_batch)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    """unet_1 with the same (Flax-initialised) weights in both packages."""
    jmodel = jax_get_model("unet_1")
    v = jmodel.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, 64, 64, 1), jnp.float32))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
        .astype(np.float32), v["params"])
    tmodel = get_model("unet_1")
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    return jmodel, {"params": params}, tmodel


def _images(n, size=64, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size), dtype=np.uint8)
            for _ in range(n)]


def test_server_f32_matches_jax_server(models):
    jmodel, variables, tmodel = models
    jsrv = JaxServer(jmodel, variables, size=64, compute_dtype=jnp.float32)
    tsrv = UNetWSServer(tmodel, size=64, compute_dtype=torch.float32,
                        device="cpu")
    for img in _images(3):
        # the JAX server runs its f32 stack at DEFAULT precision; beta and
        # l1 are means over the image of residuals of ~1e-2 magnitude
        np.testing.assert_allclose(tsrv.predict(img), jsrv.predict(img),
                                   rtol=1e-4, atol=1e-5)


def test_server_bf16_tracks_f32(models):
    _, _, tmodel = models
    f32 = UNetWSServer(tmodel, size=64, compute_dtype=torch.float32,
                       device="cpu")
    bf16 = UNetWSServer(tmodel, size=64, device="cpu")
    assert next(tmodel.parameters()).dtype == torch.float32  # not cast
    img = _images(1)[0]
    (b32, l32), (b16, l16) = f32.predict(img), bf16.predict(img)
    assert abs(b16 - b32) < 5e-3 and abs(l16 - l32) < 5e-1


def test_predict_many_keeps_order(models):
    _, _, tmodel = models
    srv = UNetWSServer(tmodel, size=64, compute_dtype=torch.float32,
                       device="cpu")
    imgs = _images(9, seed=2)
    serial = [srv.predict(im) for im in imgs]
    streamed = list(srv.predict_many(iter(imgs), depth=3))
    np.testing.assert_array_equal(np.asarray(streamed), np.asarray(serial))
    assert len(set(serial)) == len(serial)


def test_server_rejects_wrong_shape(models):
    srv = UNetWSServer(models[2], size=64, compute_dtype=torch.float32,
                       device="cpu")
    with pytest.raises(ValueError):
        srv.predict(np.zeros((32, 64), np.uint8))


def test_measure_latency_reports_floor(models):
    srv = UNetWSServer(get_model("unet_0"), size=32, device="cpu")
    out = measure_latency(srv, reps=3)
    assert {"latency_ms_b1", "rtt_floor_ms", "latency_ms_b1_net",
            "serial_images_per_sec", "streamed_images_per_sec",
            "stream_speedup"} <= set(out)
    assert out["latency_ms_b1"] > 0
    assert out["latency_ms_b1_net"] <= out["latency_ms_b1"]
    assert out["streamed_images_per_sec"] > 0


def test_stream_paths_errors_inline(models, tmp_path):
    from PIL import Image

    srv = UNetWSServer(models[2], size=64, compute_dtype=torch.float32,
                       device="cpu")
    imgs = _images(3, seed=4)
    paths = []
    for i, img in enumerate(imgs):
        p = tmp_path / f"g{i}.png"
        Image.fromarray(img, mode="L").save(p)
        paths.append(str(p))
    bad = tmp_path / "bad.png"
    Image.fromarray(np.zeros((32, 32), np.uint8), mode="L").save(bad)
    order = [paths[0], str(tmp_path / "missing.png"), paths[1], str(bad),
             paths[2]]
    rows = list(stream_paths(srv, order, depth=2))
    assert [r["name"] for r in rows] == order
    assert "error" in rows[1] and "error" in rows[3]
    for r, img in zip([rows[0], rows[2], rows[4]], imgs):
        assert (r["beta_hat"], r["l1"]) == srv.predict(img)


def test_predict_batch_matches_jax_step(models):
    """The U-Net batch step (JAX ``_predict_frame``'s step) on the same
    weights: infer_unet -> center crop -> ws_estimate_unet."""
    jmodel, variables, tmodel = models
    x = np.stack(_images(2, seed=5))
    xj = jnp.asarray(x, jnp.float32)
    jb, jl1 = ws_estimate_unet(xj, jax_infer_unet(jmodel, variables, xj))
    tb, tl1 = predict_batch(tmodel, x, device="cpu")
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-4)
    pred = infer_unet(tmodel, x.astype(np.float32), device="cpu")
    assert pred.shape == (2, 62, 62) and pred.dtype == torch.float32


@pytest.mark.parametrize("model_name, correct_bias", [
    ("KB", False), ("KB-w", False), ("AVG", True), ("AVG9-w", False)])
def test_attack_sweep_matches_jax_per_batch(model_name, correct_bias):
    name, weighted, sca = parse_filter_model(model_name)
    assert not sca
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 256, (b, 40, 48), dtype=np.uint8)
               for b in (3, 3, 2)]
    fused_ws.reset_launches()
    got = attack_batches(batches, kernel_name=name, weighted=weighted,
                         correct_bias=correct_bias, device="cpu")
    assert fused_ws.launches == 0  # the CPU takes ws_attack
    want = np.concatenate([np.asarray(ws_attack(
        jnp.asarray(b), pixel_kernel=NAMED_FILTERS_2D[name],
        weighted=weighted, correct_bias=correct_bias)) for b in batches])
    assert got.dtype == np.float64 and got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_attack_sweep_with_pixel_estimator():
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 256, (2, 20, 20), dtype=np.uint8)]
    got = attack_batches(batches, pixel_estimator=lambda v: v[:, 1:-1, 1:-1]
                         * 0.5, device="cpu")
    want = np.asarray(ws_attack(jnp.asarray(batches[0]), pixel_estimator=
                                lambda v: v[:, 1:-1, 1:-1] * 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert attack_batches([], kernel_name="KB", device="cpu").shape == (0,)
    # the -sca score is served: the plain ws_attack_sca
    np.testing.assert_allclose(
        attack_batches(batches, kernel_name="KB", sca=True, device="cpu"),
        np.asarray(ws_attack_sca(jnp.asarray(batches[0]),
                                 pixel_kernel=NAMED_FILTERS_2D["KB"])),
        rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        attack_batches([np.zeros((2, 8, 8, 4), np.uint8)], kernel_name="KB",
                     device="cpu")


@pytest.mark.parametrize("name, want", [
    ("KB", ("KB", 0, False)), ("KB-w", ("KB", 1, False)),
    ("AVG9-w", ("AVG9", 1, False)), ("KB-sca", ("KB", 0, True)),
    ("OLS", ("OLS", 0, False)), ("UNet-w", ("UNet-w", 0, False))])
def test_parse_filter_model(name, want):
    assert parse_filter_model(name) == want


def test_entry_points_without_device_raise_on_cpu_box(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    tmodel = models[2]
    x = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises(UserError, match="device='cpu'"):
        UNetWSServer(tmodel, size=16)
    with pytest.raises(UserError):
        attack_batches([x], kernel_name="KB")
    with pytest.raises(UserError):
        infer_unet(tmodel, x.astype(np.float32))
    with pytest.raises(UserError):
        predict_batch(tmodel, x)
    with pytest.raises(UserError):
        UNetWSServer(tmodel, size=16, device="cuda")


def test_infer_unet_rejects_model_on_other_device():
    tmodel = get_model("unet_0").to("meta")
    with pytest.raises(UserError):
        infer_unet(tmodel, np.zeros((1, 16, 16), np.float32), device="cpu")


def test_port_imports_no_jax_pandas_pil_or_triton():
    code = (
        "import sys, wsunet_tpu_torch\n"
        "from wsunet_tpu_torch import _device, io, serve\n"
        "from wsunet_tpu_torch.analyses import saliency\n"
        "from wsunet_tpu_torch.data import transforms\n"
        "from wsunet_tpu_torch.models import unet, convert\n"
        "from wsunet_tpu_torch.ops import filters, ws, fused_ws\n"
        "from wsunet_tpu_torch.ops import (_cuda_build, reflect_conv,\n"
        "                                  fused_reflect_conv)\n"
        "from wsunet_tpu_torch.utils import errors\n"
        "from wsunet_tpu_torch.ws import estimate, unet_eval\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'wsunet_tpu', 'pandas', 'PIL', 'cv2',"
        " 'triton'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
