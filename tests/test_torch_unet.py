"""Port parity: the U-Net (wsunet_tpu_torch.models) against the Flax
U-Net (wsunet_tpu.models), on the CPU, f32.

Flax parameters go through ``unet_state_dict_from_flax`` (numpy only)
into the torch model.  Random weights: atol 1e-5 on the sigmoid output,
where both sides compute in f32 and differ in the order of the conv sums
(~1e-7 seen).  The committed LSBR checkpoint: atol 1e-4 on the output,
the bound set for trained weights before it was measured (2.4e-7 seen).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wsunet_tpu.models import get_model as jax_get_model
from wsunet_tpu_torch.models import (get_model, init_unet,
                                     unet_state_dict_from_flax)

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT_DIR = REPO / "models" / "unet" / "LSBR"
P128 = REPO / "data_ablation" / "p128" / "images"


def _flax_params(nsteps, seed=3, disable_center=False, size=64):
    """Flax init plus small noise on every leaf (so the biases, zero at
    init, and the center tap are exercised)."""
    model = jax_get_model(f"unet_{nsteps}", disable_center=disable_center)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, size, size, 1), jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
        .astype(np.float32), v["params"])
    return model, params


def _torch_forward(model, x_nhwc):
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc[..., 0])[:, None])
    return y[:, 0].numpy()


@pytest.mark.parametrize("nsteps", [0, 1, 2])
def test_forward_matches_jax_on_random_weights(nsteps):
    jmodel, params = _flax_params(nsteps)
    x = np.random.default_rng(0).random((2, 64, 64, 1), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = get_model(f"unet_{nsteps}")
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    np.testing.assert_allclose(_torch_forward(tmodel, x), want[..., 0],
                               atol=1e-5, rtol=0)


def test_conv_transpose_taps_are_flipped():
    """The Flax ConvTranspose kernel maps to torch with both spatial axes
    flipped: the converter's mapping matches JAX, the unflipped one does
    not."""
    jmodel, params = _flax_params(1)
    x = np.random.default_rng(1).random((1, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))[..., 0]
    sd = unet_state_dict_from_flax(params)
    np.testing.assert_array_equal(
        sd["up1.weight"].numpy(),
        np.asarray(params["up1"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
    tmodel = get_model("unet_1")
    tmodel.load_state_dict(sd)
    np.testing.assert_allclose(_torch_forward(tmodel, x), want, atol=1e-5)
    sd["up1.weight"] = sd["up1.weight"].flip(2, 3).contiguous()
    tmodel.load_state_dict(sd)
    assert np.abs(_torch_forward(tmodel, x) - want).max() > 1e-3


@pytest.mark.parametrize("name, count", [
    ("unet_0", None), ("unet_1", None), ("unet_2", 1_861_697)])
def test_param_count_matches_jax(name, count):
    tmodel = get_model(name)
    n = sum(p.numel() for p in tmodel.parameters())
    jmodel = jax_get_model(name)
    v = jmodel.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, 32, 32, 1), jnp.float32))
    assert n == sum(int(np.prod(p.shape))
                    for p in jax.tree.leaves(v["params"]))
    if count is not None:
        assert n == count
    assert set(tmodel.state_dict()) == \
        set(unet_state_dict_from_flax(jax.tree.map(np.asarray, v["params"])))


def test_disable_center_matches_jax_and_blocks_center_gradient():
    jmodel, params = _flax_params(1, disable_center=True)
    assert np.asarray(params["e1_conv1_kernel"])[1, 1, 0, 0] != 0.0
    x = np.random.default_rng(2).random((1, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = get_model("unet_1", disable_center=True)
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    np.testing.assert_allclose(_torch_forward(tmodel, x), want[..., 0],
                               atol=1e-5)
    # without the mask the center tap changes the output
    plain = get_model("unet_1")
    plain.load_state_dict(unet_state_dict_from_flax(params))
    assert np.abs(_torch_forward(plain, x) - want[..., 0]).max() > 1e-4
    # and with it the center tap gets no gradient
    xt = torch.from_numpy(x[..., 0])[:, None]
    tmodel(xt).pow(2).sum().backward()
    g = tmodel.e1_conv1.weight.grad
    assert torch.all(g[:, :, 1, 1] == 0) and torch.any(g != 0)


def test_committed_checkpoint_matches_jax():
    """The committed LSBR unet_2, restored through the JAX package's
    checkpoint loader and converted, predicts a p128 cover as JAX does."""
    from PIL import Image
    from wsunet_tpu.ws.unet_eval import load_pretrained_unet

    run = sorted(p.name for p in CKPT_DIR.iterdir()
                 if p.name.startswith("260819071329-"))[0]
    jmodel, variables, config = load_pretrained_unet(CKPT_DIR, run)
    assert config["network"] == "unet_2"
    params = jax.tree.map(np.asarray, variables["params"])
    img = np.array(Image.open(sorted(P128.glob("*.png"))[0]).convert("L"))
    x = (img.astype(np.float32) / 255.0)[None, :, :, None]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = get_model("unet_2")
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    got = _torch_forward(tmodel, x)
    np.testing.assert_allclose(got, want[..., 0], atol=1e-4, rtol=0)
    assert np.abs(got - x[..., 0]).mean() < 0.05  # it predicts the cover


def test_init_unet_is_seeded():
    a = init_unet(get_model("unet_1"), seed=5)
    b = init_unet(get_model("unet_1"), seed=5)
    c = init_unet(get_model("unet_1"), seed=6)
    for (ka, pa), (_, pb), (_, pc) in zip(a.state_dict().items(),
                                          b.state_dict().items(),
                                          c.state_dict().items()):
        assert torch.equal(pa, pb), ka
        if ka.endswith("weight"):
            assert not torch.equal(pa, pc), ka
            fan_in = pa.shape[1] * 9 if pa.shape[-1] == 3 else None
            if fan_in:
                assert abs(float(pa.std()) * fan_in ** 0.5 - 1.0) < 0.2


def test_bf16_compute_dtype_keeps_output_dtype():
    tmodel = init_unet(get_model("unet_1", compute_dtype=torch.bfloat16), 0)
    x = torch.rand((1, 1, 32, 32), generator=torch.Generator().manual_seed(0))
    ref = get_model("unet_1")
    ref.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        y, y32 = tmodel(x), ref(x)
    assert y.dtype == torch.float32 and y.shape == x.shape
    # bf16 keeps ~3 decimal digits through the conv stack
    assert float((y - y32).abs().max()) < 2e-2


def test_reflect_pad_splits_a_batch_past_32_bit_indexing(monkeypatch):
    """The default route pads a batch whose padded output holds more than
    ``PAD_MAX_ELEMENTS`` (F.pad's reflect mode indexes in 32 bits on
    CUDA, so a bf16 batch of 128 at 512x512 raised) a slice at a time,
    with the same result: here the limit is lowered to 3 images' worth."""
    from wsunet_tpu_torch.models import unet

    x = torch.from_numpy(np.random.default_rng(5).random(
        (7, 2, 30, 30), dtype=np.float32))
    want = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect")
    model = init_unet(get_model("unet_1"), seed=1).eval()
    with torch.no_grad():
        y_want = model(x[:, :1])
    chunks = []
    pad = torch.nn.functional.pad
    monkeypatch.setattr(unet, "PAD_MAX_ELEMENTS", 3 * 2 * 32 * 32)
    monkeypatch.setattr(unet.F, "pad", lambda c, *a, **k: (
        chunks.append(c.shape[0]), pad(c, *a, **k))[1])
    assert torch.equal(unet.reflect_pad(x), want)
    assert chunks == [3, 3, 1]
    with torch.no_grad():
        y = model(x[:, :1])
    assert torch.equal(y, y_want)


def test_get_model_rejects_unknown():
    with pytest.raises(NotImplementedError):
        get_model("b0")
    with pytest.raises(ValueError):
        get_model("unet_5")
