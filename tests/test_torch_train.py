"""Port parity: the U-Net trainer (wsunet_tpu_torch.train, models.unet's
dropout and initialiser, models.convert's inverse, ops.ws_estimate_inloss,
the meters) against the JAX package, on the CPU, small: data_ablation/p128
at crops of 32-64, ``unet_1`` / ``unet_2``, B = 4.

Tolerances (f32):

- losses and ``ws_estimate_inloss``, values and gradients with respect to
  the outputs: rel 1e-6 (gradients: of the largest gradient);
- UniformDropout given the same mask: 1e-6 (KB prediction sums 8 taps in
  another order);
- one full step's loss against JAX's ``_make_step`` on the same draws:
  rel 1e-5; each gradient tensor: max|d| / max|g| <= 1e-4, but for the
  two tensors where JAX's f32 gradient is itself further than that from
  JAX's float64 one (``JAX_F32_OFF``: there 1e-5 to JAX's float64
  gradient and 2e-4 to its f32 one).  JAX's
  gradients are read by handing ``_make_step`` an optimizer that returns
  them as its state (``scripts/export_torch_weights.grad_capture``); its
  draws are replayed from its key splits (``jax_step_draws``);
- AdamW and the cosine schedule fed the same gradients for 5 steps,
  against optax: params atol 1e-7;
- the converter's round trip: bitwise.
"""

import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_p128 import P128, REPO
from wsunet_tpu.data import load_images as jax_load_images
from wsunet_tpu.detect import metrics as jmet
from wsunet_tpu.models import get_model as jax_get_model
from wsunet_tpu.models.unet import kb_predict_nhwc
from wsunet_tpu.ops.ws import ws_estimate_inloss as jax_inloss
from wsunet_tpu.train import config as jcfg
from wsunet_tpu.train import losses as jloss
from wsunet_tpu.train import train_unet as jtrain
from wsunet_tpu.utils import create_run_name as jax_run_name
from wsunet_tpu_torch.detect import metrics as tmet
from wsunet_tpu_torch.models import (flax_params_from_unet_state_dict,
                                     get_model, init_unet, kb_predict,
                                     unet_state_dict_from_flax)
from wsunet_tpu_torch.models.unet import uniform_dropout
from wsunet_tpu_torch.ops import ws_estimate_inloss
from wsunet_tpu_torch.train import checkpoint as tck
from wsunet_tpu_torch.train import config as tcfg
from wsunet_tpu_torch.train import losses as tloss
from wsunet_tpu_torch.train import train_unet as ttrain
from wsunet_tpu_torch.train.checkpoint import flatten_tree
from wsunet_tpu_torch.utils import create_run_name, setup_logger
from wsunet_tpu_torch.utils.errors import UserError

NAMES = [f"images/{p.name}" for p in sorted((P128 / "images").glob("*.png"))]
GOLDEN = REPO / "weights" / "golden" / "p128_train_step.npz"
LSBR_RUN = REPO / "weights" / "unet" / "LSBR" / \
    "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_"


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPORT = _exporter()


def _loss_inputs(seed=0, B=4, H=12, W=10):
    """NHWC covers, stego inputs on the 1/255 grid (some x*255 exactly
    k + 0.5 to test half-to-even), outputs in (0, 1), per-image alphas."""
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 256, (B, H, W, 1))
    inp = np.where(rng.random(cov.shape) < 0.3, cov ^ 1, cov) / 255.0
    inp = inp.astype(np.float32)
    inp[0, 0, :4, 0] = (np.arange(4) + 0.5) / 255.0
    out = np.clip(inp + rng.normal(0, 0.01, inp.shape), 0, 1).astype(
        np.float32)
    alphas = np.array([0.0, 0.4, 0.1, 0.4], np.float32)[:B]
    return (cov / 255.0).astype(np.float32), inp, out, alphas


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("name, lam", [("l1", None), ("l2", None),
                                       ("ws", None), ("l1ws", None),
                                       ("l1ws", 0.25)])
@pytest.mark.parametrize("per_image", [True, False])
def test_losses_and_gradients_match_jax(name, lam, per_image):
    cov, inp, out, alphas = _loss_inputs()
    jfn = jloss.get_loss(name, per_image=per_image, loss_lambda=lam)
    tfn = tloss.get_loss(name, per_image=per_image, loss_lambda=lam)
    w = np.array([0.3, 1.0, -0.7, 2.0], np.float32)

    def jscalar(o):
        v = jfn(o, jnp.asarray(cov), jnp.asarray(inp), jnp.asarray(alphas))
        return jnp.sum(v * w) if per_image else v

    want, want_g = jax.value_and_grad(jscalar)(jnp.asarray(out))
    o = _nchw(out).requires_grad_(True)
    v = tfn(o, _nchw(cov), _nchw(inp), torch.from_numpy(alphas))
    got = torch.sum(v * torch.from_numpy(w)) if per_image else v
    got.backward()
    _close(float(got), float(want), 1e-6)
    _close(o.grad.numpy().transpose(0, 2, 3, 1), want_g, 1e-6)


def test_unknown_loss_raises():
    with pytest.raises(NotImplementedError, match="'dice'"):
        tloss.get_loss("dice")


@pytest.mark.parametrize("shape", [(4, 12, 10, 1), (2, 9, 7, 3)])
def test_ws_estimate_inloss_matches_jax(shape):
    _, inp, out, _ = _loss_inputs(1, shape[0], shape[1], shape[2])
    inp = np.repeat(inp, shape[3], -1)
    out = np.repeat(out, shape[3], -1)
    want, want_g = jax.value_and_grad(
        lambda o: jnp.sum(jax_inloss(jnp.asarray(inp), o) *
                          jnp.arange(1, shape[0] + 1)))(jnp.asarray(out))
    o = _nchw(out).requires_grad_(True)
    got = ws_estimate_inloss(_nchw(inp), o)
    torch.sum(got * torch.arange(1, shape[0] + 1)).backward()
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jax_inloss(jnp.asarray(inp),
                                                    jnp.asarray(out))),
        rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
    _close(o.grad.numpy().transpose(0, 2, 3, 1), want_g, 1e-6)
    # channel-free [B, H, W] inputs give the same estimate
    flat = ws_estimate_inloss(_nchw(inp)[:, 0], _nchw(out)[:, 0])
    want1 = jax_inloss(jnp.asarray(inp[..., :1]), jnp.asarray(out[..., :1]))
    np.testing.assert_allclose(flat.numpy(), np.asarray(want1), rtol=1e-6)


@pytest.mark.parametrize("c", [1, 3])
def test_kb_predict_and_dropout_core_match_jax(c):
    rng = np.random.default_rng(c)
    x = rng.random((2, 9, 11, c)).astype(np.float32)
    keep = rng.random((2, 9, 11, 1)) < 0.8
    kb = np.asarray(kb_predict_nhwc(jnp.asarray(x)))
    np.testing.assert_allclose(kb_predict(_nchw(x)).numpy(),
                               kb.transpose(0, 3, 1, 2), atol=1e-6)
    want = x * keep + kb * (1 - keep)
    got = uniform_dropout(_nchw(x), _nchw(keep))
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2),
                               atol=1e-6)


def _flax_params(name, seed, size=32, drop_rate=None):
    model = jax_get_model(name, drop_rate=drop_rate)
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed)},
                   jnp.zeros((1, size, size, 1), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
        .astype(np.float32), v["params"])


def test_unet_dropout_forward_matches_jax_on_its_mask():
    """The Flax U-Net with drop_rate 0.3 in training mode under a dropout
    key, and the port's on the keep mask that key gives (replayed through
    a probe module with the same name): the same outputs."""
    jmodel, params = _flax_params("unet_1", 2, drop_rate=0.3)
    x = np.random.default_rng(0).random((2, 32, 32, 1), dtype=np.float32)
    dk = jax.random.PRNGKey(9)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   deterministic=False,
                                   rngs={"dropout": dk}))
    keep = EXPORT.jax_dropout_keep(jax, dk, (2, 32, 32), 0.3)
    assert 0.6 < keep.mean() < 0.8
    tmodel = get_model("unet_1", drop_rate=0.3)
    tmodel.load_state_dict(unet_state_dict_from_flax(params))
    with torch.no_grad():
        got = tmodel.train()(_nchw(x), keep=torch.from_numpy(keep))
        plain = tmodel.eval()(_nchw(x))
    np.testing.assert_allclose(got[:, 0].numpy(), want[..., 0], atol=1e-5)
    det = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(plain[:, 0].numpy(), det[..., 0], atol=1e-5)


def test_uniform_dropout_draws_one_mask_for_every_channel():
    """The trainer's Sampler draws the keep mask (one [B, 1, H, W] plane,
    keep rate 1 - drop_rate); the module applies it to every channel in
    training mode, refuses to run there without it, and is the identity
    in eval mode and at rate 0."""
    from wsunet_tpu_torch.models import UniformDropout

    model = get_model("unet_0", drop_rate=0.25)
    sampler = ttrain.Sampler(model, None, None, None)
    keep = sampler.draw((4, 64, 64), torch.Generator().manual_seed(2))["keep"]
    assert keep.shape == (4, 1, 64, 64)
    drop = model.input_dropout.train()
    x = torch.rand((4, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    y = drop(x, keep=keep)
    kept = (y == x).all(dim=1)       # a dropped pixel changes (KB != x)
    assert torch.equal(kept, keep[:, 0])
    assert abs(float(kept.float().mean()) - 0.75) < 5 * np.sqrt(
        0.75 * 0.25 / kept.numel())
    kb = kb_predict(x)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1)[~kept].numpy(),
                                  kb.permute(0, 2, 3, 1)[~kept].numpy())
    with pytest.raises(ValueError, match="keep mask"):
        drop(x)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(UniformDropout(0.0)(x), x)


def test_init_unet_is_flax_lecun_normal():
    """Every kernel of the corrected init_unet has standard deviation
    1/sqrt(fan_in) and support +-2 sigma of the underlying normal, as
    Flax's truncated lecun_normal: checked on a full-width layer
    (e2.conv2, 128 -> 128, 147,456 taps) and against Flax's own draws
    by quantiles; the biases are zero."""
    model = init_unet(get_model("unet_2"), seed=0)
    w = model.e2.conv2.weight.detach().numpy().ravel()
    fan_in = 128 * 9
    std = 1 / np.sqrt(fan_in)
    assert abs(w.std() / std - 1) < 0.01
    bound = 2 * std / 0.87962566103423978
    assert np.abs(w).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() > 0.99 * bound
    flax = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, 128, 128), jnp.float32)).ravel()
    q = np.linspace(0.01, 0.99, 33)
    np.testing.assert_allclose(np.quantile(w, q), np.quantile(flax, q),
                               atol=0.02 * std)
    up = model.up1.weight.detach().numpy()      # fan_in = 128 * 2 * 2
    assert abs(up.std() * np.sqrt(128 * 4) - 1) < 0.02
    assert all(float(p.abs().max()) == 0 for n, p in model.named_parameters()
               if n.endswith("bias"))


@pytest.mark.parametrize("name", ["unet_0", "unet_1", "unet_2"])
def test_converter_round_trip_is_bitwise(name):
    _, params = _flax_params(name, 4)
    back = flax_params_from_unet_state_dict(unet_state_dict_from_flax(params))
    a = flatten_tree(jax.tree.map(np.asarray, params))
    b = flatten_tree(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# --- one full step against JAX's _make_step ---------------------------

STEP_CASES = {
    # the committed LSBR recipe at a small crop
    "lsbr": dict(crop=32, augment=True, stego_method="LSBR", alpha=0.4,
                 loss="l1ws", loss_lambda=0.25, weighted_loss=True),
    # HILLr embedding, no crop (64x64 covers), no augmentation
    "hillr": dict(crop=None, augment=False, stego_method="HILLR", alpha=0.4,
                  loss="l1ws", weighted_loss=False),
    # the committed dropout recipe: cover only, l1, UniformDropout 0.1
    "dropout": dict(crop=48, augment=True, stego_method=None, alpha=None,
                    loss="l1", drop_rate=0.1),
}


def _jax_step_and_grads(case, params, pixels, mask, key):
    cfg = STEP_CASES[case]
    jmodel = jax_get_model("unet_1", drop_rate=cfg.get("drop_rate"))
    jfn = jloss.get_loss(cfg["loss"], per_image=True,
                         loss_lambda=cfg.get("loss_lambda")
                         if cfg.get("weighted_loss") else None)
    cap = EXPORT.grad_capture()
    step = jtrain._make_step(jmodel, jfn, cap, cfg["stego_method"],
                             cfg["alpha"], crop=cfg["crop"],
                             augment=cfg["augment"])[0]
    _, grads, loss = step(params, cap.init(params), jnp.asarray(pixels),
                          jnp.asarray(mask), *key)
    return float(loss), flatten_tree(jax.tree.map(np.asarray, grads))


def _torch_sampler(case, params):
    cfg = STEP_CASES[case]
    model = get_model("unet_1", drop_rate=cfg.get("drop_rate"))
    model.load_state_dict(unet_state_dict_from_flax(params))
    fn = tloss.get_loss(cfg["loss"], per_image=True,
                        loss_lambda=cfg.get("loss_lambda")
                        if cfg.get("weighted_loss") else None)
    return model, ttrain.Sampler(model, fn, cfg["stego_method"],
                                 cfg["alpha"], crop=cfg["crop"],
                                 augment=cfg["augment"])


def _as_draws(d: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in d.items()}


def _grad_errors(model, want: dict) -> dict:
    got = flatten_tree(flax_params_from_unet_state_dict(
        {k: p.grad for k, p in model.named_parameters()}))
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() /
                     max(np.abs(want[k]).max(), 1e-30)) for k in want}


def _jax_float64_grads(case, params, pixels, mask, draws) -> dict:
    """JAX's gradients of the same step with the model in float64: the
    Flax model (compute dtype and parameters float64) under
    ``jax.enable_x64``, its outputs cast back to f32 for JAX's loss, as
    the f32 step's model returns them.  This is the exact gradient of the
    model's part of the step, up to the f32 loss.  The step's covers,
    inputs and alphas come from the port's pipeline cores on the replayed
    draws (bitwise JAX's, held in tests/test_torch_simulate.py), through a
    Sampler whose model and loss only pass them on; a keep mask is applied
    with JAX's KB prediction after the cast, as the Flax UniformDropout
    is."""
    cfg = STEP_CASES[case]
    seen = {}

    def record(outputs, covers, inputs, alphas):
        seen.update(covers=covers, inputs=inputs, alphas=alphas)
        return alphas

    ttrain.Sampler(lambda x, keep=None: x, record, cfg["stego_method"],
                   cfg["alpha"], crop=cfg["crop"], augment=cfg["augment"]
                   ).loss(torch.from_numpy(pixels), torch.from_numpy(mask),
                          _as_draws(draws))
    covers, inputs = (jnp.asarray(seen[k].numpy().transpose(0, 2, 3, 1))
                      for k in ("covers", "inputs"))
    alphas, w = jnp.asarray(seen["alphas"].numpy()), jnp.asarray(mask, float)
    jfn = jloss.get_loss(cfg["loss"], per_image=True,
                         loss_lambda=cfg.get("loss_lambda")
                         if cfg.get("weighted_loss") else None)
    with jax.enable_x64(True):
        x = inputs.astype(jnp.float64)
        if "keep" in draws:
            x = jnp.where(jnp.asarray(draws["keep"].transpose(0, 2, 3, 1)),
                          x, kb_predict_nhwc(x))
        jmodel = jax_get_model("unet_1", compute_dtype=jnp.float64)

        def loss(p):
            out = jmodel.apply({"params": p}, x).astype(jnp.float32)
            per = jfn(out, covers, inputs, alphas)
            return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

        grads = jax.grad(loss)(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), params))
        return flatten_tree(jax.tree.map(np.asarray, grads))


# The gradient tensors whose JAX f32 value lies further than 1e-4 from
# JAX's own value with the model in float64: the HILLr case's
# 128-channel bottleneck conv, e2/conv2 (bias 1.07e-4, kernel 1.03e-4 as
# read; the port's f32 values lie 3.4e-6 and 1.1e-6 from the float64
# ones).  There the port is held to JAX's float64 gradient at 1e-5 and to
# JAX's f32 gradient at 2e-4.  Every other tensor: 1e-4 against JAX's f32.
JAX_F32_OFF = {("hillr", "e2/conv2/bias"): 2e-4,
               ("hillr", "e2/conv2/kernel"): 2e-4}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_full_step_matches_jax_make_step(case):
    cfg = STEP_CASES[case]
    size = 64
    pixels = jax_load_images(P128, NAMES[:4])[:, :size, :size].copy()
    mask = np.array([True, True, True, False])
    _, params = _flax_params("unet_1", 7, size)
    seed = {"lsbr": 6, "hillr": 0, "dropout": 1}[case]
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[1:]
    want_loss, want_g = _jax_step_and_grads(case, params, pixels, mask, key)
    draws = EXPORT.jax_step_draws(jax, key, pixels.shape,
                                  {**cfg, "cover_fraction": 0.5},
                                  drop_rate=cfg.get("drop_rate"))
    if cfg["stego_method"]:
        assert draws["is_stego"][:3].any() and not draws["is_stego"][:3].all()
    model, sampler = _torch_sampler(case, params)
    model.train()
    loss = sampler.loss(torch.from_numpy(pixels), torch.from_numpy(mask),
                        _as_draws(draws))[0]
    loss.backward()
    assert abs(float(loss) / want_loss - 1) <= 1e-5
    errors = _grad_errors(model, want_g)
    named = {k: tol for (c, k), tol in JAX_F32_OFF.items() if c == case}
    for k, e in errors.items():
        assert e <= named.get(k, 1e-4), (k, e)
    if named:
        exact = _jax_float64_grads(case, params, pixels, mask, draws)
        port = flatten_tree(flax_params_from_unet_state_dict(
            {k: p.grad for k, p in model.named_parameters()}))
        for k in named:
            err = np.abs(port[k] - exact[k]).max() / np.abs(exact[k]).max()
            assert err <= 1e-5, (k, err)


def test_masked_rows_do_not_steer_the_loss():
    _, params = _flax_params("unet_1", 3)
    model, sampler = _torch_sampler("lsbr", params)
    pixels = torch.from_numpy(jax_load_images(P128, NAMES[:4]))
    d = sampler.draw(pixels.shape, torch.Generator().manual_seed(0))
    mask = torch.tensor([True, False, True, False])
    full = sampler.loss(pixels, mask, d)[0]
    sub = sampler.loss(pixels[mask], torch.ones(2, dtype=torch.bool),
                       {k: v[mask] for k, v in d.items()})[0]
    assert abs(float(full) - float(sub)) <= 1e-6 * abs(float(sub))
    zero = sampler.loss(pixels, torch.zeros(4, dtype=torch.bool), d)[0]
    assert float(zero) == 0.0


def test_draws_cover_the_step_and_repeat_from_a_seed():
    _, params = _flax_params("unet_1", 3)
    _, sampler = _torch_sampler("dropout", params)
    a = sampler.draw((4, 128, 128), torch.Generator().manual_seed(5))
    b = sampler.draw((4, 128, 128), torch.Generator().manual_seed(5))
    assert sorted(a) == ["flip_h", "flip_v", "is_stego", "k", "keep", "oi",
                         "oj"]
    assert a["keep"].shape == (4, 1, 48, 48)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["oi"].max()) <= 128 - 48 and int(a["k"].max()) <= 3
    _, lsbr = _torch_sampler("lsbr", params)
    d = lsbr.draw((4, 16, 16), torch.Generator().manual_seed(5))
    # crop 32 >= 16: no crop offsets
    assert sorted(d) == ["bits", "embed", "flip_h", "flip_v", "is_stego", "k"]


def test_committed_golden_step_holds_on_the_cpu():
    """The card's golden file (JAX's step in the committed LSBR recipe on
    the committed LSBR weights), held by the port on the CPU: the loss,
    the full and norm gradients, and three AdamW steps' losses and the
    parameter norms after them."""
    from wsunet_tpu_torch.train import load_params

    z = np.load(GOLDEN)
    cfg = json.loads(str(z["config"]))
    assert str(z["run"]) == LSBR_RUN.name

    def model():
        m = get_model(cfg["network"])
        m.load_state_dict(unet_state_dict_from_flax(load_params(LSBR_RUN)[0]))
        return m

    def draws(s):
        p = f"draws/{s}/"
        return _as_draws({k[len(p):]: z[k] for k in z.files
                          if k.startswith(p)})

    fn = tloss.get_loss(cfg["loss"], per_image=True,
                        loss_lambda=cfg["loss_lambda"])
    m = model().train()
    sampler = ttrain.Sampler(m, fn, cfg["stego_method"], cfg["alpha"],
                             crop=cfg["crop"], augment=cfg["augment"],
                             cover_fraction=cfg["cover_fraction"])
    loss = sampler.loss(torch.from_numpy(z["pixels"][0]),
                        torch.from_numpy(z["mask"][0]), draws(0))[0]
    loss.backward()
    assert abs(float(loss) / float(z["loss"]) - 1) <= 1e-5
    full = {k[len("grad/"):]: z[k] for k in z.files if k.startswith("grad/")}
    got = flatten_tree(flax_params_from_unet_state_dict(
        {k: p.grad for k, p in m.named_parameters()}))
    for k, want in full.items():
        assert np.abs(got[k] - want).max() <= 1e-4 * np.abs(want).max(), k
    for k in got:
        assert abs(np.linalg.norm(got[k]) / z[f"grad_norm/{k}"] - 1) <= 1e-4

    m = model()
    opt, sch = ttrain.make_optimizer(cfg, cfg["steps_per_epoch"],
                                     m.parameters())
    step = ttrain._make_step(m, fn, opt, sch, cfg["stego_method"],
                             cfg["alpha"], crop=cfg["crop"],
                             augment=cfg["augment"],
                             cover_fraction=cfg["cover_fraction"])[0]
    losses = [float(step(torch.from_numpy(z["pixels"][s]),
                         torch.from_numpy(z["mask"][s]), draws=draws(s)))
              for s in range(len(z["adamw_loss"]))]
    np.testing.assert_allclose(losses, z["adamw_loss"], rtol=1e-5)
    p = flatten_tree(flax_params_from_unet_state_dict(m.state_dict()))
    for k in p:
        assert abs(np.linalg.norm(p[k]) / z[f"param_norm/{k}"] - 1) <= 1e-6


# --- optimizer and schedule against optax ------------------------------

@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_adamw_and_schedule_match_optax(schedule):
    import optax

    cfg = {"learning_rate": 1e-3, "lr_schedule": schedule, "num_epochs": 4}
    spe = 10                      # total 40, warmup min(2, 20) = 2
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(0, 0.1, (5, 7)).astype(np.float32),
              "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1e-2, v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    jopt = jtrain.make_optimizer(cfg, spe)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, sch = ttrain.make_optimizer(cfg, spe, list(tp.values()))
    for g in grads:
        upd, state = jopt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sch.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-7)
    assert opt.param_groups[0]["weight_decay"] == 1e-4


def test_schedule_is_optax_warmup_cosine():
    import optax

    for warmup, total in [(0, 10), (2, 40), (5, 7)]:
        want = optax.warmup_cosine_decay_schedule(0.0, 2e-5, warmup, total,
                                                  end_value=2e-7)
        got = ttrain.warmup_cosine_decay(0.0, 2e-5, warmup, total,
                                         end_value=2e-7)
        for c in range(total + 3):
            assert abs(got(c) - float(want(c))) <= 1e-6 * 2e-5, (warmup, c)
    cfg = {"learning_rate": 1e-4, "lr_schedule": "cosine", "num_epochs": 3}
    opt, _ = ttrain.make_optimizer(cfg, 20, [torch.nn.Parameter(
        torch.zeros(1))])
    assert opt.param_groups[0]["lr"] == 0.0      # the first step's rate
    with pytest.raises(NotImplementedError, match="'step'"):
        ttrain.make_optimizer({**cfg, "lr_schedule": "step"}, 1,
                              [torch.nn.Parameter(torch.zeros(1))])


# --- config, names, meters --------------------------------------------

@pytest.mark.parametrize("overrides", [
    {}, {"alpha": 0.1, "crop": 64}, {"batch_size": "4"},
    {"shape": [256, 256], "drop_rate": 0.1, "stego_method": None}])
def test_config_validates_as_jax(overrides):
    assert tcfg.UNetTrainConfig.validate(overrides) == \
        jcfg.UNetTrainConfig.validate(overrides)
    assert tcfg.B0TrainConfig.validate({}) == jcfg.B0TrainConfig.validate({})
    assert ttrain.DEFAULT_CONFIG == jtrain.DEFAULT_CONFIG


@pytest.mark.parametrize("overrides", [{"alpah": 0.4}, {"lr": 1.0},
                                       {"batch": 2, "crop": 3}])
def test_unknown_config_keys_fail_as_jax(overrides):
    with pytest.raises(ValueError) as want:
        jcfg.UNetTrainConfig.validate(overrides)
    with pytest.raises(ValueError) as got:
        tcfg.UNetTrainConfig.validate(overrides)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [
    {}, {"stego_method": None, "alpha": None, "loss": "l1",
         "drop_rate": 0.1}, {"learning_rate": 2e-5, "alpha": 0.01},
    {"grayscale": False}])
def test_run_name_is_jax(overrides):
    cfg = jcfg.UNetTrainConfig.validate(overrides)
    assert create_run_name(cfg) == jax_run_name(cfg)


def test_logger_is_the_jax_loggers_setup():
    from wsunet_tpu.utils import setup_logger as jax_logger

    a, b = setup_logger("port_probe"), setup_logger("port_probe")
    assert a is b and len(a.handlers) == 1      # idempotent
    want = jax_logger("jax_probe").handlers[0]
    assert a.handlers[0].formatter._fmt == want.formatter._fmt
    assert a.level == want.level


@pytest.mark.parametrize("seed", [0, 12345, 7])
@pytest.mark.parametrize("n, steps", [(48, None), (5, 3), (1, 2)])
def test_epoch_order_is_pandas_sample(seed, n, steps):
    import pandas as pd

    names = [f"images/{i}.png" for i in range(n)]
    df = pd.DataFrame({"name": names})
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        want = df.sample(frac=1.0, random_state=rj.integers(2 ** 31)) \
            if n > 1 else df
        if steps:
            need = steps * 4
            want = pd.concat([want] * max(1, -(-need // n)))[:need]
        assert ttrain.epoch_names(names, rt, steps, 4) == list(want["name"])


def test_meters_match_jax():
    _, inp, out, alphas = _loss_inputs(2)
    a, b = jmet.WSMeter(), tmet.WSMeter()
    a.update(inp, out, alphas)
    b.update(inp.transpose(0, 3, 1, 2), out.transpose(0, 3, 1, 2), alphas)
    assert b.avg == pytest.approx(a.avg, rel=1e-12)
    a, b = jmet.MAEMeter(multiplier=255), tmet.MAEMeter(multiplier=255)
    for _ in range(2):
        a.update(inp, out)
        b.update(inp.transpose(0, 3, 1, 2), out.transpose(0, 3, 1, 2))
    assert (b.avg, b.count) == pytest.approx((a.avg, a.count))
    a, b = jmet.LossMeter(":.4e"), tmet.LossMeter(":.4e")
    for v, n in [(0.5, 3), (0.25, 1)]:
        a.update(v, n)
        b.update(v, n)
    a.update_vector([1.0, np.nan])
    b.update_vector([1.0, np.nan])
    assert (str(b), b.avg) == (str(a), a.avg)
    assert tmet.ProgressMeter(12, [b], "E").to_str(3) == \
        jmet.ProgressMeter(12, [a], "E").to_str(3)
    assert str(tmet.AverageMeter(summary_type=tmet.Summary.NONE)) == ""


# --- checkpoints ------------------------------------------------------

def _state(v: float) -> dict:
    return {"params": {"w": torch.full((2,), v)}, "epoch": int(v),
            "best_val_loss": float("inf"), "patience": 3}


def test_checkpoint_round_trip_and_best_copy(tmp_path):
    tck.save_checkpoint(tmp_path, _state(1.0), is_best=True)
    tck.save_checkpoint(tmp_path, _state(2.0), is_best=False)
    assert float(tck.load_checkpoint(tmp_path, "latest")["params"]["w"][0]) \
        == 2.0
    best = tck.load_checkpoint(tmp_path, "best")
    assert float(best["params"]["w"][0]) == 1.0 and best["epoch"] == 1
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == \
        ["best", "latest"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tck.load_checkpoint(tmp_path / "none", "best")


def test_checkpoint_survives_a_crash_between_the_renames(tmp_path,
                                                         monkeypatch):
    """A crash after ``latest`` became ``latest.old`` and before the new
    one took its place: the old checkpoint stays readable, and the next
    save completes and cleans up."""
    tck.save_checkpoint(tmp_path, _state(1.0))
    real = pathlib.Path.rename
    calls = []

    def crash(self, target):
        calls.append(self.name)
        if self.name == "latest.tmp":
            raise OSError("crash")
        return real(self, target)

    monkeypatch.setattr(pathlib.Path, "rename", crash)
    with pytest.raises(OSError, match="crash"):
        tck.save_checkpoint(tmp_path, _state(2.0))
    monkeypatch.setattr(pathlib.Path, "rename", real)
    assert calls == ["latest", "latest.tmp"]
    assert not (tmp_path / "model" / "latest").exists()
    assert float(tck.load_checkpoint(tmp_path, "latest")["params"]["w"][0]) \
        == 1.0
    tck.save_checkpoint(tmp_path, _state(3.0))
    assert float(tck.load_checkpoint(tmp_path, "latest")["params"]["w"][0]) \
        == 3.0
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == \
        ["latest"]


def test_save_params_writes_the_layout_load_params_reads(tmp_path):
    _, params = _flax_params("unet_1", 5)
    params = jax.tree.map(np.asarray, params)
    tck.save_params(tmp_path, params)
    back, stats = tck.load_params(tmp_path)
    assert stats == {}
    a, b = flatten_tree(params), flatten_tree(back)
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not (tmp_path / "best.npz.tmp").exists()


# --- the trainer end to end -------------------------------------------

TINY = dict(network="unet_1", crop=32, batch_size=4, steps_per_epoch=2,
            num_epochs=2, val_steps=1, augment=True, lr_schedule="cosine",
            weighted_loss=True, tr_csv="split_tr.csv", va_csv="split_va.csv")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train-unet --device cpu`` on data_ablation/p128 (LSBR) and a
    second, dropout run."""
    from wsunet_tpu_torch.cli import main

    out = tmp_path_factory.mktemp("runs")
    assert main(["train-unet", "--data", str(P128), "--output-dir", str(out),
                 "--device", "cpu", "--config", json.dumps(TINY)]) == 0
    assert main(["train-unet", "--data", str(P128), "--output-dir", str(out),
                 "--device", "cpu", "--config", json.dumps(
                     {**TINY, "stego_method": None, "alpha": None,
                      "loss": "l1", "drop_rate": 0.1})]) == 0
    return out


def test_train_unet_writes_the_jax_run_layout(trained):
    from wsunet_tpu.utils import registry as jreg
    from wsunet_tpu_torch.utils import registry

    for method, loss in (("LSBR", "l1ws"), ("dropout", "l1")):
        (run,) = (trained / method).iterdir()
        stamp, platform, rest = run.name.split("-", 2)
        assert len(stamp) == 12 and platform == "cpu"
        assert rest == create_run_name(json.loads(
            (run / "config.json").read_text()))
        assert sorted(p.name for p in run.iterdir()) == \
            ["best.npz", "config.json", "log", "model"]
        assert sorted(p.name for p in (run / "model").iterdir()) == \
            ["best", "latest"]
        config = json.loads((run / "config.json").read_text())
        assert set(config) == set(jtrain.DEFAULT_CONFIG) | {"dataset"}
        assert config["stego_method"] == method and config["loss"] == loss
        rows = (run / "log" / "scalars.csv").read_text().split()
        assert [r.split(",")[:2] for r in rows] == [
            [str(e), t] for e in range(2)
            for t in ("train/loss", "val/loss", "val/ws", "val/mae")]
        # both registries find the run
        assert registry.get_model_name(trained, method, loss=loss) == run.name
        assert jreg.get_model_name(trained, method, loss=loss) == run.name
        # best.npz is model/best's parameters in the Flax layout
        best = tck.load_checkpoint(run, "best")["params"]
        sd = unet_state_dict_from_flax(tck.load_params(run)[0])
        assert all(torch.equal(sd[k], best[k]) for k in sd)


def test_unet_eval_runs_a_trained_run(trained, tmp_path):
    """``unet-eval --device cpu`` through the registry on the run that
    ``train-unet`` wrote, over a catalog with LSBr stego."""
    from wsunet_tpu_torch.cli import main
    from torch_p128 import make_catalog
    import pandas as pd

    data = make_catalog(tmp_path / "data", n=4, alphas=(0.1,))
    assert main(["unet-eval", "--device", "cpu", "--data", str(data),
                 "--model-dir", str(trained), "--stego-method", "LSBR",
                 "--results", str(tmp_path / "res")]) == 0
    df = pd.read_csv(tmp_path / "res" / "estimation" / "ws_LSBR.csv")
    assert len(df) == 8 and np.isfinite(df["beta_hat"]).all()


def test_jax_model_takes_a_run_the_port_trained(trained):
    """A run leaves the port: its best.npz is the Flax params tree, and
    the JAX U-Net on it predicts what the port's model does."""
    from wsunet_tpu_torch.ws import load_pretrained_unet

    (run,) = (trained / "LSBR").iterdir()
    params = jax.tree.map(jnp.asarray, tck.load_params(run)[0])
    x = np.random.default_rng(0).random((1, 32, 32, 1), dtype=np.float32)
    want = np.asarray(jax_get_model("unet_1").apply({"params": params},
                                                    jnp.asarray(x)))
    model, _ = load_pretrained_unet(trained / "LSBR", run.name,
                                    device="cpu")
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(got[:, 0].numpy(), want[..., 0], atol=1e-5)


def test_resume_from_a_port_run_and_from_a_best_npz(trained, tmp_path):
    """``resume`` loads the named run's model/best (a port run) or its
    best.npz (an exported JAX run).  At learning rate 0 AdamW leaves the
    parameters as they are, so the resumed run's best equals its source
    bit for bit."""
    from wsunet_tpu_torch.train.train_unet import train_names

    (src,) = (trained / "LSBR").iterdir()
    cfg = {**TINY, "num_epochs": 1, "learning_rate": 0.0,
           "lr_schedule": None, "resume": src.name}
    names = NAMES[:8]
    run = train_names(cfg, P128, names, names[:4], trained, device="cpu")
    a = tck.load_checkpoint(src, "best")["params"]
    b = tck.load_checkpoint(run, "best")["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)

    jax_run = tmp_path / "LSBR" / LSBR_RUN.name
    shutil.copytree(LSBR_RUN, jax_run)
    cfg = {**cfg, "network": "unet_2", "resume": LSBR_RUN.name}
    run = train_names(cfg, P128, names, names[:4], tmp_path, device="cpu")
    want = flatten_tree(tck.load_params(jax_run)[0])
    got = flatten_tree(tck.load_params(run)[0])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="resume"):
        train_names({**cfg, "resume": "missing"}, P128, names, names[:4],
                    tmp_path, device="cpu")


def test_validation_is_seeded_and_keeps_dropout_active():
    _, params = _flax_params("unet_1", 3)
    model, _ = _torch_sampler("dropout", params)
    opt, sch = ttrain.make_optimizer({"learning_rate": 1e-4}, 1,
                                     model.parameters())
    _, eval_step = ttrain._make_step(model, tloss.get_loss("l1", True), opt,
                                     sch, None, None, crop=48, augment=True)
    pixels = torch.from_numpy(jax_load_images(P128, NAMES[:4]))
    mask = torch.ones(4, dtype=torch.bool)
    a = eval_step(pixels, mask, ttrain.val_generator(1, 0, "cpu"))
    b = eval_step(pixels, mask, ttrain.val_generator(1, 0, "cpu"))
    c = eval_step(pixels, mask, ttrain.val_generator(1, 1, "cpu"))
    assert float(a[0]) == float(b[0]) != float(c[0])
    assert model.training
    # dropout is active: the inputs and the model's own input differ
    d = eval_step.sampler.draw(pixels.shape, ttrain.val_generator(1, 0, "cpu"))
    assert not bool(d["keep"].all())


def test_train_refuses_without_a_card_and_a_row_selection():
    from wsunet_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UserError, match="CUDA is not available"):
        ttrain.train(dict(TINY), P128, "/nonexistent")
    with pytest.raises(SystemExit, match="does not support --split/--take"):
        main(["train-unet", "--data", str(P128), "--take", "2"])
