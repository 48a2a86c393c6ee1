"""Port parity: the B0 trainer (wsunet_tpu_torch.train.train_b0 and
train.bn_recalibrate, models.b0's initialiser, batch norm and head
dropout, models.convert's inverse, the accuracy meter) against the JAX
package, on the CPU, small: data_ablation/p128 covers at 128x128 (crop
64 for the runs), B = 2 cover/stego pairs.

Tolerances (f32):

- the high-pass stem channels: bitwise; every other initial leaf: the
  standard deviation of each tensor of 4,096 values or more within 5% of
  1/sqrt(fan_in), of all of them pooled within 1%, support inside
  +-2/0.8796 * 1/sqrt(fan_in), quantiles of the pooled draws within 0.02
  of Flax's own;
- batch norm in training mode against Flax's ``BatchNorm``: outputs and
  running statistics 1e-6 (``nn.BatchNorm2d``'s running variance misses
  by the factor n / (n - 1));
- the golden step in the committed recipe (``freeze_bn``): loss rel 1e-5,
  each full gradient max|d| / max|g| <= 1e-4, every gradient norm rel
  1e-5; three AdamW steps' losses rel 1e-5, every parameter's norm rel
  1e-5 but for ``ADAM_NOISE`` (below);
- the golden step with ``freeze_bn`` off (batch statistics, head dropout
  and the running update live), against JAX's f32 step and JAX's float64
  one (``live64/`` in the golden file): the port's model in float64 on
  JAX's inputs against JAX's float64 at 1e-6 (loss rel, logits, each full
  gradient max|d| / max|g|, gradient norms of the largest, running
  statistics rel; measured 8e-8 at most); the port's f32 step against
  both at loss rel 1e-3, logits 1e-3, gradients 1e-3 (gradient norms
  1e-3 of the largest) and running statistics rel 1e-5: at 4x4 and 2x2
  per image the deepest batch norms normalise over 64 and 16 values, so
  the step amplifies f32 rounding: an ulp of XLA's jitted preprocessing
  (it multiplies by 1/255 where the port divides) moves the float64 step's
  logits by 1.7e-5, and the port's f32 gradients lie 4.2e-4 from JAX's f32
  and 3.6e-4 from JAX's float64 on the golden draws (JAX's own f32 lies
  6e-5 from its float64 there, and up to 6.6e-4 on other draws of the same
  covers);
- HILLr's per-rate selection: JAX's eval step, live, at 64x64 crops:
  loss rel 1e-5, logits 1e-4.
"""

import importlib.util
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_p128 import P128, REPO
from wsunet_tpu.detect import metrics as jmet
from wsunet_tpu.models import b0 as jb0
from wsunet_tpu.train import train_b0 as jtrain
from wsunet_tpu.train.config import B0TrainConfig as JConfig
from wsunet_tpu_torch.detect import metrics as tmet
from wsunet_tpu_torch.models import (b0_state_dict_from_flax,
                                     flax_b0_params_from_state_dict, get_b0,
                                     init_b0)
from wsunet_tpu_torch.models.b0 import FlaxBatchNorm, HeadDropout
from wsunet_tpu_torch.train import bn_recalibrate
from wsunet_tpu_torch.train import checkpoint as tck
from wsunet_tpu_torch.train import train_b0 as ttrain
from wsunet_tpu_torch.train.checkpoint import flatten_tree
from wsunet_tpu_torch.train.train_unet import make_optimizer
from wsunet_tpu_torch.utils.errors import UserError

NAMES = [f"images/{p.name}" for p in sorted((P128 / "images").glob("*.png"))]
GOLDEN = REPO / "weights" / "golden" / "p128_b0_train_step.npz"
B0_DIR = REPO / "weights" / "b0" / "LSBR"
STRIDED = "260817154325-tpu-b0-alpha_mix0.1-0.05-0.01_grayscale_" \
    "crossentropy_lr_2e-05_dr_0.2"
TRUNC = 0.87962566103423978
# AdamW divides each gradient element by its own magnitude: an element
# whose gradient is near the rounding floor moves by up to lr either way.
# In the golden recipe that moves this bias (norm 0.045) 1.3e-5 from
# JAX's norm after three steps; every other tensor lies within 2e-7.
ADAM_NOISE = {"stage4_block0/se/reduce/bias": 5e-5}


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPORT = _exporter()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores, and with a thread per core in every
    worker the many small ops of these steps slow down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _draws(z, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(z[k]).long()
            if z[k].dtype.kind == "i" else torch.from_numpy(z[k])
            for k in z.files if k.startswith(prefix)}


def _golden_model(z, cfg):
    model = ttrain.build_model(cfg)
    model.load_state_dict(b0_state_dict_from_flax(
        *tck.load_params(B0_DIR / str(z["run"]))))
    return model


def _grads(model) -> dict:
    return flatten_tree(flax_b0_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})[0])


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() /
                 max(float(np.abs(want).max()), 1e-30))


# --- initialisation -----------------------------------------------------

@pytest.mark.parametrize("in_channels, parity", [(1, False), (1, True),
                                                 (2, False), (2, True)])
def test_highpass_stem_is_jax_bitwise(in_channels, parity):
    """The stem's seeded channels equal the JAX ``_highpass_stem_init``'s
    bit for bit, keyed on the kernel's input planes (the parity plane
    counts: grayscale with parity features takes the LSB extractor); the
    rest is LeCun-normal."""
    cin = in_channels + int(parity)
    want = np.asarray(jb0._highpass_stem_init(
        jax.random.PRNGKey(cin), (3, 3, cin, 32))).transpose(3, 2, 0, 1)
    model = init_b0(get_b0(in_channels, parity_features=parity,
                           stem_init="highpass"), seed=cin)
    got = model.conv_stem.weight.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:16].view(np.int32),
                                  want[:16].view(np.int32))
    if cin >= 2:
        assert got[0, 0, 1, 1] == 8.0 and got[0, 1, 1, 1] == -8.0
    else:
        np.testing.assert_array_equal(got[0, 0], np.asarray(
            jb0._HP_KERNELS[0], np.float32) / 4)
    bound = 2 / TRUNC / np.sqrt(9 * cin)
    assert np.abs(got[16:]).max() <= bound * (1 + 1e-6)
    # the default init leaves the stem LeCun-normal
    plain = init_b0(get_b0(in_channels, parity_features=parity), seed=cin)
    assert not np.array_equal(plain.conv_stem.weight.detach().numpy()[:16],
                              got[:16])


def test_highpass_stem_of_a_jax_init(golden):
    """The stem of a whole JAX ``get_b0(..., stem_init="highpass")`` init
    (the golden file's, parity features: 2 planes) and the port's."""
    want = golden["init/conv_stem/kernel"].transpose(3, 2, 0, 1)
    model = ttrain.build_model(ttrain.B0TrainConfig.validate(
        json.loads(str(golden["config"]))))
    got = model.conv_stem.weight.detach().numpy()
    np.testing.assert_array_equal(got[:16], want[:16])
    assert abs(got[16:].std() / want[16:].std() - 1) < 0.2


def test_init_b0_is_flax_defaults():
    """Every conv kernel and the classifier's kernel LeCun-normal with the
    Flax fan-in (depthwise k*k, Dense 1280), zero biases, unit scales,
    running mean 0 and variance 1: the leaves of the JAX init's tree."""
    model = init_b0(get_b0(1, quadratic_stem=True, parity_features=True),
                    seed=0)
    params, stats = flax_b0_params_from_state_dict(model.state_dict())
    jmodel = jb0.get_b0(1, quadratic_stem=True, parity_features=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 1), jnp.float32))
    want = flatten_tree(jax.tree.map(lambda s: np.zeros(s.shape),
                                     dict(shapes["params"])))
    flat = flatten_tree(params)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in want.items()}
    pooled = []
    for key, value in flat.items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "bias":
            assert not value.any(), key
        elif leaf == "scale":
            assert (value == 1).all(), key
        else:
            fan_in = int(np.prod(value.shape[:-1]))
            z = value * np.sqrt(fan_in)
            assert np.abs(z).max() <= 2 / TRUNC * (1 + 1e-6), key
            if value.size >= 4096:
                assert abs(z.std() - 1) < 0.05, (key, z.std())
            pooled.append(z.ravel())
    pooled = np.concatenate(pooled)
    assert abs(pooled.std() - 1) < 0.01
    flax = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (256, 1024), jnp.float32)).ravel() * 16
    q = np.linspace(0.01, 0.99, 33)
    np.testing.assert_allclose(np.quantile(pooled, q), np.quantile(flax, q),
                               atol=0.02)
    assert all((v == 0).all() for k, v in flatten_tree(stats).items()
               if k.endswith("mean"))
    assert all((v == 1).all() for k, v in flatten_tree(stats).items()
               if k.endswith("var"))


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_b0_converter_round_trip_is_bitwise(norm):
    """A port-initialised model to Flax params and batch_stats and back:
    every tensor bit for bit (and no batch_stats for group norm)."""
    model = init_b0(get_b0(2, no_stem_stride=True, norm=norm,
                           stem_init="highpass"), seed=4)
    with torch.no_grad():                # non-trivial running statistics
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm):
                m.running_mean.uniform_(-1, 1)
                m.running_var.uniform_(0.5, 2)
    params, stats = flax_b0_params_from_state_dict(model.state_dict())
    assert bool(stats) == (norm == "batch")
    back = b0_state_dict_from_flax(params, stats)
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v) or k.endswith("num_batches_tracked"), k
    assert params["classifier"]["kernel"].shape == (1280, 2)
    assert params["stage1_block0"]["dw_conv"]["kernel"].shape == (3, 3, 1, 96)


# --- batch norm and head dropout --------------------------------------

@pytest.mark.parametrize("shape", [(4, 4, 4, 24), (2, 7, 5, 16),
                                   (8, 2, 2, 40)])
def test_batch_norm_updates_running_statistics_as_flax(shape):
    """One training-mode forward of Flax's BatchNorm (momentum 0.9, eps
    1e-3) and the port's: equal outputs and running statistics (1e-6).
    ``nn.BatchNorm2d`` with the same settings normalises alike but moves
    its running variance with the unbiased variance: n / (n - 1) too far
    from the start."""
    from flax import linen as nn

    rng = np.random.default_rng(sum(shape))
    B, H, W, C = shape
    x = (rng.normal(0.3, 2.0, shape) + rng.normal(0, 1, C)).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.1, C).astype(np.float32)
    mean0 = rng.normal(0, 0.5, C).astype(np.float32)
    var0 = rng.uniform(0.5, 2, C).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}},
                      jnp.asarray(x), mutable=["batch_stats"])
    want = {k: np.asarray(v) for k, v in mut["batch_stats"].items()}

    def run(module):
        with torch.no_grad():
            module.weight.copy_(torch.from_numpy(scale))
            module.bias.copy_(torch.from_numpy(bias))
            module.running_mean.copy_(torch.from_numpy(mean0))
            module.running_var.copy_(torch.from_numpy(var0))
        out = module.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        return (out.detach().permute(0, 2, 3, 1).numpy(),
                module.running_mean.numpy(), module.running_var.numpy())

    out, mean, var = run(FlaxBatchNorm(C))
    np.testing.assert_allclose(out, np.asarray(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mean, want["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var, want["var"], rtol=1e-6, atol=1e-6)

    out, mean, pvar = run(torch.nn.BatchNorm2d(C, eps=1e-3, momentum=0.1))
    np.testing.assert_allclose(out, np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean, want["mean"], rtol=1e-6, atol=1e-6)
    assert not np.allclose(pvar, want["var"], rtol=1e-6, atol=1e-6)
    n = B * H * W
    np.testing.assert_allclose((pvar - 0.9 * var0) / (want["var"] -
                                                      0.9 * var0),
                               n / (n - 1), rtol=1e-4)


def test_head_dropout_is_flax_dropout_on_its_mask():
    """Flax's ``nn.Dropout(0.2)`` under a key, and the port's head dropout
    on the mask that key gives (replayed through a probe module of the
    same name): equal outputs; identity in eval mode; training mode
    without a mask raises."""
    from flax import linen as nn

    x = np.random.default_rng(0).normal(0, 1, (4, 1280)).astype(np.float32)
    dk = jax.random.PRNGKey(3)

    class Net(nn.Module):
        @nn.compact
        def __call__(self, v):
            return nn.Dropout(0.2, deterministic=False)(v)

    want = np.asarray(Net().apply({}, jnp.asarray(x), rngs={"dropout": dk}))
    keep = EXPORT.jax_head_dropout_keep(jax, dk, 4, 0.2)
    drop = HeadDropout(0.2).train()
    got = drop(torch.from_numpy(x), keep=torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0.75 < keep.mean() < 0.85
    with pytest.raises(ValueError, match="keep mask"):
        drop(torch.from_numpy(x))
    assert torch.equal(drop.eval()(torch.from_numpy(x)), torch.from_numpy(x))


# --- the golden steps -------------------------------------------------

def test_golden_recipe_step_and_adamw_hold_on_the_cpu(golden):
    """JAX's step in the committed recipe (``freeze_bn``: the model in
    eval mode, gradients flowing) on the committed strided run, replayed
    on its draws: loss, logits, gradients and their norms; then three
    AdamW steps under the cosine schedule: losses, every parameter's norm
    and its distance from the start."""
    z = golden
    cfg = ttrain.B0TrainConfig.validate(json.loads(str(z["config"])))
    assert cfg["freeze_bn"] and cfg["stem_init"] == "highpass"
    model = _golden_model(z, cfg)
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                              model.parameters())
    train_step = ttrain._make_steps(model, opt, sch, cfg)[0]
    sampler = train_step.sampler
    model.eval()
    loss, logits, y = sampler.loss(torch.from_numpy(z["pixels"][0]),
                                   torch.from_numpy(z["mask"][0]),
                                   _draws(z, "draws/0/"))
    loss.backward()
    assert abs(float(loss) / float(z["loss"]) - 1) <= 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), z["logits"],
                               atol=1e-4)
    assert y.tolist() == [0, 0, 1, 1]
    got = _grads(model)
    for k in (k[len("grad/"):] for k in z.files if k.startswith("grad/")):
        assert _rel(got[k], z[f"grad/{k}"]) <= 1e-4, k
    for k, v in got.items():
        assert abs(np.linalg.norm(v) / z[f"grad_norm/{k}"] - 1) <= 1e-5, k

    start = flatten_tree(flax_b0_params_from_state_dict(
        _golden_model(z, cfg).state_dict())[0])
    model.load_state_dict(_golden_model(z, cfg).state_dict())
    losses = [float(train_step(torch.from_numpy(z["pixels"][s]),
                               torch.from_numpy(z["mask"][s]),
                               draws=_draws(z, f"draws/{s}/"))[0])
              for s in range(len(z["adamw_loss"]))]
    np.testing.assert_allclose(losses, z["adamw_loss"], rtol=1e-5)
    assert not model.training           # freeze_bn: eval mode throughout
    end = flatten_tree(flax_b0_params_from_state_dict(model.state_dict())[0])
    for k, v in end.items():
        rel = abs(np.linalg.norm(v) / z[f"param_norm/{k}"] - 1)
        assert rel <= ADAM_NOISE.get(k, 1e-5), (k, rel)
    # the steps moved every tensor, by JAX's distance within 1%
    for k, v in end.items():
        assert abs(np.linalg.norm(v - start[k]) / z[f"param_delta/{k}"]
                   - 1) <= 1e-2, k


def _live_step(z, cfg, dtype, jitted_inputs=False):
    """The port's live step on the golden draws, the model in ``dtype``;
    with ``jitted_inputs`` the pixels are preprocessed by the table of
    JAX's jitted f32 preprocessing, as JAX's step fed its model."""
    model = _golden_model(z, cfg).to(dtype)
    model.compute_dtype = dtype
    sampler = ttrain.B0Sampler(model, cfg["stego_method"], cfg["alpha"],
                               crop=cfg["crop"], augment=cfg["augment"],
                               dropout_rate=cfg["drop_rate"])
    if jitted_inputs:
        lut = torch.from_numpy(z["live/preprocess_lut"])
        sampler.preprocess = lambda x_u8: lut[x_u8.long()][:, None]
    model.train()
    d = _draws(z, "live/draws/")
    x = torch.from_numpy(z["pixels"][-1])
    loss, logits, _ = sampler.loss(x, torch.from_numpy(z["mask"][-1]), d)
    loss.backward()
    stats = flatten_tree(flax_b0_params_from_state_dict(
        model.state_dict())[1])
    return float(loss), logits.detach().double().numpy(), _grads(model), \
        stats


def test_golden_live_step_holds_on_the_cpu(golden):
    """JAX's step with ``freeze_bn`` off (training mode: batch statistics,
    head dropout on JAX's mask, the running update) on its draws, against
    JAX's own f32 step and its float64 step (``live64/``): the port's
    float64 step on JAX's inputs against JAX's float64 at 1e-6, the port's
    f32 step against JAX's f32 and against JAX's float64 at the step's f32
    noise (see the module docstring)."""
    z = golden
    cfg = {**ttrain.B0TrainConfig.validate(json.loads(str(z["config"]))),
           "freeze_bn": False}
    full = [k[len("live64/grad/"):] for k in z.files
            if k.startswith("live64/grad/")]
    stats = [k[len("live64/stats/"):] for k in z.files
             if k.startswith("live64/stats/")]
    # the port's f32 preprocessing is JAX's eager one, bit for bit, and
    # within an ulp of its jitted one
    u8 = torch.arange(256, dtype=torch.uint8)[None, None]
    ours = ttrain.B0Sampler(None, "LSBR", 0.1).preprocess(u8).flatten()
    lut = z["live/preprocess_lut"]
    assert np.array_equal(ours.numpy(), np.asarray(jtrain.normalize(
        jnp.arange(256, dtype=jnp.float32) / 255.0, 0.456, 0.224)))
    assert np.abs(ours.numpy() - lut).max() <= np.spacing(np.abs(lut)).max()

    l64, lg64, g64, s64 = _live_step(z, cfg, torch.float64,
                                     jitted_inputs=True)
    assert abs(l64 / float(z["live64/loss"]) - 1) <= 1e-6
    np.testing.assert_allclose(lg64, z["live64/logits"], rtol=0, atol=1e-6)
    for k in full:
        assert _rel(g64[k], z[f"live64/grad/{k}"]) <= 1e-6, k
    # a norm's own scale: the biases of norms that another norm follows
    # have gradients at the rounding floor (about 1e-15)
    gmax = max(float(np.linalg.norm(v)) for v in g64.values())
    for k, v in g64.items():
        assert abs(np.linalg.norm(v) - z[f"live64/grad_norm/{k}"]) <= \
            1e-6 * gmax, k
    for k in stats:
        np.testing.assert_allclose(s64[k], z[f"live64/stats/{k}"],
                                   rtol=1e-6, atol=0, err_msg=k)
    for k, v in s64.items():
        assert abs(np.linalg.norm(v) / z[f"live64/stats_norm/{k}"] - 1) \
            <= 1e-6, k

    l32, lg32, g32, s32 = _live_step(z, cfg, torch.float32)
    for want, tag in ((z["live/loss"], "live"), (z["live64/loss"], "live64")):
        assert abs(l32 / float(want) - 1) <= 1e-3, tag
    np.testing.assert_allclose(lg32, z["live/logits"], rtol=0, atol=1e-3)
    for k in full:
        assert _rel(g32[k], z[f"live/grad/{k}"]) <= 1e-3, k
        assert _rel(g32[k], z[f"live64/grad/{k}"]) <= 1e-3, k
    for k, v in g32.items():
        assert abs(np.linalg.norm(v) - z[f"live/grad_norm/{k}"]) <= \
            1e-3 * gmax, k
    for k in stats:
        for tag in ("live", "live64"):
            np.testing.assert_allclose(s32[k], z[f"{tag}/stats/{k}"],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tag} {k}")
    for k, v in s32.items():
        assert abs(np.linalg.norm(v) / z[f"live/stats_norm/{k}"] - 1) \
            <= 1e-5, k


def test_hillr_rate_selection_matches_jax_eval_step():
    """JAX's eval step (the one live JAX B0 step of this suite) with HILLr
    over a rate mixture, at 64x64 crops of two covers, on seeded weights:
    each image embedded at the listed rate nearest its drawn one, against
    the port on JAX's draws (loss rel 1e-5, logits 1e-4); the port's
    stego pixels equal the per-rate HILLr simulations."""
    from wsunet_tpu.data import load_images
    from wsunet_tpu_torch.data.simulate import hillr_simulate
    from wsunet_tpu_torch.data.transforms import crop, flip, rot90

    cfg = JConfig.validate(dict(stego_method="HILLR", alpha=[0.4, 0.1],
                                val_alpha=[0.4, 0.1, 0.05], crop=64,
                                augment=True, compute_dtype="float32",
                                quadratic_stem=True, parity_features=True,
                                stem_init="highpass"))
    model = ttrain.build_model(cfg)
    params, stats = flax_b0_params_from_state_dict(model.state_dict())
    jmodel = jb0.get_b0(1, quadratic_stem=True, parity_features=True)
    eval_step = jtrain._make_steps(jmodel, None, cfg)[1]
    pixels = load_images(P128, NAMES[:2])
    mask = np.array([True, True])
    key = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), 1)
    loss, logits, y = eval_step(params, stats, jnp.asarray(pixels),
                                jnp.asarray(mask), key)
    d = EXPORT.jax_b0_step_draws(jax, (key, None), pixels.shape,
                                 {**cfg, "stego_method": "HILLR"},
                                 cfg["val_alpha"])
    assert len(set(d["alphas"].tolist())) == 2
    got = _as_torch(d)
    with torch.no_grad():
        sampler = ttrain.B0Sampler(model.eval(), "HILLR", cfg["val_alpha"],
                                   crop=64, augment=True)
        gl, glog, _ = sampler.loss(torch.from_numpy(pixels),
                                   torch.from_numpy(mask), got)
        assert abs(float(gl) / float(loss) - 1) <= 1e-5
        np.testing.assert_allclose(glog.numpy(), np.asarray(logits),
                                   atol=1e-4)
        x = rot90(flip(crop(torch.from_numpy(pixels), got["oi"], got["oj"],
                            64), got["flip_h"], got["flip_v"]), got["k"])
        stego = sampler.embed(x, got)
        for i, a in enumerate(got["alphas"].tolist()):
            nearest = min(cfg["val_alpha"], key=lambda r: abs(r - a))
            assert torch.equal(stego[i], hillr_simulate(x[i:i + 1],
                                                        nearest)[0])


def _as_torch(d: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in d.items()}


def test_draws_repeat_from_a_seed_and_cover_the_step():
    model = init_b0(get_b0(1, drop_rate=0.2), 0)
    s = ttrain.B0Sampler(model, "LSBR", [0.1, 0.05, 0.01], crop=64,
                         augment=True, dropout_rate=0.2)
    a = s.draw((2, 128, 128), torch.Generator().manual_seed(5))
    b = s.draw((2, 128, 128), torch.Generator().manual_seed(5))
    assert sorted(a) == ["alphas", "bits", "embed", "flip_h", "flip_v",
                         "k", "keep", "oi", "oj"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["keep"].shape == (4, 1280) and a["embed"].shape == (2, 64, 64)
    assert set(a["alphas"].tolist()) <= {np.float32(r) for r in
                                         (0.1, 0.05, 0.01)}
    h = ttrain.B0Sampler(model, "HILLR", 0.4).draw(
        (2, 32, 32), torch.Generator().manual_seed(0))
    assert sorted(h) == ["alphas"]


def test_masked_rows_do_not_steer_the_loss(golden):
    z = golden
    cfg = ttrain.B0TrainConfig.validate(json.loads(str(z["config"])))
    model = _golden_model(z, cfg).eval()
    sampler = ttrain.B0Sampler(model, "LSBR", cfg["alpha"], augment=True)
    x = torch.from_numpy(z["pixels"][1])
    d = _draws(z, "draws/1/")
    with torch.no_grad():
        full = sampler.loss(x, torch.tensor([True, False]), d)[0]
        sub = sampler.loss(x[:1], torch.tensor([True]),
                           {k: v[:1] for k, v in d.items()})[0]
        zero = sampler.loss(x, torch.tensor([False, False]), d)[0]
    assert abs(float(full) / float(sub) - 1) <= 1e-6
    assert float(zero) == 0.0


# --- meters, config ---------------------------------------------------

def test_accuracy_meter_and_performance_strings_match_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 40)
    pred = rng.integers(0, 2, 40)
    score = rng.random(40)
    a, b = jmet.AccuracyMeter(), tmet.AccuracyMeter()
    for s in (slice(0, 25), slice(25, 40)):
        a.update(y[s], pred[s])
        b.update(y[s], pred[s])
    assert (b.avg, str(b), b.to_dict()) == (a.avg, str(a), a.to_dict())
    pa, pb = jmet.PEMeter(), tmet.PEMeter()
    pa.update(y, score)
    pb.update(y, score)
    assert str(pb) == str(pa)
    assert tmet.ProgressMeter(3, [pb, b], "E").to_str(1) == \
        jmet.ProgressMeter(3, [pa, a], "E").to_str(1)


def test_b0_config_and_defaults_are_jax():
    assert ttrain.DEFAULT_CONFIG == jtrain.DEFAULT_CONFIG
    over = {"alpha": [0.1, 0.05], "freeze_bn": True, "crop": 256}
    assert ttrain.B0TrainConfig.validate(over) == JConfig.validate(over)


# --- the trainer end to end -------------------------------------------

TINY = dict(crop=64, batch_size=2, steps_per_epoch=2, num_epochs=2,
            val_steps=1, augment=True, alpha=[0.1, 0.05, 0.01],
            stem_init="highpass", quadratic_stem=True, parity_features=True,
            lr_schedule="cosine", compute_dtype="float32",
            tr_csv="split_tr.csv", va_csv="split_va.csv")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train-b0 --device cpu`` on data_ablation/p128 (freeze_bn off:
    batch statistics and head dropout live)."""
    from wsunet_tpu_torch.cli import main

    out = tmp_path_factory.mktemp("b0runs")
    assert main(["train-b0", "--data", str(P128), "--output-dir", str(out),
                 "--device", "cpu", "--config", json.dumps(TINY)]) == 0
    (run,) = (out / "LSBR").iterdir()
    return out, run


def test_train_b0_writes_the_jax_run_layout(trained):
    from wsunet_tpu.utils import registry as jreg
    from wsunet_tpu_torch.utils import create_run_name, registry

    out, run = trained
    stamp, platform, rest = run.name.split("-", 2)
    assert len(stamp) == 12 and platform == "cpu"
    config = json.loads((run / "config.json").read_text())
    assert rest == create_run_name(config)
    assert set(config) == set(jtrain.DEFAULT_CONFIG) | {"dataset"}
    assert sorted(p.name for p in run.iterdir()) == \
        ["best.npz", "config.json", "log", "model"]
    assert sorted(p.name for p in (run / "model").iterdir()) == \
        ["best", "latest"]
    rows = (run / "log" / "scalars.csv").read_text().split()
    assert [r.split(",")[:2] for r in rows] == [
        [str(e), f"{p}/{m}"] for e in range(2) for p in ("train", "val")
        for m in ("loss", "p_e", "p_md^5fp", "accuracy")]
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows)
    assert registry.get_model_name(out, "LSBR") == run.name
    assert jreg.get_model_name(out, "LSBR") == run.name
    # best.npz is model/best's parameters and running statistics, in the
    # Flax layout, and the training moved the statistics
    best = tck.load_checkpoint(run, "best")["params"]
    params, stats = tck.load_params(run)
    assert stats and all(k.startswith(("bn_", "stage")) for k in stats)
    sd = b0_state_dict_from_flax(params, stats)
    assert all(torch.equal(sd[k], best[k]) for k in sd
               if not k.endswith("num_batches_tracked"))
    assert float(best["bn_head.running_var"].sub(1).abs().max()) > 0


def test_trained_run_loads_in_detector_eval_and_in_jax(trained, tmp_path):
    """The run leaves the port: ``detector-eval --device cpu`` scores a
    catalog with it, and JAX's ``EfficientNetB0`` on its best.npz
    (params and batch_stats) gives the port's P(stego) (1e-4)."""
    import pandas as pd

    from torch_p128 import make_catalog
    from wsunet_tpu.detect.b0_eval import infer_b0 as jax_infer
    from wsunet_tpu_torch.cli import main
    from wsunet_tpu_torch.detect import infer_b0, load_pretrained_b0

    out, run = trained
    data = make_catalog(tmp_path / "data", n=4, alphas=(0.1,))
    assert main(["detector-eval", "--device", "cpu", "--data", str(data),
                 "--model-dir", str(out), "--stego-method", "LSBR",
                 "--results", str(tmp_path / "res")]) == 0
    df = pd.read_csv(tmp_path / "res" / "detection" / "b0.csv")
    assert len(df) == 8 and np.isfinite(df["output"]).all()

    params, stats = tck.load_params(run)
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 32)).astype(
        np.uint8)
    jmodel = jb0.get_b0(1, quadratic_stem=True, parity_features=True)
    want = np.asarray(jax_infer(jmodel, {"params": params,
                                         "batch_stats": stats},
                                jnp.asarray(x, jnp.float32)))
    model, _ = load_pretrained_b0(out / "LSBR", run.name, device="cpu")
    got = infer_b0(model, x, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("select, patience, epochs", [
    ("loss", 1, 2), ("p_e", 1, 2), ("last", 1, 3)])
def test_selection_and_patience(tmp_path, select, patience, epochs):
    """At learning rate 0 with frozen statistics every epoch validates
    alike: ``loss`` and ``p_e`` keep epoch 0 as the best and stop when
    patience runs out, ``last`` takes every epoch and runs to the end."""
    from wsunet_tpu_torch.train.train_b0 import train_names

    cfg = {**TINY, "num_epochs": 3, "learning_rate": 0.0,
           "lr_schedule": None, "freeze_bn": True, "select_metric": select,
           "patience": patience}
    run = train_names(cfg, P128, NAMES[:6], NAMES[6:8], tmp_path,
                      device="cpu")
    rows = (run / "log" / "scalars.csv").read_text().split()
    assert len(rows) == 8 * epochs
    assert tck.load_checkpoint(run, "best")["epoch"] == \
        (epochs - 1 if select == "last" else 0)
    assert tck.load_checkpoint(run, "latest")["epoch"] == epochs - 1


def test_resume_from_a_port_run_and_from_a_jax_export(trained, tmp_path):
    """``resume`` loads the named run's model/best (a port run) or its
    best.npz (the committed JAX export): at learning rate 0 with frozen
    statistics the resumed run's best.npz is its source's, parameters and
    running statistics, bit for bit."""
    from wsunet_tpu_torch.train.train_b0 import train_names

    out, src = trained
    cfg = {**TINY, "num_epochs": 1, "learning_rate": 0.0,
           "lr_schedule": None, "freeze_bn": True, "resume": src.name}
    names = NAMES[:4]
    run = train_names(cfg, P128, names, names[:2], out, device="cpu")
    for a, b in zip(tck.load_params(run), tck.load_params(src)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        assert sorted(fa) == sorted(fb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fb)
    shutil.copytree(B0_DIR / STRIDED, tmp_path / "LSBR" / STRIDED)
    cfg = {**cfg, "resume": STRIDED}
    run = train_names(cfg, P128, names, names[:2], tmp_path, device="cpu")
    for a, b in zip(tck.load_params(run), tck.load_params(B0_DIR / STRIDED)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        assert sorted(fa) == sorted(fb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fb)
    with pytest.raises(FileNotFoundError, match="resume"):
        train_names({**cfg, "resume": "missing"}, P128, names, names[:2],
                    tmp_path, device="cpu")


def test_bn_recalibrate_changes_only_the_statistics(trained, tmp_path):
    """``bn_recalibrate`` on a port run and on a copy of the committed JAX
    export: a ``-bnrecal`` sibling with model/best and best.npz and no
    latest, the parameters bit for bit the source's, every running
    statistic moved."""
    out, src = trained
    shutil.copytree(B0_DIR / STRIDED, tmp_path / "LSBR" / STRIDED)
    for family, run in ((out, src.name), (tmp_path, STRIDED)):
        dst = bn_recalibrate.recalibrate(family, "LSBR", run, num_batches=2,
                                         batch_size=2, data_path=P128,
                                         device="cpu")
        assert dst.name == run + "-bnrecal"
        assert sorted(p.name for p in (dst / "model").iterdir()) == ["best"]
        (p0, s0), (p1, s1) = (tck.load_params(family / "LSBR" / run),
                              tck.load_params(dst))
        f0, f1 = flatten_tree(p0), flatten_tree(p1)
        assert sorted(f0) == sorted(f1)
        assert all(np.array_equal(f0[k], f1[k]) for k in f0)
        g0, g1 = flatten_tree(s0), flatten_tree(s1)
        assert sorted(g0) == sorted(g1)
        assert all(not np.array_equal(g0[k], g1[k]) for k in g0)
        best = tck.load_checkpoint(dst, "best")["params"]
        sd = b0_state_dict_from_flax(p1, s1)
        assert all(torch.equal(sd[k], best[k]) for k in sd
                   if not k.endswith("num_batches_tracked"))
    assert bn_recalibrate.main([str(tmp_path), "LSBR", STRIDED, "1", "2",
                                "--data", str(P128), "--device", "cpu"]) \
        == 0


@pytest.mark.parametrize("override", [{"grayscale": False},
                                      {"demosaic_oracle": True}])
def test_configurations_jax_cannot_train_are_refused(tmp_path, override):
    """JAX builds its model with the planes the config names and feeds
    the grayscale plane: the first apply fails on the stem kernel's shape.
    The port refuses the configuration before it starts."""
    from flax.errors import ScopeParamShapeError

    cfg = JConfig.validate({**override, "parity_features": True})
    in_ch = (1 if cfg["grayscale"] else 3) + \
        (3 if cfg["demosaic_oracle"] else 0)
    jmodel = jb0.get_b0(in_channels=in_ch, parity_features=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, in_ch), jnp.float32))
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    with pytest.raises(ScopeParamShapeError):
        jmodel.apply(variables, jnp.zeros((2, 32, 32, 1), jnp.float32))
    with pytest.raises(UserError, match="cannot train"):
        ttrain.train_names({**TINY, **override}, P128, NAMES[:2], NAMES[:2],
                           tmp_path, device="cpu")
    assert not (tmp_path / "LSBR").exists()


def test_train_b0_refuses_without_a_card_and_a_row_selection():
    from wsunet_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(UserError, match="CUDA is not available"):
        ttrain.train(dict(TINY), P128, "/nonexistent")
    with pytest.raises(UserError, match="CUDA is not available"):
        bn_recalibrate.recalibrate(B0_DIR, "", STRIDED, data_path=P128)
    with pytest.raises(SystemExit, match="does not support --split/--take"):
        main(["train-b0", "--data", str(P128), "--split", "split_te.csv"])
