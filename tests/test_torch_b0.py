"""Port parity: the EfficientNet-B0 model (wsunet_tpu_torch.models.b0,
``models.convert.b0_state_dict_from_flax``, ``data.transforms``) against
the JAX package's, on the CPU.  The trained runs and the detection runs
are held in tests/test_torch_b0_runs.py.

Tolerance: the B0 forward on seeded weights and randomised batch
statistics, logits within rtol 1e-4 / atol 1e-5 of JAX's (f32 conv sums in
another order, about 1e-6 relative a layer).  bf16: no further from JAX's
f32 than twice JAX's own bf16.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsunet_tpu.data import transforms as jax_transforms
from wsunet_tpu.models import get_b0 as jax_get_b0
from wsunet_tpu_torch.data import transforms
from wsunet_tpu_torch.models import b0 as b0_mod
from wsunet_tpu_torch.models import b0_state_dict_from_flax, get_b0

# each switch on in at least one case; the first two are the committed
# runs' configurations
CASES = {
    "strided-parity-quad": dict(in_channels=1, parity_features=True,
                                quadratic_stem=True),
    "nostride-ref-quad": dict(in_channels=2, no_stem_stride=True,
                              quadratic_stem=True),
    "strided-plain": dict(in_channels=1),
    "nostride-group": dict(in_channels=1, no_stem_stride=True,
                           norm="group"),
}


def _seeded_variables(model, cin: int, seed: int) -> dict:
    """Flax variables of ``model`` drawn with numpy: LeCun-normal kernels,
    small biases, norm scales around 1, and randomised running
    statistics (so that a swapped mean and var cannot pass).  Their
    shapes do not depend on the image size."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, cin), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "mean":
            return rng.normal(0, 0.5, s.shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape)
        return rng.normal(0, 0.1, s.shape)     # biases

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)


def _input(size: int, case: dict, seed: int):
    """Seeded uint8 pixels through each package's transforms: /255, the
    LSBr-reference plane for a 2-channel model, ImageNet green
    normalisation.  Returns (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (2, size, size)).astype(np.float32)
    xj = jnp.asarray(px)[..., None] / 255.0
    xt = torch.from_numpy(px)[:, None] / 255.0
    if case["in_channels"] == 2:
        xj = jax_transforms.lsbr_reference(xj)
        xt = transforms.lsbr_reference(xt)
    xj = jax_transforms.normalize(xj, 0.456, 0.224)
    xt = transforms.normalize(xt, 0.456, 0.224)
    return np.asarray(xj), xt


@functools.lru_cache(maxsize=None)
def _variables(case: str) -> dict:
    kw = CASES[case]
    return _seeded_variables(jax_get_b0(**kw), kw["in_channels"],
                             seed=sorted(CASES).index(case))


@functools.lru_cache(maxsize=None)
def _case(case: str, size: int, dtype=jnp.float32):
    """(Flax variables, JAX logits, port input) of one case: variables
    seeded by the case, pixels by the size; one compile each."""
    kw = CASES[case]
    jmodel = jax_get_b0(**kw, compute_dtype=dtype)
    variables = _variables(case)
    xj, xt = _input(size, kw, seed=size)
    np.testing.assert_array_equal(xj.transpose(0, 3, 1, 2), xt.numpy())
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, xj))
    return variables, want, xt


@pytest.mark.parametrize("size", [64, 67])
@pytest.mark.parametrize("case", sorted(CASES))
def test_b0_forward_matches_jax(case, size):
    """Even and odd sizes: Flax's SAME padding at stride 2 pads 0 before
    and 1 after on an even size (k=3), 1 and 1 on an odd one."""
    variables, want, xt = _case(case, size)
    model = get_b0(**CASES[case]).eval()
    model.load_state_dict(b0_state_dict_from_flax(
        variables["params"], variables.get("batch_stats")))
    with torch.no_grad():
        got = model(xt).numpy()
    assert got.shape == (2, 2) and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_b0_bf16_stays_within_jax_bf16_distance():
    """bf16 (convs and activations; norms in f32, classifier in f32) on
    the committed nostride configuration: no further from JAX's f32 than
    twice JAX's own bf16, and not equal to the f32 result."""
    case = "nostride-ref-quad"
    variables, want32, xt = _case(case, 64)
    want16 = _case(case, 64, jnp.bfloat16)[1]
    model = get_b0(**CASES[case], compute_dtype=torch.bfloat16).eval()
    model.load_state_dict(b0_state_dict_from_flax(
        variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = model(xt)
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - want32).max()
    assert 0 < d <= 2 * np.abs(want16 - want32).max()


@pytest.mark.parametrize("size", [7, 8, 64, 67])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_padding_matches_xla(size, k, stride):
    """The port's conv (TF-style explicit padding when strided) against
    ``lax.conv_general_dilated(..., "SAME")`` on a depthwise kernel."""
    rng = np.random.default_rng(size * k + stride)
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 1, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=3))
    conv = b0_mod._Conv(3, 3, k, stride=stride, groups=3)
    conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape[-1] == math.ceil(size / stride)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_converter_uses_every_flax_leaf_once(norm):
    """Every Flax leaf maps to one torch key of the right shape, and the
    state dict is exactly the model's (a strict load)."""
    jmodel = jax_get_b0(in_channels=2, quadratic_stem=True, norm=norm)
    variables = _seeded_variables(jmodel, 2, seed=0)
    leaves = {"params": jax.tree_util.tree_leaves(variables["params"]),
              "batch_stats": jax.tree_util.tree_leaves(
                  variables.get("batch_stats", {}))}
    sd = b0_state_dict_from_flax(variables["params"],
                                 variables.get("batch_stats"))
    model = get_b0(in_channels=2, quadratic_stem=True, norm=norm)
    want = model.state_dict()
    assert set(sd) == set(want)
    model.load_state_dict(sd, strict=True)
    counted = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert len(counted) == len(leaves["params"]) + len(leaves["batch_stats"])
    assert all(sd[k].shape == want[k].shape for k in sd)
    assert (norm == "batch") == any("running_var" in k for k in sd)
    n_params = sum(int(np.prod(a.shape)) for a in leaves["params"])
    assert n_params == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", ["lsbr_reference", "parity_oracle",
                                  "demosaic_oracle", "normalize",
                                  "normalize-per-channel"])
def test_transforms_match_jax(name):
    """On values whose x*255 falls on .5 too (round half to even)."""
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (2, 5, 7)).astype(np.float32)
    px[0, 0, :4] = [0.5, 1.5, 2.5, 254.5]
    x = px / 255.0
    if name == "normalize":
        want = jax_transforms.normalize(jnp.asarray(x)[..., None],
                                        0.456, 0.224)
        got = transforms.normalize(torch.from_numpy(x)[:, None], 0.456,
                                   0.224)
    elif name == "normalize-per-channel":
        x2 = np.stack([x, x[:, ::-1]], axis=-1)
        want = jax_transforms.normalize(jnp.asarray(x2), [0.485, 0.456],
                                        [0.229, 0.224])
        got = transforms.normalize(
            torch.from_numpy(x2.copy()).permute(0, 3, 1, 2),
            [0.485, 0.456], [0.229, 0.224])
    else:
        want = getattr(jax_transforms, name)(jnp.asarray(x)[..., None])
        got = getattr(transforms, name)(torch.from_numpy(x)[:, None])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))


