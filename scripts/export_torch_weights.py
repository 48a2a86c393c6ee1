"""Export trained Flax checkpoints for the PyTorch port, and the card's
golden file.

The committed checkpoints are Orbax OCDBT stores, which only JAX can read.
This script runs where the JAX package is (on the CPU) and writes what the
port reads with numpy and json alone:

    weights/unet/<method>/<run>/config.json   (copied)
    weights/unet/<method>/<run>/best.npz      (the f32 params tree,
                                               '/'-joined Flax paths)
    weights/b0/<method>/<run>/{config.json, best.npz}
                                              (the same, and the batch-norm
                                               running statistics under
                                               'batch_stats/')
    weights/golden/p128_lsbr.npz              (the card's golden files)
    weights/golden/p128_b0.npz
    weights/golden/p128_train_step.npz
    weights/golden/p128_b0_train_step.npz
    weights/golden/p128_filters.npz
    weights/golden/p128_analyses.npz

The golden file holds the 64 covers of ``data_ablation/p128``, their LSBr
stego at alpha 0.1 and 0.01 (drawn as ``python -m wsunet_tpu simulate``
draws them), and what the JAX package computes on them: beta_hat and l1 of
the LSBR ``unet_2`` (the ``unet-eval`` step, in f32 and in bf16), beta_hat
of the KB, KB-w
and KB-sca attacks, and the ROC summary (auc, p_e, wauc, pmd_5fp, tau0) of
``produce_roc`` per alpha and detector.  ``p128_b0.npz`` holds, on the
same images (not stored again), P(stego) of both LSBR B0 runs in f32 (and
in bf16 on the covers), the OLS taps fitted on the 64 covers and OLS
beta_hat, and the ``produce_roc`` summary of the two B0 labels of ``roc
--b0`` and of OLS; and a color4 OLS case on seeded synthetic RGB covers
and their stego (the pixels, the taps and beta_hat).

``p128_train_step.npz`` holds three steps of the JAX U-Net trainer
(``train/train_unet._make_step``) on covers of ``data_ablation/p128``, in
the committed LSBR recipe (crop, flips and rot90, alpha 0.4, weighted
``l1ws`` with lambda 0.25, lr 2e-5 under the cosine schedule) at crop 64,
batch 4, from the committed LSBR run: the batches and masks, every
draw of each step replayed from the trainer's key splits, the loss and the
gradients of the first step (in full for ``e1_conv1``, ``up1`` and
``outconv``, as a norm for every tensor), read by handing ``_make_step`` an
optimizer that returns the gradients as its state, and the loss of each of
three AdamW steps and every parameter's norm after them.

``p128_b0_train_step.npz`` holds steps of the JAX B0 trainer
(``train/train_b0._make_steps``) on covers of ``data_ablation/p128``, B=2
cover/stego pairs, from the committed strided LSBR B0 run (parameters and
running statistics), with every draw replayed from the trainer's key
splits (``jax_b0_step_draws``): in the committed recipe (``freeze_bn``,
high-pass stem, quadratic stem, parity features, alpha mix, flips and
rot90, lr 2e-5 under the cosine schedule) the loss, logits and gradients
of the first step (in full for the stem, one MBConv's depthwise,
squeeze-excite and projection convs, and the classifier; as a norm for
every tensor) and the loss of each of three AdamW steps with every
parameter's norm and distance from the start after them; one step with
``freeze_bn`` off (batch statistics, head dropout and the running update
live): its loss, logits, gradients and running statistics (in full for
the stem's and the head's norms, as norms for all), the table of its f32
preprocessing per pixel value, and the same step again with JAX's model
in float64 (``live64/``, ``jax_b0_live_step_f64``) as the exact reference
of that ill-conditioned step; and the stem kernel
of a ``get_b0(..., stem_init="highpass")`` init.  Its f32 steps round
with the host's core count and vector ISA, so it is computed in a child
process on one core, with one BLAS thread and XLA's CPU code capped at
AVX2 (``B0_TRAIN_XLA_FLAGS``).  ``p128_filters.npz``
holds ``filters-eval``'s per-image MAE and wMAE for KB and AVG on the 64
covers (channel 3, every ``inbayer``) and on the color4 case's covers and
stego (channels 0, 1 and 2).  ``p128_analyses.npz`` holds the analyses'
numbers on the 64 covers and their LSBr stego at alpha 0.1
(``golden_analyses``).

    python scripts/export_torch_weights.py                 # the defaults
    python scripts/export_torch_weights.py --run models/b0/HILLR/<run>
    python scripts/export_torch_weights.py --out /tmp/w --no-golden

The weights directory is not named ``models``: the card copy drops every
``models/*`` path.  Re-running the script gives the same arrays.
"""

import argparse
import pathlib
import shutil
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# the runs ``ws-eval --models UNet`` and ``roc`` need (LSBR l1ws and
# dropout l1), and HILLR, the third U-Net of ``correlation``
DEFAULT_RUNS = [
    "models/unet/LSBR/"
    "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_",
    "models/unet/dropout/"
    "260817015643-tpu-unet_2-grayscale_l1_lr_0.0001_dr_0.1",
    "models/unet/HILLR/"
    "260819120519-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_",
]
# the two LSBR B0 runs ``roc --b0`` uses (strided with parity features;
# no stem stride with the LSBr-reference plane); HILLR on demand
DEFAULT_B0_RUNS = [
    "models/b0/LSBR/260817154325-tpu-b0-alpha_mix0.1-0.05-0.01_grayscale_"
    "crossentropy_lr_2e-05_dr_0.2",
    "models/b0/LSBR/260818140316-tpu-b0-nostride-alpha_mix0.1-0.05-0.01_"
    "grayscale_crossentropy_lr_2e-05_dr_0.2",
]
P128 = REPO / "data_ablation" / "p128"
GOLDEN_ALPHAS = (0.1, 0.01)
GOLDEN_DETECTORS = ("KB", "KB-w", "KB-sca", "UNet")
GOLDEN_STATS = ("auc", "p_e", "wauc", "pmd_5fp", "tau0")
# the color4 OLS case: R predicted from G's 9 taps and R's 8 neighbours,
# on seeded smooth RGB covers and their LSB replacement in R
COLOR_CHANNELS = (1, 0)
COLOR_ALPHA = 0.4


def _cpu_jax():
    # pin the CPU before any backend starts: an accelerator plugin may
    # ignore the JAX_PLATFORMS variable
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def flatten_tree(tree, prefix: str = "", float_dtype=np.float32) -> dict:
    """Nested dict of arrays -> {'/'-joined path: ``float_dtype`` or
    integer array}."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        value = tree[key]
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_tree(dict(value), path, float_dtype))
        else:
            arr = np.asarray(value)
            out[path] = arr.astype(float_dtype) if arr.dtype.kind == "f" \
                else arr
    return out


def _is_b0(run_dir: pathlib.Path) -> bool:
    from wsunet_tpu.train.checkpoint import load_config
    return load_config(run_dir).get("network") == "b0"


def export_run(run_dir: pathlib.Path, out_root: pathlib.Path) -> pathlib.Path:
    """Restore ``<root>/<method>/<run>`` (a U-Net or a B0) with the JAX
    package's loader and write ``<out_root>/<method>/<run>/{config.json,
    best.npz}``."""
    _cpu_jax()
    run_dir = pathlib.Path(run_dir)
    if _is_b0(run_dir):
        from wsunet_tpu.detect.b0_eval import load_pretrained_b0 as load
    else:
        from wsunet_tpu.ws.unet_eval import load_pretrained_unet as load
    variables = load(run_dir.parent, run_dir.name)[1]
    arrays = flatten_tree(variables["params"])
    if variables.get("batch_stats"):
        arrays.update(flatten_tree(variables["batch_stats"], "batch_stats"))
    dst = pathlib.Path(out_root) / run_dir.parent.name / run_dir.name
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(run_dir / "config.json", dst / "config.json")
    np.savez(dst / "best.npz", **arrays)
    return dst


def _golden_sets(jax, names):
    """The p128 covers and their LSBr stego at GOLDEN_ALPHAS, as
    ``simulate`` draws them: {set name: uint8 [64, 128, 128]}."""
    import jax.numpy as jnp

    from wsunet_tpu.data import load_images
    from wsunet_tpu.data.simulate import image_key, simulate

    covers = load_images(P128, names)
    sets = {"cover": covers}
    for alpha in GOLDEN_ALPHAS:
        sets[str(alpha)] = np.stack([np.asarray(simulate(
            jnp.asarray(covers[i][None]), "LSBr", alpha,
            image_key(name)))[0] for i, name in enumerate(names)])
    return sets


def color_sets(n: int = 8, size: int = 64, seed: int = 7) -> np.ndarray:
    """Seeded smooth RGB covers and their stego (LSB replacement in R at
    COLOR_ALPHA), as uint8 [2, n, size, size, 4] planes [R, G, B, Y] (Y
    by the BT.601 fixed-point rounding of ``io.imread_gray_u8``)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 40, (n, size + 4, size + 4, 3)).cumsum(1).cumsum(2)
    base = base / np.abs(base).max(axis=(1, 2, 3), keepdims=True) * 90 + 120
    rgb = np.clip(base + rng.normal(0, 2, base.shape), 0, 255)
    cover = rgb[:, 2:-2, 2:-2].astype(np.uint8)
    stego = cover.copy()
    hit = rng.random(stego.shape[:3]) < COLOR_ALPHA
    bits = rng.integers(0, 2, stego.shape[:3], dtype=np.uint8)
    stego[..., 0] = np.where(hit, (stego[..., 0] & 0xFE) | bits,
                             stego[..., 0])

    def rgby(x):
        r, g, b = (x[..., i].astype(np.int64) for i in range(3))
        y = (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15
        return np.concatenate([x, y.clip(0, 255).astype(np.uint8)[..., None]],
                              axis=-1)

    return np.stack([rgby(cover), rgby(stego)])


def golden(run_dir: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """Compute the card's golden file with the JAX package on the CPU."""
    jax = _cpu_jax()
    import jax.numpy as jnp
    import pandas as pd

    from wsunet_tpu.data import precovers
    from wsunet_tpu.detect import produce_roc
    from wsunet_tpu.ops import NAMED_FILTERS_2D, ws_attack, ws_attack_sca
    from wsunet_tpu.ops import ws_estimate_unet
    from wsunet_tpu.ws.unet_eval import infer_unet, load_pretrained_unet

    run_dir = pathlib.Path(run_dir)
    names = list(precovers(P128)["name"])
    sets = _golden_sets(jax, names)

    def unet_step(dtype):                # ws/unet_eval._predict_frame
        model, variables, _ = load_pretrained_unet(
            run_dir.parent, run_dir.name, compute_dtype=dtype)

        @jax.jit
        def step(pixels):
            x = pixels.astype(jnp.float32)
            return ws_estimate_unet(x, infer_unet(model, variables, x))
        return step

    unet_steps = {"": unet_step(jnp.float32), "bf16/": unet_step(jnp.bfloat16)}

    kb = NAMED_FILTERS_2D["KB"]
    attacks = {                          # ws/estimate.attack_sweep's step
        "KB": jax.jit(lambda x: ws_attack(x, pixel_kernel=kb)),
        "KB-w": jax.jit(lambda x: ws_attack(x, pixel_kernel=kb, weighted=1)),
        "KB-sca": jax.jit(lambda x: ws_attack_sca(x, pixel_kernel=kb))}
    beta = {d: [] for d in GOLDEN_DETECTORS}
    unet = {f"{p}{k}": [] for p in unet_steps for k in ("beta", "l1")}
    for pixels in sets.values():
        # the eval sweeps' batch of 8
        batches = [jnp.asarray(pixels[i:i + 8]) for i in range(0, 64, 8)]
        for prefix, step in unet_steps.items():
            res = [step(b) for b in batches]
            for k, key in enumerate(("beta", "l1")):
                unet[prefix + key].append(
                    np.concatenate([np.asarray(r[k]) for r in res]))
        beta["UNet"].append(unet["beta"][-1])
        for det, step in attacks.items():
            beta[det].append(np.concatenate(
                [np.asarray(step(b)) for b in batches]))

    roc = np.zeros((len(GOLDEN_ALPHAS), len(GOLDEN_DETECTORS),
                    len(GOLDEN_STATS)))
    for a, alpha in enumerate(GOLDEN_ALPHAS):
        frames = []
        for det in GOLDEN_DETECTORS:
            for s, (method, alpha_s) in ((0, ("Cover", 0.0)),
                                         (a + 1, ("LSBR", alpha))):
                frames.append(pd.DataFrame({
                    "name": names, "stego_method": method, "alpha": alpha_s,
                    "beta_hat": beta[det][s].astype("float64"),
                    "model_name": det}))
        summary = produce_roc(pd.concat(frames)).drop_duplicates(
            ["model_name"]).set_index("model_name")
        for d, det in enumerate(GOLDEN_DETECTORS):
            roc[a, d] = [summary.loc[det, k] for k in GOLDEN_STATS]

    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out, run=np.array(run_dir.name), names=np.array(names),
        alphas=np.array(GOLDEN_ALPHAS), sets=np.array(list(sets)),
        pixels=np.stack(list(sets.values())),
        **{f"beta/{d}": np.stack(v).astype(np.float32)
           for d, v in beta.items()},
        l1=np.stack(unet["l1"]).astype(np.float32),
        **{k: np.stack(unet[k]).astype(np.float32)
           for k in ("bf16/beta", "bf16/l1")},
        detectors=np.array(GOLDEN_DETECTORS), stats=np.array(GOLDEN_STATS),
        roc=roc)
    return out


# the training golden file: the committed LSBR recipe (the resumed
# fine-tune of weights/unet/LSBR) at crop 64 on the 128x128 p128 covers;
# seed 6's first step draws both covers and stegos, and its mask drops the
# last row, so both branches and the masked mean are held
TRAIN_CONFIG = dict(
    network="unet_2", crop=64, augment=True, cover_fraction=0.5,
    stego_method="LSBR", alpha=0.4, loss="l1ws", loss_lambda=0.25,
    weighted_loss=True, learning_rate=2e-5, lr_schedule="cosine",
    batch_size=4, steps_per_epoch=3, num_epochs=10, seed=6)
TRAIN_STEPS = 3
TRAIN_FULL_GRADS = ("e1_conv1_kernel", "e1_conv1_bias", "up1/kernel",
                    "up1/bias", "outconv/kernel", "outconv/bias")


def jax_step_draws(jax, key, shape, cfg: dict, drop_rate=None) -> dict:
    """The draws the JAX trainer's step makes from ``key`` (the splits of
    ``_make_step``'s ``compute_loss``, and with ``drop_rate`` the input
    dropout's keep mask from the step's dropout key ``key[1]``), under the
    names of the port's ``train.train_unet.Sampler.draw``, as numpy."""
    B, H, W = shape
    key, dropout_key = key
    k_crop, k_aug, k_cover, k_embed = jax.random.split(key, 4)
    d, crop = {}, cfg.get("crop")
    h = w = None
    if crop is not None and crop < H:
        ki, kj = jax.random.split(k_crop)
        d["oi"] = jax.random.randint(ki, (B,), 0, H - crop + 1)
        d["oj"] = jax.random.randint(kj, (B,), 0, W - crop + 1)
        h = w = crop
    h, w = h or H, w or W
    if cfg.get("augment"):
        kf, kr = jax.random.split(k_aug)
        kh, kv = jax.random.split(kf)
        d["flip_h"] = jax.random.bernoulli(kh, shape=(B, 1, 1, 1)).reshape(B)
        d["flip_v"] = jax.random.bernoulli(kv, shape=(B, 1, 1, 1)).reshape(B)
        d["k"] = jax.random.randint(kr, (B,), 0, 4)
    d["is_stego"] = jax.random.bernoulli(
        k_cover, 1.0 - cfg.get("cover_fraction", 0.5), (B,))
    if (cfg.get("stego_method") or "").upper().startswith("LSB") and \
            cfg.get("alpha"):
        k1, k2 = jax.random.split(k_embed)
        d["embed"] = jax.random.uniform(k1, (B, h, w)) < cfg["alpha"]
        d["bits"] = jax.random.bernoulli(k2, 0.5, (B, h, w))
    if drop_rate:
        d["keep"] = jax_dropout_keep(jax, dropout_key, (B, h, w), drop_rate)
    return {k: np.asarray(v) for k, v in d.items()}


def jax_dropout_keep(jax, dropout_key, shape, rate: float) -> np.ndarray:
    """The keep mask [B, 1, h, w] that the Flax U-Net's ``input_dropout``
    draws from the dropout key of ``apply``: a probe module with a child
    of that name makes the same ``make_rng("dropout")`` call."""
    from flax import linen as nn

    B, h, w = shape

    class Child(nn.Module):
        @nn.compact
        def __call__(self):
            return jax.random.bernoulli(self.make_rng("dropout"),
                                        p=1.0 - rate, shape=(B, h, w, 1))

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return Child(name="input_dropout")()

    keep = Probe().apply({}, rngs={"dropout": dropout_key})
    return np.asarray(keep).transpose(0, 3, 1, 2)


def grad_capture():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients as its state: ``_make_step``'s ``train_step`` then
    returns the exact gradients as ``opt_state``."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def golden_train(run_dir: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """The training golden file, computed with the JAX trainer's own
    ``_make_step`` and ``make_optimizer`` on the CPU."""
    jax = _cpu_jax()
    import json

    import jax.numpy as jnp

    from wsunet_tpu.data import load_images, precovers
    from wsunet_tpu.models import get_model
    from wsunet_tpu.train.losses import get_loss
    from wsunet_tpu.train.train_unet import _make_step, make_optimizer
    from wsunet_tpu.ws.unet_eval import load_pretrained_unet

    cfg = TRAIN_CONFIG
    B = cfg["batch_size"]
    names = list(precovers(P128)["name"])[:TRAIN_STEPS * B]
    pixels = load_images(P128, names).reshape(TRAIN_STEPS, B, 128, 128)
    mask = np.ones((TRAIN_STEPS, B), bool)
    mask[0, -1] = False
    params = load_pretrained_unet(run_dir.parent, run_dir.name)[1]["params"]
    model = get_model(cfg["network"])
    loss_fn = get_loss(cfg["loss"], per_image=True,
                       loss_lambda=cfg["loss_lambda"])

    def steps(optimizer):
        return _make_step(model, loss_fn, optimizer, cfg["stego_method"],
                          cfg["alpha"], crop=cfg["crop"],
                          augment=cfg["augment"],
                          cover_fraction=cfg["cover_fraction"])[0]

    key = jax.random.PRNGKey(cfg["seed"])
    keys = []
    for _ in range(TRAIN_STEPS):
        key, ek, dk = jax.random.split(key, 3)
        keys.append((ek, dk))
    arrays = {"config": np.array(json.dumps(cfg)),
              "run": np.array(run_dir.name), "pixels": pixels, "mask": mask}
    for s, k in enumerate(keys):
        for name, v in jax_step_draws(jax, k, pixels[s].shape, cfg).items():
            arrays[f"draws/{s}/{name}"] = v

    _, grads, loss = steps(grad_capture())(
        params, grad_capture().init(params), jnp.asarray(pixels[0]),
        jnp.asarray(mask[0]), *keys[0])
    grads = flatten_tree(jax.tree.map(np.asarray, grads))
    arrays["loss"] = np.float32(loss)
    arrays.update({f"grad/{k}": grads[k] for k in TRAIN_FULL_GRADS})
    arrays.update({f"grad_norm/{k}": np.float32(np.linalg.norm(v))
                   for k, v in grads.items()})

    optimizer = make_optimizer(cfg, cfg["steps_per_epoch"])
    step = steps(optimizer)
    opt_state, losses = optimizer.init(params), []
    for s, k in enumerate(keys):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(pixels[s]),
                                       jnp.asarray(mask[s]), *k)
        losses.append(float(loss))
    arrays["adamw_loss"] = np.array(losses, np.float32)
    arrays.update({f"param_norm/{k}": np.float32(np.linalg.norm(v))
                   for k, v in flatten_tree(
                       jax.tree.map(np.asarray, params)).items()})
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return out


def golden_b0(b0_runs, out: pathlib.Path) -> pathlib.Path:
    """The B0 and OLS golden file, on the images of ``p128_lsbr.npz``,
    computed with the JAX package on the CPU."""
    jax = _cpu_jax()
    import jax.numpy as jnp
    import pandas as pd

    from wsunet_tpu.cli import b0_label
    from wsunet_tpu.data import precovers
    from wsunet_tpu.detect import produce_roc
    from wsunet_tpu.detect.b0_eval import infer_b0, load_pretrained_b0
    from wsunet_tpu.ops import ws_attack
    from wsunet_tpu.ops.ols import (fit_ols, fit_ols_color,
                                    ols_color_kernels, ols_color_predict,
                                    ols_kernel2d)

    names = list(precovers(P128)["name"])
    sets = _golden_sets(jax, names)
    pixels = np.stack(list(sets.values()))

    def per_set(step, sets=pixels):
        # the eval sweeps' batch of 8
        return np.stack([np.concatenate([np.asarray(step(jnp.asarray(
            p[i:i + 8]))) for i in range(0, len(p), 8)]) for p in sets])

    arrays, labels = {}, []
    for run in map(pathlib.Path, b0_runs):
        # f32 on every set; bf16 (slow on the CPU) on the covers
        for prefix, dtype, images in (("prob", jnp.float32, pixels),
                                      ("prob_bf16", jnp.bfloat16,
                                       pixels[:1])):
            model, variables, config = load_pretrained_b0(
                run.parent, run.name, compute_dtype=dtype)
            ref = bool(config.get("lsbr_reference"))
            step = jax.jit(lambda x, m=model, v=variables, r=ref: infer_b0(
                m, v, x.astype(jnp.float32), use_lsbr_reference=r))
            arrays[f"{prefix}/{b0_label(config)}"] = \
                per_set(step, images).astype(np.float32)
        labels.append(b0_label(config))

    covers = pixels[0].astype(np.float32)
    taps = fit_ols(covers)
    kernel = ols_kernel2d(covers)[::-1, ::-1]    # as ws/estimate.run
    arrays["beta/OLS"] = per_set(jax.jit(
        lambda x: ws_attack(x, pixel_kernel=kernel))).astype(np.float32)

    detectors = labels + ["OLS"]
    roc = np.zeros((len(GOLDEN_ALPHAS), len(detectors), len(GOLDEN_STATS)))
    for a, alpha in enumerate(GOLDEN_ALPHAS):
        frames = []
        for s, (method, alpha_s) in ((0, ("Cover", 0.0)),
                                     (a + 1, ("LSBR", alpha))):
            for label in labels:
                frames.append(pd.DataFrame({
                    "name": names, "stego_method": method, "alpha": alpha_s,
                    "score": arrays[f"prob/{label}"][s], "model_name": label}))
            frames.append(pd.DataFrame({
                "name": names, "stego_method": method, "alpha": alpha_s,
                "beta_hat": arrays["beta/OLS"][s].astype("float64"),
                "model_name": "OLS"}))
        summary = produce_roc(pd.concat(frames)).drop_duplicates(
            ["model_name"]).set_index("model_name")
        for d, det in enumerate(detectors):
            roc[a, d] = [summary.loc[det, k] for k in GOLDEN_STATS]

    color = color_sets()
    kernels = ols_color_kernels(color[0].astype(np.float32), COLOR_CHANNELS)
    plane = COLOR_CHANNELS[-1]

    @jax.jit
    def color_step(x4):
        x_hat = ols_color_predict(x4.astype(jnp.float32), kernels)
        return ws_attack(x4[..., plane], pixel_estimator=lambda _: x_hat)

    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out, names=np.array(names), runs=np.array([r.name for r in map(
            pathlib.Path, b0_runs)]), labels=np.array(labels),
        detectors=np.array(detectors), stats=np.array(GOLDEN_STATS),
        alphas=np.array(GOLDEN_ALPHAS), sets=np.array(list(sets)),
        **arrays, **{"ols/taps": taps}, roc=roc,
        **{"color/pixels": color,
           "color/channels": np.array(COLOR_CHANNELS),
           "color/taps": fit_ols_color(color[0].astype(np.float32),
                                       COLOR_CHANNELS),
           "color/beta": np.stack([np.asarray(color_step(jnp.asarray(c)))
                                   for c in color]).astype(np.float32)})
    return out


# the B0 training golden file: the committed strided recipe (the config of
# weights/b0/LSBR/260817154325-*) on the 128x128 p128 covers, B=2 pairs;
# two epochs of three steps, so the cosine schedule has no warmup and every
# AdamW step moves the parameters; the first step's mask drops its second
# image, so the masked mean is held
B0_TRAIN_CONFIG = dict(
    network="b0", crop=512, augment=True, stego_method="LSBR",
    alpha=[0.1, 0.05, 0.01], val_alpha=[0.1, 0.05, 0.01], learning_rate=2e-5,
    lr_schedule="cosine", batch_size=2, steps_per_epoch=3, num_epochs=2,
    drop_rate=0.2, stem_init="highpass", quadratic_stem=True,
    parity_features=True, freeze_bn=True, compute_dtype="float32", seed=3)
B0_TRAIN_STEPS = 3
B0_LIVE_SEED = 5
B0_FULL_GRADS = (
    "conv_stem/kernel", "stage1_block0/dw_conv/kernel",
    "stage1_block0/se/reduce/kernel", "stage1_block0/se/reduce/bias",
    "stage1_block0/se/expand/kernel", "stage1_block0/se/expand/bias",
    "stage1_block0/project_conv/kernel", "classifier/kernel",
    "classifier/bias")
B0_FULL_STATS = ("bn_stem/mean", "bn_stem/var", "bn_head/mean",
                 "bn_head/var")


def jax_b0_step_draws(jax, key, shape, cfg: dict, rates,
                      drop_rate=None) -> dict:
    """The draws the JAX B0 trainer's step makes from ``key`` = (the
    step's key, its dropout key): ``make_pair``'s splits (crop, flips and
    quarter turns, the per-image rate, LSBr's mask and bits) and with
    ``drop_rate`` the head dropout's keep mask [2B, 1280], under the names
    of the port's ``train.train_b0.B0Sampler.draw``, as numpy."""
    import jax.numpy as jnp

    B, H, W = shape
    key, dropout_key = key
    k_crop, k_aug, k_alpha, k_embed = jax.random.split(key, 4)
    d, crop = {}, cfg.get("crop")
    h, w = H, W
    if crop is not None and crop < H:
        ki, kj = jax.random.split(k_crop)
        d["oi"] = jax.random.randint(ki, (B,), 0, H - crop + 1)
        d["oj"] = jax.random.randint(kj, (B,), 0, W - crop + 1)
        h = w = crop
    if cfg.get("augment"):
        kf, kr = jax.random.split(k_aug)
        kh, kv = jax.random.split(kf)
        d["flip_h"] = jax.random.bernoulli(kh, shape=(B, 1, 1, 1)).reshape(B)
        d["flip_v"] = jax.random.bernoulli(kv, shape=(B, 1, 1, 1)).reshape(B)
        d["k"] = jax.random.randint(kr, (B,), 0, 4)
    if isinstance(rates, (list, tuple)):
        r = jnp.asarray(rates, jnp.float32)
        d["alphas"] = r[jax.random.randint(k_alpha, (B,), 0, len(r))]
    else:
        d["alphas"] = jnp.full((B,), float(rates), jnp.float32)
    if cfg["stego_method"].upper().startswith("LSB"):
        k1, k2 = jax.random.split(k_embed)
        d["embed"] = jax.random.uniform(k1, (B, h, w)) < \
            d["alphas"][:, None, None]
        d["bits"] = jax.random.bernoulli(k2, 0.5, (B, h, w))
    if drop_rate:
        d["keep"] = jax_head_dropout_keep(jax, dropout_key, 2 * B, drop_rate)
    return {k: np.asarray(v) for k, v in d.items()}


def jax_head_dropout_keep(jax, dropout_key, n: int, rate: float,
                          width: int = 1280) -> np.ndarray:
    """The keep mask [n, width] that the Flax B0's head ``nn.Dropout``
    (auto-named ``Dropout_0``) draws from the dropout key of ``apply``:
    a probe module with a child of that name makes the same
    ``make_rng("dropout")`` call."""
    from flax import linen as nn

    class Child(nn.Module):
        @nn.compact
        def __call__(self):
            return jax.random.bernoulli(self.make_rng("dropout"),
                                        p=1.0 - rate, shape=(n, width))

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return Child(name="Dropout_0")()

    return np.asarray(Probe().apply({}, rngs={"dropout": dropout_key}))


class _Capture:
    """A Flax module's stand-in for ``_make_steps`` that keeps, through a
    host callback, the inputs of each ``apply``."""

    def __init__(self, module):
        self.module, self.inputs = module, []

    def apply(self, variables, x, **kw):
        import jax

        jax.debug.callback(lambda v: self.inputs.append(np.asarray(v)), x)
        return self.module.apply(variables, x, **kw)


def jax_b0_live_step_f64(module, params, stats, x, mask, keep,
                         rate: float) -> tuple:
    """The JAX B0 trainer's live step (``loss_fn`` in training mode) with
    ``module`` (compute dtype float64) under ``jax.enable_x64``, on the
    inputs ``x`` [2B, H, W, C] that the f32 step fed its model: parameters,
    statistics, inputs and loss in float64.  Two calls of the model are
    intercepted: the head dropout applies the f32 step's keep mask (under
    x64 ``jax.random`` would draw another), and the classifier, which the
    model fixes to f32, runs in float64 on its (f32-cast) input, as its
    f32 rounding alone moves the step's gradients by about 4e-5.  ->
    (loss, logits, gradients, running statistics), as numpy."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as nn

    def in_float64(next_fun, args, kwargs, context):
        mod, v = context.module, args[0] if args else None
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(mod, nn.Dropout):
            return jax.lax.select(jnp.asarray(keep), v / (1.0 - rate),
                                  jnp.zeros_like(v))
        if isinstance(mod, nn.Dense):
            p = mod.variables["params"]
            return v.astype(jnp.float64) @ p["kernel"] + p["bias"]
        return next_fun(*args, **kwargs)

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     t)
        B = len(mask)
        y = jnp.concatenate([jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.int32)])
        w = jnp.asarray(np.concatenate([mask, mask]), jnp.float64)

        def loss_fn(p):
            logits, mutated = module.apply(
                {"params": p, "batch_stats": f64(stats)}, f64(x), train=True,
                mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0), \
                (logits, mutated["batch_stats"])

        with nn.intercept_methods(in_float64):
            (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(f64(params))
        return tuple(jax.tree.map(np.asarray, v)
                     for v in (loss, logits, grads, new_stats))


def recording(inner):
    """An optax transformation that runs ``inner`` and keeps the last
    gradients beside its state: ``_make_steps``' ``train_step`` then
    returns, as ``opt_state[1]``, the exact gradients of its step, and one
    compiled step serves the gradients and the AdamW steps."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return inner.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state[0], params)
        return updates, (inner_state, grads)

    return optax.GradientTransformation(init, update)


# XLA's CPU code for the B0 training golden file: its f32 steps (convs,
# batch norms, the optimizer) round differently with the host's core count
# (Eigen's thread split of a reduction) and vector ISA (AVX2 or AVX-512):
# 610 of its 1,334 arrays moved between two hosts.  One core and AVX2 give
# the same file on every x86 host with AVX2 (and one BLAS thread, for
# numpy's norms of the arrays).
B0_TRAIN_XLA_FLAGS = "--xla_cpu_multi_thread_eigen=false " \
    "--xla_cpu_max_isa=AVX2"


def golden_b0_train(run_dir: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """The B0 training golden file, computed with the JAX trainer's own
    ``_make_steps`` and ``make_optimizer`` on the CPU, in a child process
    of this script (``--b0-train-golden``) pinned to one core under
    ``B0_TRAIN_XLA_FLAGS``: the caller's JAX may already run with other
    flags, which XLA reads once a process."""
    import os
    import subprocess

    # numpy's BLAS (the norms) splits its dot products by thread too
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": B0_TRAIN_XLA_FLAGS, "OPENBLAS_NUM_THREADS": "1",
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                    "--b0-train-golden", str(run_dir), str(out)],
                   env=env, check=True, timeout=1800)
    return out


def _golden_b0_train(run_dir: pathlib.Path, out: pathlib.Path) -> None:
    """``golden_b0_train``'s child: one core, then the JAX steps."""
    import os

    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
    jax = _cpu_jax()
    import json

    import jax.numpy as jnp

    from wsunet_tpu.data import load_images, precovers
    from wsunet_tpu.data.transforms import normalize
    from wsunet_tpu.detect.b0_eval import (IMAGENET_GREEN_MEAN,
                                           IMAGENET_GREEN_STD,
                                           load_pretrained_b0)
    from wsunet_tpu.models import get_b0
    from wsunet_tpu.train.config import B0TrainConfig
    from wsunet_tpu.train.train_b0 import _make_steps
    from wsunet_tpu.train.train_unet import make_optimizer

    cfg = B0TrainConfig.validate(B0_TRAIN_CONFIG)
    B = cfg["batch_size"]
    names = list(precovers(P128)["name"])[:(B0_TRAIN_STEPS + 1) * B]
    pixels = load_images(P128, names).reshape(B0_TRAIN_STEPS + 1, B, 128,
                                               128)
    mask = np.ones((B0_TRAIN_STEPS + 1, B), bool)
    mask[0, -1] = False
    variables = load_pretrained_b0(run_dir.parent, run_dir.name)[1]
    params0, stats0 = variables["params"], variables["batch_stats"]

    def model(c, dtype=jnp.float32):
        return get_b0(in_channels=1, no_stem_stride=c["no_stem_stride"],
                      drop_rate=c["drop_rate"], stem_init=c["stem_init"],
                      quadratic_stem=c["quadratic_stem"],
                      parity_features=c["parity_features"], norm=c["norm"],
                      compute_dtype=dtype)

    def keys(seed, n):
        key, out = jax.random.PRNGKey(seed), []
        for _ in range(n):
            key, ek, dk = jax.random.split(key, 3)
            out.append((ek, dk))
        return out

    def flat(tree):
        return flatten_tree(jax.tree.map(np.asarray, tree))

    arrays = {"config": np.array(json.dumps(B0_TRAIN_CONFIG)),
              "run": np.array(run_dir.name), "pixels": pixels, "mask": mask}

    # the committed recipe: three AdamW steps, the first one's gradients
    opt = recording(make_optimizer(cfg, cfg["steps_per_epoch"]))
    step = _make_steps(model(cfg), opt, cfg)[0]
    params, stats, state = params0, stats0, opt.init(params0)
    losses = []
    for s, k in enumerate(keys(cfg["seed"], B0_TRAIN_STEPS)):
        for name, v in jax_b0_step_draws(jax, k, pixels[s].shape, cfg,
                                         cfg["alpha"]).items():
            arrays[f"draws/{s}/{name}"] = v
        params, stats, state, loss, logits, _ = step(
            params, stats, state, jnp.asarray(pixels[s]),
            jnp.asarray(mask[s]), *k)
        losses.append(float(loss))
        if s == 0:
            grads = flat(state[1])
            arrays["loss"] = np.float32(loss)
            arrays["logits"] = np.asarray(logits, np.float32)
            arrays.update({f"grad/{k}": grads[k] for k in B0_FULL_GRADS})
            arrays.update({f"grad_norm/{k}": np.float32(np.linalg.norm(v))
                           for k, v in grads.items()})
    arrays["adamw_loss"] = np.array(losses, np.float32)
    start, end = flat(params0), flat(params)
    arrays.update({f"param_norm/{k}": np.float32(np.linalg.norm(v))
                   for k, v in end.items()})
    arrays.update({f"param_delta/{k}": np.float32(np.linalg.norm(
        v - start[k])) for k, v in end.items()})

    # one live step: batch statistics, head dropout, the running update
    live = {**cfg, "freeze_bn": False}
    opt = recording(make_optimizer(live, live["steps_per_epoch"]))
    capture = _Capture(model(live))
    step = _make_steps(capture, opt, live)[0]
    (k,) = keys(B0_LIVE_SEED, 1)
    s = B0_TRAIN_STEPS
    for name, v in jax_b0_step_draws(jax, k, pixels[s].shape, live,
                                     live["alpha"],
                                     drop_rate=live["drop_rate"]).items():
        arrays[f"live/draws/{name}"] = v
    _, stats, state, loss, logits, _ = step(
        params0, stats0, opt.init(params0), jnp.asarray(pixels[s]),
        jnp.asarray(mask[s]), *k)
    grads, stats = flat(state[1]), flat(stats)
    arrays["live/loss"] = np.float32(loss)
    arrays["live/logits"] = np.asarray(logits, np.float32)
    arrays.update({f"live/grad/{k}": grads[k] for k in B0_FULL_GRADS})
    arrays.update({f"live/grad_norm/{k}": np.float32(np.linalg.norm(v))
                   for k, v in grads.items()})
    arrays.update({f"live/stats/{k}": stats[k] for k in B0_FULL_STATS})
    arrays.update({f"live/stats_norm/{k}": np.float32(np.linalg.norm(v))
                   for k, v in stats.items()})

    # the same live step with the model in float64, on its inputs; XLA
    # divides by 255 and 0.224 as multiplications, so a jitted step's f32
    # inputs lie up to an ulp from an eager division: the table of the
    # jitted preprocessing lets the port's float64 reference take them
    jax.effects_barrier()
    (x,) = capture.inputs
    lut = np.asarray(jax.jit(lambda u: normalize(
        u.astype(jnp.float32) / 255.0, IMAGENET_GREEN_MEAN,
        IMAGENET_GREEN_STD))(jnp.arange(256, dtype=jnp.uint8)))
    assert np.isin(x[..., 0], lut).all()
    arrays["live/preprocess_lut"] = lut
    loss, logits, grads, stats = jax_b0_live_step_f64(
        model(live, jnp.float64), params0, stats0, x, mask[s],
        arrays["live/draws/keep"], live["drop_rate"])
    grads, stats = (flatten_tree(t, float_dtype=np.float64)
                    for t in (grads, stats))
    arrays["live64/loss"] = np.float64(loss)
    arrays["live64/logits"] = np.asarray(logits, np.float64)
    arrays.update({f"live64/grad/{k}": grads[k] for k in B0_FULL_GRADS})
    arrays.update({f"live64/grad_norm/{k}": np.linalg.norm(v)
                   for k, v in grads.items()})
    arrays.update({f"live64/stats/{k}": stats[k] for k in B0_FULL_STATS})
    arrays.update({f"live64/stats_norm/{k}": np.linalg.norm(v)
                   for k, v in stats.items()})

    # the high-pass stem of a fresh init (parity features: 2 input planes)
    v = jax.jit(model(cfg).init)({"params": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                                 jnp.zeros((1, 32, 32, 1), jnp.float32))
    arrays["init/conv_stem/kernel"] = np.asarray(
        v["params"]["conv_stem"]["kernel"], np.float32)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)


FILTERS = ("KB", "AVG")
INBAYER = (None, "00", "01", "10", "11")


def golden_filters(out: pathlib.Path) -> pathlib.Path:
    """``filters-eval``'s per-image MAE and wMAE, computed with the JAX
    package's step on the CPU: on the 64 covers of ``p128_lsbr.npz`` for
    each filter and ``inbayer``, and on the color4 case (``color_sets``)
    for each filter and channel 0-2."""
    jax = _cpu_jax()
    import jax.numpy as jnp

    from wsunet_tpu.data import load_images, precovers
    from wsunet_tpu.ops import NAMED_FILTERS
    from wsunet_tpu.ops.filters import taps_to_kernel2d
    from wsunet_tpu.ws.filters_eval import _mae_wmae_batch

    names = list(precovers(P128)["name"])
    covers = load_images(P128, names)
    color = color_sets()
    arrays = {"names": np.array(names), "filters": np.array(FILTERS),
              "inbayer": np.array([b or "none" for b in INBAYER])}
    for f in FILTERS:
        kernel = taps_to_kernel2d(NAMED_FILTERS[f])
        for b in INBAYER:
            step = _mae_wmae_batch(kernel, channel=3, inbayer=b)
            res = [step(jnp.asarray(covers[i:i + 8]))
                   for i in range(0, len(covers), 8)]
            for j, key in enumerate(("mae", "wmae")):
                arrays[f"{key}/{f}/{b or 'none'}"] = np.concatenate(
                    [np.asarray(r[j]) for r in res]).astype(np.float32)
        for c in range(3):
            step = _mae_wmae_batch(kernel, channel=c)
            res = [step(jnp.asarray(p)) for p in color]
            for j, key in enumerate(("mae", "wmae")):
                arrays[f"color/{key}/{f}/{c}"] = np.stack(
                    [np.asarray(r[j]) for r in res]).astype(np.float32)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return out


# the analyses golden file: correlation's predictors (its filters, then
# its U-Nets in the JAX CLI's order), error-boxes' populations, the
# difference images of two covers and four saliency points of one
ANALYSES_FILTERS = ("1", "AVG9", "AVG", "KB")
ANALYSES_UNETS = ("dropout", "LSBR", "HILLR")
ANALYSES_BOXES = (("dropout", "UNet_l1"), ("LSBR", "UNet_l1ws"))
ANALYSES_ALPHA = 0.1
ANALYSES_DIFF_COVERS = (0, 40)
ANALYSES_SALIENCY_COVER = 0
ANALYSES_POINTS = ((20, 30), (64, 64), (100, 110), (9, 25))


def golden_analyses(out: pathlib.Path) -> pathlib.Path:
    """The analyses' numbers, computed with the JAX package on the CPU
    from the committed U-Net runs (``models/unet``), on the 64 covers of
    ``p128_lsbr.npz`` and their LSBr stego at ``ANALYSES_ALPHA``:
    ``correlation``'s per-pair correlation and p-value of each predictor
    (the step of ``analyses.correlation.run_correlation``), the
    ``ae_boxes_3.csv`` statistics of ``error-boxes`` on the covers (every
    pixel: ``num_pixels`` None, the JAX default), ``contour``'s KB and
    LSBR U-Net difference images of two covers, and ``saliency``'s LSBR
    patches at four points of one cover with its ``sobel_locations``."""
    jax = _cpu_jax()
    import jax.numpy as jnp

    from wsunet_tpu.analyses.contour import difference_image
    from wsunet_tpu.analyses.correlation import pair_correlation
    from wsunet_tpu.analyses.error_boxes import (_filter_abs_residuals,
                                                 _unet_abs_residuals,
                                                 bucket_quantiles)
    from wsunet_tpu.analyses.saliency import sobel_locations, unet_saliency
    from wsunet_tpu.data import precovers
    from wsunet_tpu.ops import NAMED_FILTERS_2D, filter_predict
    from wsunet_tpu.train.checkpoint import load_config
    from wsunet_tpu.utils.registry import get_model_name
    from wsunet_tpu.ws.unet_eval import get_unet_estimator

    unet_dir = REPO / "models" / "unet"
    df = precovers(P128)
    names = list(df["name"])
    sets = _golden_sets(jax, names)
    covers = sets["cover"].astype("float32")
    stegos = sets[str(ANALYSES_ALPHA)].astype("float32")
    arrays = {"names": np.array(names), "alpha": np.array(ANALYSES_ALPHA)}

    predictors, unet_runs = [], {}
    for name in ANALYSES_FILTERS:
        predictors.append((name, jax.jit(
            lambda x, k=NAMED_FILTERS_2D[name]: filter_predict(x, k))))
    for method in ANALYSES_UNETS:
        run = get_model_name(unet_dir, method)
        unet_runs[method] = run
        loss = load_config(unet_dir / method / run).get("loss", "")
        predictors.append((f"UNet_{method}_{loss}",
                           get_unet_estimator(unet_dir / method, run)))
    for label, predict in predictors:
        x_hats = np.asarray(predict(jnp.asarray(stegos)))
        res = np.array([pair_correlation(covers[i], stegos[i], x_hats[i])
                        for i in range(len(names))])
        arrays[f"correlation/{label}"] = res[:, 0]
        arrays[f"p-value/{label}"] = res[:, 1]
    arrays["correlation_models"] = np.array([lb for lb, _ in predictors])
    arrays["unet_runs"] = np.array([unet_runs[m] for m in ANALYSES_UNETS])

    results = {"KB": _filter_abs_residuals(P128, df, "KB", None),
               "AVG": _filter_abs_residuals(P128, df, "AVG", None)}
    for method, label in ANALYSES_BOXES:
        results[label] = _unet_abs_residuals(
            P128, df, get_unet_estimator(unet_dir / method,
                                         unet_runs[method]), None)
    boxes = bucket_quantiles(results, anchor="KB")
    arrays["boxes/Type"] = boxes["Type"].to_numpy(str)
    arrays["boxes/edge_interval"] = boxes["edge_interval"].to_numpy(str)
    arrays["boxes/columns"] = np.array(list(boxes.columns[2:]))
    arrays["boxes/stats"] = boxes.iloc[:, 2:].to_numpy(np.float64)

    diff = [P128 / names[i] for i in ANALYSES_DIFF_COVERS]
    arrays["diff/names"] = np.array([names[i] for i in ANALYSES_DIFF_COVERS])
    arrays["diff/KB"] = np.stack([difference_image(f, "KB") for f in diff])
    arrays["diff/UNet"] = np.stack([difference_image(
        f, "UNet", model_dir=unet_dir, stego_method="LSBR") for f in diff])

    fname = P128 / names[ANALYSES_SALIENCY_COVER]
    arrays["saliency/name"] = np.array(names[ANALYSES_SALIENCY_COVER])
    arrays["saliency/points"] = np.array(ANALYSES_POINTS)
    arrays["saliency/patches"] = np.stack([
        unet_saliency(fname, i, j, unet_dir, "LSBR")
        for i, j in ANALYSES_POINTS]).astype(np.float32)
    locs = sobel_locations(fname)
    arrays["sobel/keys"] = np.array(list(locs))
    arrays["sobel/points"] = np.array([tuple(map(int, v))
                                       for v in locs.values()])
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--b0-train-golden"]:
        _golden_b0_train(pathlib.Path(argv[1]), pathlib.Path(argv[2]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", type=pathlib.Path,
                    help="a run directory <root>/<family>/<method>/<run>, "
                         "family unet or b0 (repeat; default: the committed "
                         "U-Net LSBR and dropout runs and B0 LSBR runs)")
    ap.add_argument("--out", type=pathlib.Path, default=REPO / "weights",
                    help="output root (default: weights/)")
    ap.add_argument("--no-golden", action="store_true",
                    help="skip the golden files under weights/golden")
    args = ap.parse_args(argv)
    runs = args.run or [REPO / r for r in DEFAULT_RUNS + DEFAULT_B0_RUNS]
    for run in runs:
        family = "b0" if _is_b0(run) else "unet"
        print(f"exported {export_run(run, args.out / family)}")
    if not args.no_golden:
        for out in (golden(REPO / DEFAULT_RUNS[0],
                           args.out / "golden" / "p128_lsbr.npz"),
                    golden_b0([REPO / r for r in DEFAULT_B0_RUNS],
                              args.out / "golden" / "p128_b0.npz"),
                    golden_train(REPO / DEFAULT_RUNS[0], args.out / "golden"
                                 / "p128_train_step.npz"),
                    golden_b0_train(REPO / DEFAULT_B0_RUNS[0], args.out /
                                    "golden" / "p128_b0_train_step.npz"),
                    golden_filters(args.out / "golden" /
                                   "p128_filters.npz"),
                    golden_analyses(args.out / "golden" /
                                    "p128_analyses.npz")):
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
