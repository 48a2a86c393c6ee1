"""Export trained Flax checkpoints for the PyTorch port, and the card's
golden file.

The committed checkpoints are Orbax OCDBT stores, which only JAX can read.
This script runs where the JAX package is (on the CPU) and writes what the
port reads with numpy and json alone:

    weights/unet/<method>/<run>/config.json   (copied)
    weights/unet/<method>/<run>/best.npz      (the f32 params tree,
                                               '/'-joined Flax paths)
    weights/golden/p128_lsbr.npz              (the card's golden file)

The golden file holds the 64 covers of ``data_ablation/p128``, their LSBr
stego at alpha 0.1 and 0.01 (drawn as ``python -m wsunet_tpu simulate``
draws them), and what the JAX package computes on them: beta_hat and l1 of
the LSBR ``unet_2`` (the ``unet-eval`` step, in f32 and in bf16), beta_hat
of the KB, KB-w
and KB-sca attacks, and the ROC summary (auc, p_e, wauc, pmd_5fp, tau0) of
``produce_roc`` per alpha and detector.

    python scripts/export_torch_weights.py                 # the defaults
    python scripts/export_torch_weights.py --run models/unet/HILLR/<run>
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

# the two runs ``ws-eval --models UNet`` and ``roc`` need (LSBR l1ws and
# dropout l1); HILLR is exported on demand with --run
DEFAULT_RUNS = [
    "models/unet/LSBR/"
    "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_",
    "models/unet/dropout/"
    "260817015643-tpu-unet_2-grayscale_l1_lr_0.0001_dr_0.1",
]
P128 = REPO / "data_ablation" / "p128"
GOLDEN_ALPHAS = (0.1, 0.01)
GOLDEN_DETECTORS = ("KB", "KB-w", "KB-sca", "UNet")
GOLDEN_STATS = ("auc", "p_e", "wauc", "pmd_5fp", "tau0")


def _cpu_jax():
    # pin the CPU before any backend starts: an accelerator plugin may
    # ignore the JAX_PLATFORMS variable
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> {'/'-joined path: f32 or integer array}."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        value = tree[key]
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(flatten_tree(dict(value), path))
        else:
            arr = np.asarray(value)
            out[path] = arr.astype(np.float32) if arr.dtype.kind == "f" \
                else arr
    return out


def export_run(run_dir: pathlib.Path, out_root: pathlib.Path) -> pathlib.Path:
    """Restore ``<root>/<method>/<run>`` with the JAX package's loader and
    write ``<out_root>/<method>/<run>/{config.json, best.npz}``."""
    _cpu_jax()
    from wsunet_tpu.ws.unet_eval import load_pretrained_unet

    run_dir = pathlib.Path(run_dir)
    _, variables, _ = load_pretrained_unet(run_dir.parent, run_dir.name)
    dst = pathlib.Path(out_root) / run_dir.parent.name / run_dir.name
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(run_dir / "config.json", dst / "config.json")
    np.savez(dst / "best.npz", **flatten_tree(variables["params"]))
    return dst


def golden(run_dir: pathlib.Path, out: pathlib.Path) -> pathlib.Path:
    """Compute the card's golden file with the JAX package on the CPU."""
    jax = _cpu_jax()
    import jax.numpy as jnp
    import pandas as pd

    from wsunet_tpu.data import load_images, precovers
    from wsunet_tpu.data.simulate import image_key, simulate
    from wsunet_tpu.detect import produce_roc
    from wsunet_tpu.ops import NAMED_FILTERS_2D, ws_attack, ws_attack_sca
    from wsunet_tpu.ops import ws_estimate_unet
    from wsunet_tpu.ws.unet_eval import infer_unet, load_pretrained_unet

    run_dir = pathlib.Path(run_dir)
    df = precovers(P128)
    names = list(df["name"])
    covers = load_images(P128, names)
    sets = {"cover": covers}
    for alpha in GOLDEN_ALPHAS:
        sets[str(alpha)] = np.stack([np.asarray(simulate(
            jnp.asarray(covers[i][None]), "LSBr", alpha,
            image_key(name)))[0] for i, name in enumerate(names)])

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", action="append", type=pathlib.Path,
                    help="a run directory <root>/<method>/<run> (repeat; "
                         "default: the committed LSBR and dropout runs)")
    ap.add_argument("--out", type=pathlib.Path, default=REPO / "weights",
                    help="output root (default: weights/)")
    ap.add_argument("--no-golden", action="store_true",
                    help="skip weights/golden/p128_lsbr.npz")
    args = ap.parse_args(argv)
    runs = args.run or [REPO / r for r in DEFAULT_RUNS]
    for run in runs:
        print(f"exported {export_run(run, args.out / 'unet')}")
    if not args.no_golden:
        out = golden(REPO / DEFAULT_RUNS[0],
                     args.out / "golden" / "p128_lsbr.npz")
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
