"""Command-line interface (port of ``wsunet_tpu/cli.py``).

    python -m wsunet_tpu_torch filters-eval   KB/AVG prediction error
                                              (MAE, wMAE)
    python -m wsunet_tpu_torch ws-eval        WS attack sweep
    python -m wsunet_tpu_torch unet-eval      U-Net inference + WS error
    python -m wsunet_tpu_torch detector-eval  B0 detector scores
    python -m wsunet_tpu_torch roc            ROC/AUC/P_E over WS and B0
                                              detectors
    python -m wsunet_tpu_torch train-unet     train the U-Net predictor
    python -m wsunet_tpu_torch train-b0       train the B0 detector
    python -m wsunet_tpu_torch correlation    residual/change correlation
    python -m wsunet_tpu_torch error-boxes    AE boxplots bucketed by KB
                                              error
    python -m wsunet_tpu_torch contour        difference-image contours
    python -m wsunet_tpu_torch saliency       U-Net gradient saliency grid
    python -m wsunet_tpu_torch init-dataset   files.csv + split CSVs for a
                                              cover folder
    python -m wsunet_tpu_torch simulate       generate stego fixtures
    python -m wsunet_tpu_torch serve          single-image WS estimation
                                              loop

The flags and defaults are the JAX CLI's, and the commands write the same
files (``prediction/filters.csv``, ``estimation/ws_sweep_<train>.csv``,
``estimation/ws_<method>.csv``, ``detection/b0.csv``,
``detection/{auc,roc}_<alpha>.csv``, ``roc_<alpha>.png``, a training run's
directory, ``estimation/correlation.csv``, ``prediction/ae_boxes_3.{csv,
png}``, ``prediction/contour_<model>_<stem>.png``,
``prediction/saliency_<method>.png`` and ``saliency_image_dots.png``,
``files.csv`` and ``split_{tr,va,te}.csv``, and
``stego_<method>_alpha_<alpha>_independent_images/`` with its
``files.csv``; ``serve`` prints one JSON line an image), with these
differences: the model directories default to the exported runs where the
JAX CLI's default to ``models/`` (``--model-dir`` / ``--unet-model-dir``
``weights/unet``, ``detector-eval --model-dir`` / ``--b0-model-dir``
``weights/b0``; ``scripts/export_torch_weights.py``), ``--device`` picks
the device (default CUDA; without a card a command exits with one line,
and ``serve`` has no fallback to the CPU), and ``--fast-conv`` runs the
U-Net's 3x3 convs through kernel B1 instead of cuDNN.  ``ws-eval --models
OLS`` fits the OLS predictor on the covers, in the colour layouts for two
or three ``--channels``.  ``simulate --method LSBr`` draws from torch
generators seeded per image as the JAX CLI seeds its keys, so its stego
pixels are not the JAX CLI's (HILLr's are).  pandas, PIL, matplotlib and
seaborn are imported by the commands.  The sweeps (``ws-eval``,
``unet-eval``, ``detector-eval``, ``roc``) and the trainers use every
rank they are started with (``parallel.distributed.distributed_init``:
``torchrun --nproc-per-node N -m wsunet_tpu_torch ...``; without
``torchrun`` one process): each rank sweeps its own rows or trains on
its block of each batch, and rank 0 alone writes the CSVs, figures and
runs.  Every command runs under
``utils.profiling.profile($WSUNET_PROFILE)`` and, with
``WSUNET_DEBUG_NANS=1``, ``nan_check``.  ``bench`` belongs to the
benchmark, not yet ported.  The B0 recalibration is ``python -m
wsunet_tpu_torch.train.bn_recalibrate``.
"""

import argparse
import json
import pathlib
import sys

from .utils.errors import UserError

WEIGHTS = pathlib.Path("weights/unet")
B0_WEIGHTS = pathlib.Path("weights/b0")


def _common(p):
    p.add_argument("--data", type=pathlib.Path, default=pathlib.Path("data"),
                   help="dataset root (with files.csv subdirs)")
    p.add_argument("--results", type=pathlib.Path,
                   default=pathlib.Path("results"), help="output root")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--split", default=None,
                   help="restrict to a split CSV (e.g. split_te.csv)")
    p.add_argument("--take", type=int, default=None,
                   help="take only the first N images")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run without "
                        "a card)")
    p.add_argument("--fast-conv", action="store_true",
                   help="run the U-Net's 3x3 convs through kernel B1 (the "
                        "port's reflect-conv kernel) instead of cuDNN")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="wsunet_tpu_torch",
        description="WS steganalysis on PyTorch / CUDA")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("filters-eval",
                       help="KB/AVG prediction error (MAE/wMAE)")
    _common(p)
    p.add_argument("--filters", nargs="+", default=["AVG", "KB"])
    p.add_argument("--channels", nargs="+", type=int, default=None,
                   help="[R,G,B,Y] plane per filter (default: Y for each)")
    p.add_argument("--inbayer", default=None, choices=["00", "01", "10", "11"],
                   help="Bayer-phase subsample of the residual grid")

    p = sub.add_parser("ws-eval", help="WS attack sweep")
    _common(p)
    p.add_argument("--models", nargs="+", default=["AVG", "KB"],
                   help="filter names and/or UNet")
    p.add_argument("--model-dir", type=pathlib.Path, default=WEIGHTS)
    p.add_argument("--train-method", default="LSBR",
                   help="stego method the UNet was trained on")
    p.add_argument("--stego-methods", nargs="+", default=["LSBR"],
                   help="stego methods to attack (covers always included)")
    p.add_argument("--alphas", nargs="+", type=float, default=[.4, .2, .1])
    p.add_argument("--weighted", type=int, default=0, choices=[-1, 0, 1])
    p.add_argument("--correct-bias", action="store_true")
    p.add_argument("--channels", nargs="+", type=int, default=[3],
                   help="[R,G,B,Y] planes: attacked channel last; two or "
                        "three channels select the color4/color8 OLS layout")

    p = sub.add_parser("unet-eval",
                       help="U-Net inference + WS prediction error")
    _common(p)
    p.add_argument("--model-dir", type=pathlib.Path, default=WEIGHTS)
    p.add_argument("--stego-method", default="LSBR",
                   help="training method of the model (dropout/LSBR/HILLR)")

    p = sub.add_parser("detector-eval", help="B0 detector scores")
    _common(p)
    p.add_argument("--model-dir", type=pathlib.Path, default=B0_WEIGHTS)
    p.add_argument("--stego-method", default="LSBR")
    p.add_argument("--no-stem-stride", action="store_true")
    p.add_argument("--lsbr-reference", action="store_true")

    p = sub.add_parser("roc", help="ROC/AUC/P_E over WS + B0 detectors")
    _common(p)
    p.add_argument("--unet-model-dir", type=pathlib.Path, default=WEIGHTS)
    p.add_argument("--b0-model-dir", type=pathlib.Path, default=B0_WEIGHTS)
    p.add_argument("--train-method", default="LSBR")
    p.add_argument("--stego-methods", nargs="+", default=["LSBR"],
                   help="stego methods to build curves for (e.g. HILLR)")
    p.add_argument("--alphas", nargs="+", type=float, default=[.1, .05, .01])
    p.add_argument("--models", nargs="+",
                   default=["AVG", "KB", "KB-w", "KB-sca", "UNet"])
    p.add_argument("--b0", action="store_true", help="include B0 detectors")
    p.add_argument("--b0-train-alpha", type=float, default=None,
                   help="registry filter on the B0 training alpha (labels "
                        "always come from the model's own config)")

    p = sub.add_parser("train-unet", help="train the U-Net predictor")
    _common(p)
    p.add_argument("--output-dir", type=pathlib.Path,
                   default=pathlib.Path("models/unet"))
    p.add_argument("--config", type=json.loads, default={},
                   help='JSON config overrides, e.g. \'{"alpha":0.4}\'')

    p = sub.add_parser("train-b0", help="train the B0 detector")
    _common(p)
    p.add_argument("--output-dir", type=pathlib.Path,
                   default=pathlib.Path("models/b0"))
    p.add_argument("--config", type=json.loads, default={},
                   help='JSON config overrides, e.g. \'{"alpha":0.01}\'')

    p = sub.add_parser("correlation", help="residual/change correlation")
    _common(p)
    p.add_argument("--model-dir", type=pathlib.Path, default=None)

    p = sub.add_parser("error-boxes", help="AE boxplots bucketed by KB error")
    _common(p)
    p.add_argument("--model-dir", type=pathlib.Path, default=None)
    p.set_defaults(split="split_te.csv")

    p = sub.add_parser("contour", help="difference-image contours")
    _common(p)
    p.add_argument("--image", default="images/6.png")
    p.add_argument("--model-dir", type=pathlib.Path, default=None)

    p = sub.add_parser("saliency", help="U-Net gradient saliency grid")
    _common(p)
    p.add_argument("--image", default="images/6.png")
    p.add_argument("--model-dir", type=pathlib.Path, default=WEIGHTS)
    p.add_argument("--stego-method", default="LSBR")
    p.add_argument("--points", type=json.loads,
                   default=[[307, 10], [261, 64], [155, 381], [9, 25]])

    p = sub.add_parser("init-dataset",
                       help="build files.csv + split CSVs for a cover folder")
    _common(p)
    p.add_argument("--images-dir", default="images")
    p.add_argument("--fractions", nargs=3, type=float, default=[.6, .2, .2])

    p = sub.add_parser("simulate", help="generate stego fixture directories")
    _common(p)
    p.add_argument("--method", choices=["LSBr", "HILLr"], default="LSBr")
    p.add_argument("--alphas", nargs="+", type=float,
                   default=[.01, .05, .1, .2, .4, 1.0])

    p = sub.add_parser(
        "serve", help="single-image WS estimation loop (batch-1 path)")
    p.add_argument("images", nargs="*", type=pathlib.Path,
                   help="image paths; with none given, one path per "
                        "stdin line")
    p.add_argument("--model-dir", type=pathlib.Path, default=WEIGHTS)
    p.add_argument("--train-method", default="LSBR")
    p.add_argument("--size", type=int, default=512,
                   help="served image height/width (one serving shape)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--measure-latency", action="store_true",
                   help="print the latency report (median, launch floor, "
                        "net, streamed and serial img/s) and exit")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run without "
                        "a card)")
    p.add_argument("--fast-conv", action="store_true",
                   help="run the U-Net's 3x3 convs through kernel B1")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import os

    from .utils.profiling import nan_check, profile
    try:
        with profile(os.environ.get("WSUNET_PROFILE")), \
                nan_check(os.environ.get("WSUNET_DEBUG_NANS") == "1"):
            try:
                return _dispatch(args)
            finally:
                from .data.pipeline import clear_device_cache
                clear_device_cache()
    except (UserError, FileNotFoundError) as e:
        # a missing model or data directory is the user's, not a bug: one
        # line; WSUNET_DEBUG=1 keeps the traceback
        if os.environ.get("WSUNET_DEBUG") == "1":
            raise
        raise SystemExit(f"{args.command}: {e}")


# the commands that use every rank of a process group
SHARDED = ("ws-eval", "unet-eval", "detector-eval", "roc", "train-unet",
           "train-b0")


def _dispatch(args):
    if args.command not in SHARDED:
        return _run(args)
    import torch.distributed as dist

    from .parallel.distributed import distributed_init
    started = not dist.is_initialized()
    distributed_init(device=args.device)
    started = started and dist.is_initialized()
    try:
        return _run(args)
    finally:
        if started:
            dist.destroy_process_group()


def _rank0() -> bool:
    """Whether this process writes the command's files: rank 0 of the
    process group, or the only process."""
    from .parallel import get_mesh
    return get_mesh().rank == 0


def _write_csv(res, out):
    if _rank0():
        out.parent.mkdir(parents=True, exist_ok=True)
        res.to_csv(out, index=False)
        print(f"output saved to {out}")


def _run(args):
    cmd = args.command
    # commands that do not walk the catalog refuse a row selection instead
    # of ignoring it
    if (getattr(args, "split", None) or getattr(args, "take", None)) and \
            cmd in ("contour", "saliency", "simulate", "train-unet",
                    "train-b0", "init-dataset"):
        raise SystemExit(f"{cmd} does not support --split/--take")
    if cmd == "filters-eval":
        from .ws import filters_run
        channels = ([(c,) for c in args.channels] if args.channels
                    else [(3,)] * len(args.filters))
        res = filters_run(args.data, filter_names=args.filters,
                          channels=channels, inbayer=args.inbayer,
                          batch_size=args.batch_size, split=args.split,
                          take_num_images=args.take, device=args.device)
        out = args.results / "prediction" / "filters.csv"
        out.parent.mkdir(parents=True, exist_ok=True)
        res.to_csv(out, index=False)
        print(f"output saved to {out}")
    elif cmd == "ws-eval":
        _write_csv(_ws_sweep(args), args.results / "estimation" /
                   f"ws_sweep_{args.train_method}.csv")
    elif cmd == "unet-eval":
        from .ws import unet_run
        res = unet_run(args.data, args.model_dir, args.stego_method,
                       batch_size=args.batch_size, split=args.split,
                       take_num_images=args.take, fast_conv=args.fast_conv,
                       device=args.device)
        _write_csv(res, args.results / "estimation" /
                   f"ws_{args.stego_method}.csv")
    elif cmd == "detector-eval":
        from .detect import b0_run
        res = b0_run(args.data, args.model_dir, args.stego_method,
                     no_stem_stride=args.no_stem_stride,
                     lsbr_reference=args.lsbr_reference,
                     batch_size=args.batch_size, split=args.split,
                     take_num_images=args.take, device=args.device)
        _write_csv(res, args.results / "detection" / "b0.csv")
    elif cmd == "roc":
        _cmd_roc(args)
    elif cmd == "train-unet":
        from .train.train_unet import train
        exp = train(args.config, data_path=args.data,
                    output_dir=args.output_dir, device=args.device)
        if _rank0():
            print(f"experiment saved to {exp}")
    elif cmd == "train-b0":
        from .train.train_b0 import train
        exp = train(args.config, data_path=args.data,
                    output_dir=args.output_dir, device=args.device)
        if _rank0():
            print(f"experiment saved to {exp}")
    elif cmd == "correlation":
        from .analyses import run_correlation
        unet = ("dropout", "LSBR", "HILLR") if args.model_dir else ()
        res, agg = run_correlation(
            args.data, model_dir=args.model_dir, unet_methods=unet,
            split=args.split, take_num_images=args.take,
            batch_size=args.batch_size, fast_conv=args.fast_conv,
            device=args.device)
        out = args.results / "estimation" / "correlation.csv"
        out.parent.mkdir(parents=True, exist_ok=True)
        agg.to_csv(out)
        print(f"output saved to {out}")
    elif cmd == "error-boxes":
        from .analyses import run_error_boxes
        unet = (("dropout", "UNet_l1"), ("LSBR", "UNet_l1ws")) \
            if args.model_dir else ()
        out = args.results / "prediction" / "ae_boxes_3.csv"
        run_error_boxes(args.data, model_dir=args.model_dir,
                        split=args.split, unet_models=unet, outfile=out,
                        batch_size=args.batch_size, fast_conv=args.fast_conv,
                        device=args.device)
        print(f"output saved to {out}")
    elif cmd == "contour":
        from .analyses import difference_image, plot_contour
        fname = args.data / args.image
        outdir = args.results / "prediction"
        models = ["KB"] + (["unet"] if args.model_dir else [])
        for model in models:
            d = difference_image(
                fname, model_name="KB" if model == "KB" else "UNet",
                model_dir=args.model_dir, fast_conv=args.fast_conv,
                device=args.device)
            print("saved", plot_contour(fname, d, model, outdir))
    elif cmd == "saliency":
        from .analyses.saliency import plot_saliency_grid, render_dots
        out = (args.results / "prediction" /
               f"saliency_{args.stego_method}.png")
        plot_saliency_grid(args.data / args.image, args.model_dir,
                           args.stego_method,
                           [tuple(p) for p in args.points], out,
                           fast_conv=args.fast_conv, device=args.device)
        print(f"output saved to {out}")
        dots = render_dots(args.data / args.image,
                           args.results / "prediction" /
                           "saliency_image_dots.png", device=args.device)
        print(f"output saved to {dots}")
    elif cmd == "init-dataset":
        from .data.init_dataset import init_dataset
        df = init_dataset(args.data, images_dir=args.images_dir,
                          split_fractions=tuple(args.fractions))
        print(f"catalogued {len(df)} covers under {args.data}")
    elif cmd == "simulate":
        _cmd_simulate(args)
    elif cmd == "serve":
        _cmd_serve(args)
    return 0


def _cmd_serve(args):
    """One image at a time through ``serve.UNetWSServer``: one JSON line
    an image on stdout (``{"name", "beta_hat", "l1"}``, or ``{"name",
    "error"}`` without stopping).  Paths given as arguments are streamed
    (``serve.stream_paths``); with none, each stdin line is answered
    before the next is read (``serve.serve_lines``)."""
    import torch

    from .serve import load_server, measure_latency, serve_lines, stream_paths

    dtype = getattr(torch, args.dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise UserError(f"--dtype {args.dtype} is not a torch float type")
    server, name = load_server(args.model_dir, args.train_method, args.size,
                               dtype, fast_conv=args.fast_conv,
                               device=args.device)
    print(f"serve: {args.train_method}/{name} at {args.size}x{args.size} "
          f"({args.dtype}, fast_conv={args.fast_conv}, {server.device})",
          file=sys.stderr)
    if args.measure_latency:
        print(json.dumps(measure_latency(server)))
        return
    outs = (stream_paths(server, [str(p) for p in args.images])
            if args.images else serve_lines(server, sys.stdin))
    for out in outs:
        print(json.dumps(out), flush=True)


def _ws_sweep(args):
    """Named filters plus both trained U-Nets, UNet_l1 (dropout-trained)
    and UNet_l1ws_<method>, in one run.  'UNet' in --models expands to
    both; 'UNet_l1' / 'UNet_l1ws' select one."""
    import pandas as pd

    from .utils.registry import get_model_name
    from .ws import ws_run

    unet_variants = {
        "UNET": [("l1", "dropout"), ("l1ws", args.train_method)],
        "UNET_L1": [("l1", "dropout")],
        "UNET_L1WS": [("l1ws", args.train_method)],
    }
    frames = []
    for stego_method in [None] + list(args.stego_methods):
        for alpha in (args.alphas if stego_method else [None]):
            for model in args.models:
                variants = unet_variants.get(model.upper())
                if variants is None:
                    jobs = [(model, None, None)]
                else:
                    jobs = []
                    for loss, tm in variants:
                        try:
                            name = get_model_name(
                                args.model_dir, tm, loss=loss)
                        except RuntimeError as e:
                            print(f"skipping UNet {loss}/{tm}: {e}",
                                  file=sys.stderr)
                            continue
                        label = ("UNet_" + loss +
                                 (f"_{tm}" if loss == "l1ws" else ""))
                        jobs.append((name, args.model_dir / tm, label))
                for model_name, model_path, label in jobs:
                    frames.append(ws_run(
                        input_dir=args.data, stego_method=stego_method,
                        alpha=alpha, model_name=model_name,
                        model_path=model_path,
                        channels=tuple(args.channels),
                        weighted=args.weighted,
                        correct_bias=args.correct_bias,
                        batch_size=args.batch_size,
                        split=args.split, take_num_images=args.take,
                        model_label=label, fast_conv=args.fast_conv,
                        device=args.device))
    res = pd.concat(frames).reset_index(drop=True)
    if "stego_method" in res:
        res["stego_method"] = res["stego_method"].fillna("Cover")
    else:
        res["stego_method"] = "Cover"
    return res


def b0_label(config: dict) -> str:
    """Detector label from the model's own training config, as the JAX
    CLI builds it: ``ns-`` (no stem stride), ``r-`` (LSBr reference),
    ``B0``, ``-<method>`` unless LSBR, ``_<alpha>`` (``mix<a>-<b>-...`` for a
    rate mixture), e.g. ``ns-r-B0_mix0.1-0.05-0.01``."""
    prefix = ("ns-" if config.get("no_stem_stride") else "") + \
        ("r-" if config.get("lsbr_reference") else "")
    alpha = config.get("alpha")
    if isinstance(alpha, (list, tuple)):
        alpha = "mix" + "-".join(str(a) for a in alpha)
    method = config.get("stego_method", "LSBR")
    infix = "" if method == "LSBR" else f"-{method}"
    return f"{prefix}B0{infix}_{alpha}"


def _b0_frames(args) -> list:
    """The rows of both B0 configurations (strided; no stem stride with
    the LSBr reference) trained on --train-method, labelled by
    ``b0_label``; a configuration without a run is skipped with a note."""
    from .detect import b0_run
    from .train.checkpoint import load_config
    from .utils.registry import get_model_name

    frames = []
    for no_stride, lsbr_ref in [(False, False), (True, True)]:
        filters = dict(no_stem_stride=no_stride, lsbr_reference=lsbr_ref)
        if args.b0_train_alpha is not None:
            filters["alpha"] = args.b0_train_alpha
        try:
            name = get_model_name(args.b0_model_dir, args.train_method,
                                  **filters)
            res = b0_run(args.data, args.b0_model_dir, args.train_method,
                         model_name=name, no_stem_stride=no_stride,
                         lsbr_reference=lsbr_ref, batch_size=args.batch_size,
                         split=args.split, take_num_images=args.take,
                         device=args.device)
        except (UserError, FileNotFoundError) as e:
            print(f"skipping B0 ns={no_stride} r={lsbr_ref}: {e}",
                  file=sys.stderr)
            continue
        config = load_config(args.b0_model_dir / args.train_method / name)
        res = res[(res["stego_method"].isna()) |
                  (res["alpha"].isin(args.alphas))].copy()
        res["model_name"] = b0_label(config)
        res["score"] = res["output"]
        frames.append(res)
    return frames


def _cmd_roc(args):
    import pandas as pd

    from .detect import produce_roc
    from .utils.registry import get_model_name
    from .ws import ws_run
    # "UNet" is the --train-method model on every eval method; another
    # method of --stego-methods with its own trained model joins as
    # "UNet_<method>", with its own cover pass
    unet_variants = {}
    if any(m.upper() == "UNET" for m in args.models):
        methods = [args.train_method] + [
            sm for sm in args.stego_methods if sm != args.train_method]
        for tm in methods:
            label = "UNet" if tm == args.train_method else f"UNet_{tm}"
            try:
                unet_variants[label] = get_model_name(
                    args.unet_model_dir, tm), args.unet_model_dir / tm
            except UserError as e:
                print(f"skipping {label}: {e}", file=sys.stderr)

    frames = []
    for stego_method in [None] + list(args.stego_methods):
        for alpha in (args.alphas if stego_method else [None]):
            for model in args.models:
                if model.upper() == "UNET":
                    for label, (name, path) in unet_variants.items():
                        frames.append(ws_run(
                            input_dir=args.data, stego_method=stego_method,
                            alpha=alpha, model_name=name, model_path=path,
                            model_label=label, weighted=0,
                            batch_size=args.batch_size,
                            split=args.split, take_num_images=args.take,
                            fast_conv=args.fast_conv, device=args.device))
                else:
                    frames.append(ws_run(
                        input_dir=args.data, stego_method=stego_method,
                        alpha=alpha, model_name=model,
                        model_path=None, weighted=0,
                        batch_size=args.batch_size,
                        split=args.split, take_num_images=args.take,
                        device=args.device))
    if args.b0:
        frames += _b0_frames(args)

    res = pd.concat(frames).reset_index(drop=True)
    res["stego_method"] = res["stego_method"].fillna("Cover")
    res["alpha"] = res["alpha"].fillna(0.0)
    df_roc = produce_roc(res)
    if not _rank0():
        return

    alpha = args.alphas[-1]
    outdir = args.results / "detection"
    outdir.mkdir(parents=True, exist_ok=True)
    df_auc = df_roc[["stego_method", "model_name", "auc", "p_e", "wauc",
                     "pmd_5fp", "tau0", "fpr_tau0", "tpr_tau0", "fpr_50",
                     "tpr_50"]].drop_duplicates()
    df_auc.to_csv(outdir / f"auc_{alpha}.csv", index=False)
    pivot = df_roc.pivot(index=["tau"],
                         columns=["stego_method", "model_name"],
                         values=["tpr", "fpr"])
    pivot.columns = ["_".join(c).strip() for c in pivot.columns.values]
    pivot.to_csv(outdir / f"roc_{alpha}.csv", index=False)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    for label, df_i in df_roc.groupby("label"):
        df_i = df_i.sort_values("tau")
        ax.plot(df_i["fpr"], df_i["tpr"], label=label)
    ax.plot([0, 1], [0, 1], linestyle="--", color="gray", label="Random")
    ax.set_xlabel("False Positive Rate (FPR)")
    ax.set_ylabel("True Positive Rate (TPR)")
    ax.legend(loc="lower right")
    fig.savefig(outdir / f"roc_{alpha}.png", bbox_inches="tight", dpi=300)
    plt.close(fig)
    print(df_auc.to_string())
    print(f"outputs saved to {outdir}")


def _cmd_simulate(args):
    """Stego copies of every cover at each alpha, one PNG each and a
    ``files.csv``, in the JAX CLI's layout; each image is embedded on
    ``--device`` with its own generator (``data.simulate.image_key``)."""
    import pandas as pd
    from PIL import Image

    import torch

    from ._device import resolve_device
    from .data import load_images, precovers
    from .data.simulate import image_key, simulate

    dev = resolve_device(args.device)
    df = precovers(args.data)
    pixels = load_images(args.data, list(df["name"]))
    method = args.method.upper().rstrip("R") + "R"
    for alpha in args.alphas:
        outdir = (args.data /
                  f"stego_{args.method}_alpha_{alpha}_independent_images")
        outdir.mkdir(parents=True, exist_ok=True)
        rows = []
        for i, name in enumerate(df["name"]):
            x = torch.from_numpy(pixels[i][None]).to(dev)
            stego = simulate(x, args.method, alpha,
                             image_key(name, device=dev))[0].cpu().numpy()
            base = pathlib.Path(name).name
            Image.fromarray(stego).save(outdir / base)
            rows.append({"name": f"{outdir.name}/{base}",
                         "height": stego.shape[0], "width": stego.shape[1],
                         "stego_method": method, "alpha": alpha})
        pd.DataFrame(rows).to_csv(outdir / "files.csv", index=False)
        print(f"wrote {len(rows)} stego images to {outdir}")


if __name__ == "__main__":
    sys.exit(main())
