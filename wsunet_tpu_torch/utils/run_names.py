"""Run-name encoding of hyperparameters (port of
``wsunet_tpu/utils/run_names.py``, unchanged).

Parity: reference src/_defs/defs.py:47-74 — the run-name doubles as a
queryable model registry key (the eval scripts filter experiment dirs by
the config.json stored next to checkpoints; see
wsunet_tpu_torch.utils.registry).
"""

import typing


def create_run_name(args: typing.Dict[str, typing.Any]) -> str:
    run_name = str(args["network"])
    if args.get("no_stem_stride"):
        run_name += "-nostride"
    run_name += "-"
    if args.get("alpha"):
        alpha = args["alpha"]
        if isinstance(alpha, (list, tuple)):  # rate-mixture training
            alpha = "mix" + "-".join(str(a) for a in alpha)
        run_name += f"alpha_{alpha}_"
    if args.get("grayscale"):
        run_name += "grayscale_"
    else:
        run_name += "color"
        run_name += "_" + "".join(map(str, args.get("channel", [0])))
    if args.get("demosaic"):
        run_name += "_".join(args["demosaic"]) + "_"
    if args.get("demosaic_oracle"):
        run_name += "oracle_"
    if args.get("loss"):
        run_name += args["loss"] + "_"
        if args["loss"] == "l1ws":
            run_name += f"{args.get('loss_lambda', 0.25):.02f}_"
    if args.get("learning_rate"):
        run_name += f"lr_{args['learning_rate']}_"
    if args.get("drop_rate"):
        run_name += f"dr_{args['drop_rate']}"
    return run_name
