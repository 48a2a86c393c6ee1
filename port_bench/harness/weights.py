"""The benchmark's loader of the committed trained runs.

A run's ``best.npz`` holds the Flax variables flattened by ``/`` (B0's
batch-norm running statistics under ``batch_stats/``).  ``state_dict``
maps them to float32 torch tensors under the module names that both the
program's models and the plain references use, in PyTorch's layouts:

- a conv kernel HWIO -> OIHW (a depthwise [k, k, 1, C] -> [C, 1, k, k]);
- a dense kernel [in, out] -> [out, in];
- a U-Net transposed-conv kernel (2, 2, in, out) -> (in, out, 2, 2) with
  both spatial axes flipped: ``lax.conv_transpose`` correlates the
  stride-dilated input with the kernel, PyTorch's transposed conv is the
  gradient of a correlation, so output pixel (2i+a, 2j+b) takes Flax tap
  (1-a, 1-b);
- a norm ``scale`` / ``bias`` -> ``weight`` / ``bias``; ``batch_stats``
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, with
  ``num_batches_tracked`` 0.

The same tensors go to the program and to the reference.
"""

import pathlib

import numpy as np
import torch

STATS = "batch_stats/"


def state_dict(run_dir: pathlib.Path) -> dict:
    """The run's weights as a state dict of f32 CPU tensors."""
    sd = {}
    with np.load(pathlib.Path(run_dir) / "best.npz",
                 allow_pickle=False) as npz:
        for key in npz.files:
            arr = np.asarray(npz[key], np.float32)
            stats = key.startswith(STATS)
            path = key[len(STATS):] if stats else key
            if "/" not in path:                      # e1_conv1_kernel
                mod, leaf = path.rsplit("_", 1)
            else:
                mod, leaf = path.rsplit("/", 1)
                mod = mod.replace("/", ".")
            if stats:
                name = {"mean": "running_mean", "var": "running_var"}[leaf]
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
            elif leaf == "kernel" and arr.ndim == 4 and mod.startswith("up"):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                name = "weight"
            elif leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
                name = "weight"
            elif leaf == "kernel":
                arr = arr.T
                name = "weight"
            else:
                name = {"scale": "weight", "bias": "bias"}[leaf]
            sd[f"{mod}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def n_parameters(sd: dict) -> int:
    """Trained parameters (running statistics not counted)."""
    return sum(v.numel() for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var",
                                  "num_batches_tracked")))
