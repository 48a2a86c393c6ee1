"""Flax U-Net parameters -> a state dict of the torch ``UNet``.

Takes numpy only (a nested dict of arrays, as ``jax.tree.map(np.asarray,
params)`` gives it), so it runs where JAX is not installed.

- 3x3 and 1x1 conv kernels: Flax HWIO -> torch OIHW.
- The transposed convs (Flax ``nn.ConvTranspose``, kernel (2, 2, in, out),
  no kernel transpose) -> torch ``ConvTranspose2d`` weight (in, out, 2, 2)
  with both spatial axes flipped: ``lax.conv_transpose`` correlates the
  stride-dilated input with the kernel, while torch's transposed conv is
  the gradient of a convolution, so output pixel (2i+a, 2j+b) takes Flax
  tap (1-a, 1-b).  ``tests/test_torch_unet.py`` fixes this against JAX on
  random weights.
"""

import numpy as np
import torch


def _oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.array(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _vec(bias) -> torch.Tensor:
    return torch.from_numpy(np.array(bias, np.float32))


def unet_state_dict_from_flax(params: dict) -> dict:
    """Map the Flax ``UNet`` params tree (``variables["params"]``) to a
    ``state_dict`` for ``models.unet.UNet`` of the same depth."""
    sd = {"e1_conv1.weight": _oihw(params["e1_conv1_kernel"]),
          "e1_conv1.bias": _vec(params["e1_conv1_bias"])}
    for name, sub in params.items():
        if name in ("e1_conv1_kernel", "e1_conv1_bias"):
            continue
        if name.startswith("up"):
            k = np.asarray(sub["kernel"], np.float32)[::-1, ::-1]
            sd[f"{name}.weight"] = torch.from_numpy(
                np.array(k.transpose(2, 3, 0, 1)))
            sd[f"{name}.bias"] = _vec(sub["bias"])
        elif "kernel" in sub:  # e1_conv2, outconv
            sd[f"{name}.weight"] = _oihw(sub["kernel"])
            sd[f"{name}.bias"] = _vec(sub["bias"])
        else:  # e<k> / d<k> blocks: conv1, conv2
            for conv, p in sub.items():
                sd[f"{name}.{conv}.weight"] = _oihw(p["kernel"])
                sd[f"{name}.{conv}.bias"] = _vec(p["bias"])
    return sd
