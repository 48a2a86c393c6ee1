"""Flax parameters -> state dicts of the torch ``UNet`` and
``EfficientNetB0``, and a trained ``UNet`` back to Flax parameters.

Takes numpy only (a nested dict of arrays, as ``jax.tree.map(np.asarray,
params)`` gives it), so it runs where JAX is not installed.

U-Net (``unet_state_dict_from_flax``):

- 3x3 and 1x1 conv kernels: Flax HWIO -> torch OIHW.
- The transposed convs (Flax ``nn.ConvTranspose``, kernel (2, 2, in, out),
  no kernel transpose) -> torch ``ConvTranspose2d`` weight (in, out, 2, 2)
  with both spatial axes flipped: ``lax.conv_transpose`` correlates the
  stride-dilated input with the kernel, while torch's transposed conv is
  the gradient of a convolution, so output pixel (2i+a, 2j+b) takes Flax
  tap (1-a, 1-b).  ``tests/test_torch_unet.py`` fixes this against JAX on
  random weights.

``flax_params_from_unet_state_dict`` is the inverse of
``unet_state_dict_from_flax``: OIHW back to HWIO and the transposed convs'
taps flipped back, so a run the port trained is written in the layout of
``best.npz`` (``train.checkpoint``) that ``load_params`` and
``ws.unet_eval.load_pretrained_unet`` read, and the JAX package's Flax
model takes.

B0 (``b0_state_dict_from_flax``): see its docstring;
``flax_b0_params_from_state_dict`` is its inverse, giving the params and
``batch_stats`` trees that a B0 run's ``best.npz`` holds.
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


def _hwio(weight) -> np.ndarray:
    return np.ascontiguousarray(_np(weight).transpose(2, 3, 1, 0))


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def flax_params_from_unet_state_dict(state_dict: dict) -> dict:
    """Map a ``models.unet.UNet`` ``state_dict`` to the Flax ``UNet``
    params tree (nested dicts of f32 numpy arrays), the inverse of
    ``unet_state_dict_from_flax``."""
    params = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if path == ["e1_conv1"]:
            params[f"e1_conv1_{'kernel' if leaf == 'weight' else 'bias'}"] = \
                _hwio(value) if leaf == "weight" else _np(value)
            continue
        node = params
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "bias":
            node["bias"] = _np(value)
        elif path[0].startswith("up"):
            node["kernel"] = np.ascontiguousarray(
                _np(value).transpose(2, 3, 0, 1)[::-1, ::-1])
        else:
            node["kernel"] = _hwio(value)
    return params


def b0_state_dict_from_flax(params: dict, batch_stats: dict = None) -> dict:
    """Map the Flax ``EfficientNetB0`` variables (``params`` and, with
    batch norm, ``batch_stats``) to a ``state_dict`` for
    ``models.b0.EfficientNetB0``.  Module paths keep their names ('.'
    joined); the leaves map as

    - conv ``kernel`` HWIO -> ``weight`` OIHW (the depthwise [k, k, 1, mid]
      becomes [mid, 1, k, k]); the Dense ``kernel`` [in, out] -> the
      Linear ``weight`` [out, in];
    - norm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
    - ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
      ``running_var`` (plus ``num_batches_tracked``, which torch keeps).
    """
    sd = {}

    def walk(tree, path, stats):
        for name, value in tree.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(dict(value), path + [name], stats)
                continue
            arr = np.asarray(value, np.float32)
            if stats:
                leaf = {"mean": "running_mean", "var": "running_var"}[name]
                sd[".".join(path + ["num_batches_tracked"])] = \
                    torch.tensor(0)
                sd[".".join(path + [leaf])] = _vec(arr)
            elif name == "kernel":
                sd[".".join(path + ["weight"])] = _oihw(arr) \
                    if arr.ndim == 4 else torch.from_numpy(np.array(arr.T))
            else:
                sd[".".join(path + [{"scale": "weight",
                                     "bias": "bias"}[name]])] = _vec(arr)

    walk(params, [], False)
    walk(batch_stats or {}, [], True)
    return sd


def flax_b0_params_from_state_dict(state_dict: dict) -> tuple:
    """Map a ``models.b0.EfficientNetB0`` ``state_dict`` to the Flax
    ``EfficientNetB0`` variables, (params, batch_stats), nested dicts of
    f32 numpy arrays: the inverse of ``b0_state_dict_from_flax``.  A 4-D
    ``weight`` is a conv kernel (OIHW -> HWIO), a 2-D one the classifier's
    (transposed), a 1-D one a norm scale; ``running_mean`` /
    ``running_var`` go to ``batch_stats`` as ``mean`` / ``var``, and
    ``num_batches_tracked`` is dropped.  ``batch_stats`` is empty for a
    group-norm model."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        tree = params
        if leaf in ("running_mean", "running_var"):
            tree, name, arr = stats, leaf[len("running_"):], _np(value)
        elif leaf == "bias":
            name, arr = "bias", _np(value)
        elif value.ndim == 4:
            name, arr = "kernel", _hwio(value)
        elif value.ndim == 2:
            name, arr = "kernel", np.ascontiguousarray(_np(value).T)
        else:
            name, arr = "scale", _np(value)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = arr
    return params, stats
