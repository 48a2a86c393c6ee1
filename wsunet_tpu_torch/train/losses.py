"""Training losses as pure functions (port of
``wsunet_tpu/train/losses.py``).

- l1 / l2 against the cover
- ws: the in-graph WS estimate, |beta_hat - beta| with beta = alpha / 2
- l1ws: the unweighted sum of the two, or with ``loss_lambda`` the
  weighted ``2 * (lambda * L1 + (1 - lambda) * WS)`` of the committed runs

All take NCHW tensors in [0, 1]: ``outputs`` the model prediction,
``covers`` the cover target, ``inputs`` the (possibly stego) model input,
``alphas`` the per-image embedding rate [B].  The per-image means run over
every non-batch axis, so the layout does not change them.  ``|d|`` has
JAX's gradient at 0 (+1; ``torch.abs`` gives 0 there), which a prediction
equal to its cover (a saturated 255) meets.
"""

import torch

from ..ops.ws import ws_estimate_inloss


def _image_axes(x):
    return tuple(range(1, x.ndim))


def _abs(d):
    """|d| with the gradient of ``jnp.abs``: +1 at d == 0."""
    return torch.where(d >= 0, d, -d)


def l1_loss_per_image(outputs, covers, *_, **__):
    return torch.mean(_abs(covers - outputs), dim=_image_axes(outputs))


def l2_loss_per_image(outputs, covers, *_, **__):
    return torch.mean((covers - outputs) ** 2, dim=_image_axes(outputs))


def ws_loss_per_image(outputs, covers, inputs, alphas):
    betas = alphas / 2.0
    betas_hat = ws_estimate_inloss(inputs, outputs)
    return _abs(betas_hat - betas)


def l1ws_loss_per_image(outputs, covers, inputs, alphas):
    return (l1_loss_per_image(outputs, covers)
            + ws_loss_per_image(outputs, covers, inputs, alphas))


def make_l1ws_weighted_per_image(loss_lambda: float):
    """The weighted composite ``2 * (lambda * L1 + (1 - lambda) * WS)``
    that the committed U-Net runs were trained with (``l1ws_0.25`` in
    their names; lambda 0.25 weights WS three times over L1)."""

    def loss(outputs, covers, inputs, alphas):
        return 2.0 * (
            loss_lambda * l1_loss_per_image(outputs, covers)
            + (1.0 - loss_lambda)
            * ws_loss_per_image(outputs, covers, inputs, alphas))

    return loss


_PER_IMAGE = {
    "l1": l1_loss_per_image,
    "l2": l2_loss_per_image,
    "ws": ws_loss_per_image,
    "l1ws": l1ws_loss_per_image,
}


def _scalarize(fn):
    def loss(outputs, covers, inputs=None, alphas=None):
        return torch.mean(fn(outputs, covers, inputs, alphas))
    return loss


def l1_loss(outputs, covers, *_, **__):
    return torch.mean(_abs(covers - outputs))


def l2_loss(outputs, covers, *_, **__):
    return torch.mean((covers - outputs) ** 2)


def ws_loss(outputs, covers, inputs, alphas):
    return torch.mean(ws_loss_per_image(outputs, covers, inputs, alphas))


def l1ws_loss(outputs, covers, inputs, alphas):
    return l1_loss(outputs, covers) + ws_loss(outputs, covers, inputs, alphas)


_LOSSES = {
    "l1": l1_loss,
    "l2": l2_loss,
    "ws": ws_loss,
    "l1ws": l1ws_loss,
}


def get_loss(name: str, per_image: bool = False,
             loss_lambda: float = None):
    """Loss by name; ``per_image=True`` returns the unreduced [B] variant
    (the trainer masks padded rows out of the mean).  ``loss_lambda``
    (``l1ws`` only) selects the weighted composite; ``None`` keeps the
    unweighted sum."""
    if name == "l1ws" and loss_lambda is not None:
        fn = make_l1ws_weighted_per_image(float(loss_lambda))
        return fn if per_image else _scalarize(fn)
    table = _PER_IMAGE if per_image else _LOSSES
    try:
        return table[name]
    except KeyError:
        raise NotImplementedError(f"loss {name!r} not implemented") from None
