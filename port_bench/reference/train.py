"""Plain PyTorch reference of ws-unet's U-Net training step (the LSBR
recipe), float32.

One step on a batch of uint8 covers [B, H, W] and the step's draws:

- each image flipped left-right where ``flip_h``, then up-down where
  ``flip_v``, then turned by ``k`` quarter turns (``torch.rot90`` over the
  last two axes);
- stego where ``is_stego``: LSB replacement at ``alpha`` given its
  embedding mask ``embed`` and bits ``bits`` (the pixel's LSB replaced by
  the bit where the mask is set); covers keep alpha 0;
- the U-Net (``reference.unet``) on stego / 255, in training mode (this
  recipe has no dropout, so the same function as inference);
- the loss ``2 (lambda L1 + (1 - lambda) |beta_hat - alpha / 2|)`` per
  image, meaned over the batch: L1 the mean absolute error against the
  cover / 255, beta_hat the WS estimate of the input x (x 255) from the
  prediction y (x 255), sum((x - x^1)(x - y)) / pixels with x^1 the LSB
  of round(x) flipped and held constant, clipped below at 0.  |d| takes
  the gradient +1 at d = 0, as JAX's does (the recipe was trained there);
- AdamW (Loshchilov & Hutter; decoupled weight decay) with b1 0.9, b2
  0.999, eps 1e-8, weight decay 1e-4, and the recipe's learning rate from
  optax's warmup-cosine schedule: 0 at the first step, linear to the peak
  over the warm-up, then cosine down to a hundredth of the peak.
"""

import math

import torch

from port_bench.reference import unet as ref_unet

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def schedule(count: int, lr: float, steps_per_epoch: int,
             epochs: int) -> float:
    """The learning rate of the step after ``count`` steps (optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total, lr / 100)`` with
    the recipe's warm-up of min(total / 20, 2 epochs))."""
    total = max(1, steps_per_epoch * epochs)
    warmup = min(total // 20, 2 * steps_per_epoch)
    if count < warmup:
        return lr * count / warmup
    c = min(count - warmup, total - warmup)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / (total - warmup)))
    return lr * (0.99 * cosine + 0.01)


def _abs(d):
    return torch.where(d >= 0, d, -d)


def augment(x: torch.Tensor, d: dict) -> torch.Tensor:
    out = []
    for i in range(x.shape[0]):
        v = x[i]
        if d["flip_h"][i]:
            v = v.flip(-1)
        if d["flip_v"][i]:
            v = v.flip(-2)
        out.append(torch.rot90(v, int(d["k"][i]), dims=(-2, -1)))
    return torch.stack(out)


def loss(sd: dict, cover_u8: torch.Tensor, d: dict, alpha: float,
         lam: float) -> torch.Tensor:
    """The step's mean loss (differentiable in ``sd``'s tensors)."""
    x = augment(cover_u8, d)
    stego_img = d["is_stego"][:, None, None] & d["embed"]
    stego = torch.where(stego_img, (x & 0xFE) | d["bits"].to(torch.uint8), x)
    alphas = d["is_stego"].to(torch.float32) * alpha
    covers = x.to(torch.float32)[:, None] / 255.0
    inputs = stego.to(torch.float32)[:, None] / 255.0
    out = ref_unet.forward(sd, inputs)
    l1 = _abs(covers - out).mean(dim=(1, 2, 3))
    xi, y = inputs * 255.0, out * 255.0
    x_bar = torch.bitwise_xor(torch.round(xi).to(torch.int32), 1).to(
        torch.float32)
    n = xi[0].numel()
    beta_hat = torch.clamp(((xi - x_bar) * (xi - y)).sum(dim=(1, 2, 3)) / n,
                           min=0.0)
    ws = _abs(beta_hat - alphas / 2.0)
    return (2.0 * (lam * l1 + (1.0 - lam) * ws)).mean()


def run(sd: dict, steps: list, recipe: dict, device,
        loss_fn=None) -> dict:
    """Follow the recipe from the weights ``sd`` over ``steps``, a list of
    (cover_u8 [B, H, W], draws), on ``device``.  Returns the losses, the
    first step's gradient and the parameters' change after the last step,
    each by parameter name.  ``loss_fn`` takes ``loss``'s place (the
    check's planted faults)."""
    loss_fn = loss_fn or loss
    params = {k: v.to(device).clone().requires_grad_(True)
              for k, v in sd.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for t, (cover, draws) in enumerate(steps):
        d = {k: u.to(device) for k, u in draws.items()}
        value = loss_fn(params, cover.to(device), d, recipe["alpha"],
                        recipe["loss_lambda"])
        grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        lr = schedule(t, recipe["learning_rate"], recipe["steps_per_epoch"],
                      recipe["num_epochs"])
        with torch.no_grad():
            if t == 0:
                first_grad = {k: g.clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
                m_hat = m[k] / (1 - BETAS[0] ** (t + 1))
                v_hat = v2[k] / (1 - BETAS[1] ** (t + 1))
                p.mul_(1 - lr * WEIGHT_DECAY)
                p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
