"""Stego embedding simulators, LSBr and HILLr (port of
``wsunet_tpu/data/simulate.py``).

- both use LSB-*replacement* direction (x ^ 1 on changed pixels) and
  change rate beta = alpha / 2;
- LSBr overwrites each pixel with a random bit with probability alpha:
  ``lsbr_embed`` is the pure core, given the embedding mask and the bits;
  ``lsbr_simulate`` draws both from an explicit ``torch.Generator`` on the
  tensor's device.  The draws are torch's, not ``jax.random``'s, so a
  stego image differs from the JAX package's pixel by pixel; its change
  rate and direction do not;
- HILLr is deterministic: exactly round(alpha/2 * N) pixels with the
  lowest HILL cost flip, ties at the threshold cost broken in row-major
  order, as in JAX.

All take uint8 [B, H, W] on any device and return uint8 on it.
"""

import torch

from ..ops.hill import hill_cost
from ..utils.seeding import filename_to_image_seed


def lsbr_embed(x_u8: torch.Tensor, embed: torch.Tensor,
               bits: torch.Tensor) -> torch.Tensor:
    """Replace the LSB of x by ``bits`` where ``embed`` is True (both
    [B, H, W]; ``bits`` bool or 0/1 integers)."""
    x = x_u8.to(torch.uint8)
    replaced = torch.bitwise_or(torch.bitwise_and(x, 0xFE),
                                bits.to(torch.uint8))
    return torch.where(embed, replaced, x)


def lsbr_draws(shape, generator: torch.Generator) -> tuple:
    """(uniform [0, 1) f32, bits bool) of ``shape``, drawn from
    ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    bits = torch.rand(shape, generator=generator,
                      device=generator.device) < 0.5
    return u, bits


def lsbr_simulate(x_u8: torch.Tensor, alpha,
                  generator: torch.Generator) -> torch.Tensor:
    """LSBr embedding on a uint8 batch [B, H, W]; ``alpha`` is a scalar or
    a per-image [B] rate.  ``generator`` lives on x's device."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x_u8.device)
    if alpha.ndim == 0:
        alpha = alpha.expand(x_u8.shape[0])
    u, bits = lsbr_draws(x_u8.shape, generator)
    return lsbr_embed(x_u8, u < alpha[:, None, None], bits)


def hillr_flips(rho: torch.Tensor, n_changes: int) -> torch.Tensor:
    """The pixels HILLr flips, bool [B, H, W], from the cost map ``rho``:
    every pixel cheaper than the ``n_changes``-th smallest cost, and the
    pixels tied at that cost in row-major order until exactly
    ``n_changes`` flip (cutting the cumulative sum over the whole selected
    set instead would let an early tied pixel evict a later cheaper one)."""
    B, H, W = rho.shape
    if n_changes <= 0:
        return torch.zeros_like(rho, dtype=torch.bool)
    flat = rho.reshape(B, -1)
    thresh = torch.kthvalue(flat, n_changes, dim=1).values[:, None]
    below = flat < thresh
    tied = flat == thresh
    remaining = n_changes - torch.sum(below, dim=1, keepdim=True)
    tie_order = torch.cumsum(tied, dim=1)
    return (below | (tied & (tie_order <= remaining))).reshape(B, H, W)


def hillr_simulate(x_u8: torch.Tensor, alpha: float) -> torch.Tensor:
    """HILLr embedding on a uint8 batch [B, H, W]: flip the LSB of the
    round(alpha/2 * N) lowest-HILL-cost pixels (wet cost 1e10).  With no
    change to make (alpha/2 * N rounds to 0) the batch comes back
    unchanged."""
    B, H, W = x_u8.shape
    n_changes = int(round(alpha / 2.0 * H * W))
    rho = hill_cost(x_u8.to(torch.float32), wet_cost=1e10)
    x = x_u8.to(torch.uint8)
    return torch.where(hillr_flips(rho, n_changes), torch.bitwise_xor(x, 1),
                       x)


def simulate(x_u8, stego_method: str, alpha,
             generator: torch.Generator = None) -> torch.Tensor:
    """Dispatch by stego method name (LSBR / HILLR, case-insensitive)."""
    method = stego_method.upper().rstrip("R") + "R"
    if method == "LSBR":
        if generator is None:
            raise ValueError("LSBr simulation requires a generator")
        return lsbr_simulate(x_u8, alpha, generator)
    if method == "HILLR":
        return hillr_simulate(x_u8, float(alpha))
    raise NotImplementedError(stego_method)


def image_key(filename: str, salt: int = 0, device=None) -> torch.Generator:
    """Deterministic per-image generator on ``device`` (default: the CPU),
    seeded with the filename stem's seed plus ``salt`` (the JAX package's
    ``PRNGKey(filename_to_image_seed(filename) + salt)``)."""
    return torch.Generator(device=device or "cpu").manual_seed(
        filename_to_image_seed(filename) + salt)
