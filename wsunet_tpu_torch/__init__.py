"""wsunet_tpu_torch — the PyTorch / NVIDIA H100 port of ``wsunet_tpu``.

A second package beside the JAX one, ported slice by slice; the JAX
package stays the reference and every module here is tested against its
counterpart there (``tests/test_torch_*.py``).  The slices so far cover:

- U-Net WS serving: uint8 [B, H, W] -> /255 -> ``unet_2`` -> crop 1 px ->
  x255 -> unweighted, unclipped WS, giving (beta_hat, l1) per image
  (``ws.unet_eval``, ``serve``).  ``fast_conv=True`` runs every 3x3
  reflect conv through the hand-written CUDA kernel
  ``ops.fused_reflect_conv`` (the port of the Pallas kernel
  ``experiments/pallas_reflect_conv.py``), built with nvcc at first use;
- the U-Net's saliency gradient (``analyses.saliency``), through that
  kernel's forward when ``fast_conv=True``;
- the filter WS attack (``ws-eval`` with KB/AVG/AVG9 and the ``-w``
  weighting), which on CUDA runs the hand-written Triton kernel
  ``ops.fused_ws`` (the port of the Pallas kernel ``ops/pallas_ws.py``).

Importing the package needs only torch and numpy: no JAX, no triton, no
pandas/PIL.  Entry points run on CUDA unless the caller passes
``device="cpu"``, and raise when CUDA is missing (``_device``).
"""

__version__ = "0.1.0"
