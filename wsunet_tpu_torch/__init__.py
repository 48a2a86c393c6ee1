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
- the analyses (``analyses``: the saliency gradient, through that
  kernel's forward when ``fast_conv=True``, the residual/change
  correlation, the error boxes, the difference images) with their
  subcommands, ``init-dataset``, ``serve``, and the profiling and NaN
  hooks of every command (``utils.profiling``);
- the filter WS attack (``ws-eval`` with KB/AVG/AVG9 and the ``-w``
  weighting), which on CUDA runs the hand-written CUDA kernel
  ``ops.fused_ws`` (the port of the Pallas kernel ``ops/pallas_ws.py``),
  built with nvcc at first use with the other kernels' sources;
- the detection path over a catalog with trained weights: ``ws-eval``,
  ``unet-eval`` and ``roc`` (``python -m wsunet_tpu_torch``, ``cli``),
  with the catalog and batched pipeline (``data``), the readers and the
  native PNG decoder (``io``), trained runs exported from the JAX
  checkpoints (``train.checkpoint``, ``utils.registry``,
  ``ws.unet_eval.load_pretrained_unet``), the ``-sca`` score
  (``ops.hill``, ``ops.ws.ws_attack_sca``) and the ROC tables
  (``detect``, numpy only);
- the B0 detector (``models.b0``, ``detect.b0_eval``, ``detector-eval``
  and ``roc --b0``), OLS and colour planes (``ops.ols``), the bootstrap
  intervals and the cross-fold holdout tables (``detect.ci``,
  ``detect.holdout``);
- the U-Net trainer (``train.train_unet``, ``train-unet``) with the LSBr
  / HILLr simulators (``data.simulate``, ``simulate``);
- the B0 trainer (``train.train_b0``, ``train-b0``: Flax's initialisers
  and the high-pass stem, frozen or live batch statistics with Flax's
  running update, head dropout on a given mask) and its batch-norm
  recalibration (``train.bn_recalibrate``);
- the filter prediction-error table (``ws.filters_eval``,
  ``filters-eval``: MAE and HILL-decile wMAE per cover).

Importing the package needs only torch and numpy: no JAX, no triton, no
pandas/PIL/matplotlib; running any command needs none of them either
(the CSVs are ``utils.table`` tables and the PNGs ``io.png``'s; figures
are drawn where matplotlib imports, ``utils.figures``); the kernels need
nvcc on the card's machine (``csrc/``).
Entry points run on CUDA unless the caller passes ``device="cpu"``, and
raise when CUDA is missing (``_device``).
"""

__version__ = "0.1.0"
