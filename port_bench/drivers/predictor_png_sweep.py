"""Driver of a cover-predictor sweep from PNG files on weights drawn from
the seed (traffic kind ``predictor_png_sweep``): the configuration's
network in the U-Net's place on the ``unet-eval`` path.

The inputs, the frames, the window and the gap check are ``png_sweep``'s
(imported, not copied): ``distinct_covers`` covers of ``side``^2 and their
LSBr stego at each of ``alphas`` written once as PNG files, frames of
``frame_images`` catalog paths swept by ``ws.unet_eval.predict_sweep`` at
``batch_size`` with ``threads`` decode threads, the caches cleared before
every frame so that every image of the window is decoded from its file.

Set-up draws the weights itself, from a stream of the seed, with numpy
and no code of the program (``draw_state``): no trained run of the
network is in the repository.  The names and shapes are the published
state dict's at the configuration's widths (``reference.restormer.
shapes``); each conv weight is uniform in +-1/sqrt(fan_in), the bound of
the published modules' own initialisers, and each norm weight and
attention temperature uniform in [0.5, 2], away from their initial 1, so
that the check sees a program that drops, inverts or misapplies them.
The program's ``models.get_model`` builds the network and loads them
(strictly: its names and shapes must be the published ones); their count
must be the configuration's.

The check: every (beta_hat, l1) the window produced against the plain
reference's of the same pixels on the same weights
(``reference.restormer``, in blocks of ``REF_BLOCK`` images).
``CONTROLS`` puts the reference in the program's place: ``control`` in
TF32, the precision below the configuration's float32, and ``gelu_tanh``
with the tanh form of GELU, a part of the mathematics changed by less
than the model's own scale; each must read not correct
(``control.py``).
"""

import math

import numpy as np
import torch

from port_bench.drivers import png_sweep
from port_bench.harness import images, weights
from port_bench.harness.cells import counting_reader
from port_bench.reference import restormer as ref_restormer

# the reference's images a block at 512^2: about 1.5 GB of activations an
# image in float32
REF_BLOCK = 8
# the range of the norms' weights and the temperatures
SCALES = (0.5, 2.0)


def draw_state(config: dict, seed: int) -> dict:
    """The state dict of the configuration's network, float32 CPU tensors,
    drawn from the seed's weight stream (module docstring)."""
    g = images.rng(seed, 11)
    sd = {}
    for name, shape in ref_restormer.shapes(config).items():
        if len(shape) == 4:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            arr = g.uniform(-bound, bound, shape)
        else:
            arr = g.uniform(*SCALES, shape)
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return sd


def seeded_state(ctx) -> tuple:
    """(model on the CPU, its state dict): the program's network holding
    the weights ``draw_state`` gives."""
    from wsunet_tpu_torch.models import get_model

    model = get_model(ctx.config["network"], in_channels=1, out_channels=1,
                      compute_dtype=getattr(torch, ctx.config["dtype"]))
    sd = draw_state(ctx.config, ctx.seed)
    if weights.n_parameters(sd) != ctx.config["parameters"]:
        raise RuntimeError(f"{ctx.config['network']} has "
                           f"{weights.n_parameters(sd)} parameters, the "
                           f"configuration {ctx.config['parameters']}")
    model.load_state_dict(sd)
    return model, sd


def reference_answers(sd: dict, inputs: dict, device, approximate="none",
                      tf32: bool = False) -> dict:
    """{kind: (beta_hat, l1)} of the distinct images, by the reference."""
    dev_sd = {k: v.to(device) for k, v in sd.items()}
    return {k: ref_restormer.ws_predict(dev_sd, inputs["pixels"][k], device,
                                        REF_BLOCK, approximate, tf32)
            for k in inputs["kinds"]}


class Cell(png_sweep.Cell):
    def setup(self):
        from wsunet_tpu_torch.data import pipeline
        from wsunet_tpu_torch.io.imread import imread_gray_u8

        ctx, t = self.ctx, self.ctx.traffic
        model, self.sd = seeded_state(ctx)
        self.inputs = png_sweep.make_inputs(ctx.seed, t, ctx.data)
        self.model = png_sweep._Spanned(model.to(ctx.device).eval(),
                                        ctx.spans)
        self.stats = {}
        self.reader = counting_reader(imread_gray_u8, self.stats)
        self.pipeline = pipeline
        # every shape the window runs: full batches of one frame
        self._sweep(self.inputs["names"]["cover"][:t["warmup_images"]])
        self.stats.update(decodes=0, decode_s=0.0)

    def check(self) -> dict:
        ref = reference_answers(self.sd, self.inputs, self.ctx.device)
        return png_sweep.gaps(self.answers, ref, self.inputs["order"])


class _Reference(Cell):
    """The reference in the program's place: each frame's answers are its
    distinct images' by the reference (with ``APPROXIMATE`` and ``TF32``),
    handed out in the frame's order."""

    APPROXIMATE, TF32 = "none", False

    def setup(self):
        ctx = self.ctx
        _, self.sd = seeded_state(ctx)
        self.inputs = png_sweep.make_inputs(ctx.seed, ctx.traffic, ctx.data)
        self.dev_sd = {k: v.to(ctx.device) for k, v in self.sd.items()}
        self.stats = {"decodes": 0, "decode_s": 0.0}

    def _frame(self, kind: str) -> tuple:
        order = self.inputs["order"][kind]
        beta, l1 = ref_restormer.ws_predict(
            self.dev_sd, self.inputs["pixels"][kind], self.ctx.device,
            REF_BLOCK, self.APPROXIMATE, self.TF32)
        return beta[order], l1[order]

    def release(self):
        del self.dev_sd


class Control(_Reference):
    TF32 = True


class GeluTanh(_Reference):
    APPROXIMATE = "tanh"


CONTROLS = {"control": Control, "gelu_tanh": GeluTanh}
