"""Driver of the U-Net sweeps from PNG files (traffic kind ``png_sweep``).

Inputs, from the seed: ``distinct_covers`` grayscale covers of
``side``^2 and their LSB-replacement stego at each of ``alphas``, written
once as PNG files; each frame (the covers, then each rate's stego, as
``unet-eval`` sweeps a catalog frame by frame) is ``frame_images`` catalog
paths, hard links to those files in an order drawn from the seed.

The window calls ``ws.unet_eval.predict_sweep`` once a frame, at
``batch_size`` with ``threads`` decode threads, on the route
``fast_conv`` names, frame after frame until ``--seconds`` have passed.
The pipeline's caches are cleared before every call, as a fresh catalog
finds them, so every image of the window is decoded from its file's
bytes: the decodes counted equal the images completed.

The check: every (beta_hat, l1) the window produced against the plain
reference's of the same pixels (``reference.unet``).  ``CONTROLS`` names
the cell with the reference in TF32 in the program's place, the check's
control (``control.py``).
"""

import concurrent.futures
import time

import numpy as np
import torch

from port_bench.harness import images, weights
from port_bench.harness.cells import counting_reader
from port_bench.reference import precision
from port_bench.reference import unet as ref_unet


class _Spanned(torch.nn.Module):
    """The model with each forward in a ``predict`` span."""

    def __init__(self, model, spans):
        super().__init__()
        self.inner = model
        self.spans = spans

    def forward(self, x):
        with self.spans("predict"):
            return self.inner(x)


def make_inputs(seed: int, t: dict, data) -> dict:
    """{kind: uint8 [distinct, side, side]} for the covers and each rate,
    written under ``data/files/<kind>/``, and the frames' link order
    ``order[kind]`` (the distinct image behind each path)."""
    n, side = t["distinct_covers"], t["side"]
    kinds = ["cover"] + [f"lsbr_{a}" for a in t["alphas"]]

    def one(i):
        c = images.cover(seed, i, side)
        return [c] + [images.lsbr(c, a, seed, i) for a in t["alphas"]]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        per_image = list(pool.map(one, range(n)))
    pixels = {k: np.stack([p[j] for p in per_image])
              for j, k in enumerate(kinds)}
    images.write_pngs(data, {f"files/{k}/{i:04d}.png": pixels[k][i]
                             for k in kinds for i in range(n)})
    g = images.rng(seed, 3)
    order, names = {}, {}
    for k in kinds:
        order[k] = g.permutation(np.arange(t["frame_images"]) % n)
        names[k] = [f"{k}/{j:05d}.png" for j in range(t["frame_images"])]
        for name, i in zip(names[k], order[k]):
            images.link(data, name, f"files/{k}/{i:04d}.png")
    return {"kinds": kinds, "pixels": pixels, "order": order,
            "names": names}


def reference_answers(sd: dict, inputs: dict, device) -> dict:
    """{kind: (beta_hat, l1)} of the distinct images, by the reference."""
    dev_sd = {k: v.to(device) for k, v in sd.items()}
    with precision(False):
        return {k: ref_unet.ws_predict(dev_sd, inputs["pixels"][k], device)
                for k in inputs["kinds"]}


def gaps(answers: list, ref: dict, order: dict) -> dict:
    """The widest gaps, over every answer, between (beta_hat, l1) given
    and the reference's; a missing or NaN answer reads infinite."""
    beta_gap = l1_gap = 0.0
    for kind, beta, l1 in answers:
        rb, rl = (r[order[kind]] for r in ref[kind])
        if len(beta) != len(rb) or len(l1) != len(rl):
            return {"beta_gap": float("inf"), "l1_gap": float("inf")}
        db = np.abs(beta.astype(np.float64) - rb)
        dl = np.abs(l1.astype(np.float64) - rl)
        if not (np.all(np.isfinite(db)) and np.all(np.isfinite(dl))):
            return {"beta_gap": float("inf"), "l1_gap": float("inf")}
        beta_gap = max(beta_gap, float(db.max()))
        l1_gap = max(l1_gap, float(dl.max()))
    return {"beta_gap": beta_gap, "l1_gap": l1_gap}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        from wsunet_tpu_torch.data import pipeline
        from wsunet_tpu_torch.io.imread import imread_gray_u8
        from wsunet_tpu_torch.models import get_model

        ctx, t = self.ctx, self.ctx.traffic
        self.inputs = make_inputs(ctx.seed, t, ctx.data)
        self.sd = weights.state_dict(ctx.root / ctx.config["weights"])
        model = get_model(ctx.config["network"], in_channels=1,
                          out_channels=1,
                          compute_dtype=getattr(torch, ctx.config["dtype"]),
                          fast_conv=t["fast_conv"])
        model.load_state_dict(self.sd)
        self.model = _Spanned(model.to(ctx.device).eval(), ctx.spans)
        self.stats = {}
        self.reader = counting_reader(imread_gray_u8, self.stats)
        self.pipeline = pipeline
        # every shape the window runs: full batches of one frame
        self._sweep(self.inputs["names"]["cover"][:t["warmup_images"]])
        self.stats.update(decodes=0, decode_s=0.0)

    def _sweep(self, names):
        from wsunet_tpu_torch.ws import unet_eval

        t = self.ctx.traffic
        self.pipeline.clear_decode_cache()
        with self.ctx.spans("sweep"):
            return unet_eval.predict_sweep(
                self.ctx.data, names, self.model, t["batch_size"],
                threads=t["threads"], device=self.ctx.device,
                reader=self.reader)

    def _frame(self, kind: str) -> tuple:
        return self._sweep(self.inputs["names"][kind])

    def window(self, seconds: float):
        kinds = self.inputs["kinds"]
        self.answers = []
        t0 = time.perf_counter()
        with self.ctx.spans("window"):
            while time.perf_counter() - t0 < seconds:
                kind = kinds[len(self.answers) % len(kinds)]
                self.answers.append((kind, *self._frame(kind)))
        window_s = time.perf_counter() - t0
        n = sum(len(b) for _, b, _ in self.answers)
        failed = sum(int(np.sum(~np.isfinite(b) | ~np.isfinite(l)))
                     for _, b, l in self.answers)
        self.ctx.counts.update(
            window_s=window_s, images=n, attempted=n, failed=failed,
            frames=len(self.answers), batches=len(self.answers) * -(
                -self.ctx.traffic["frame_images"]
                // self.ctx.traffic["batch_size"]),
            decodes=self.stats["decodes"], decode_s=self.stats["decode_s"])

    def evidence(self) -> list:
        c = self.ctx.counts
        return [f"window: {c['frames']} frames, {c['images']} images "
                f"completed, {c['decodes']} decoded from their files"]

    def release(self):
        self.pipeline.clear_decode_cache()
        del self.model

    def check(self) -> dict:
        ref = reference_answers(self.sd, self.inputs, self.ctx.device)
        return gaps(self.answers, ref, self.inputs["order"])


class Control(Cell):
    """The cell with the plain reference in TF32, the precision below the
    configuration's float32, in the program's place: each frame's answers
    are the reference's of its distinct images, handed out in the frame's
    order."""

    def setup(self):
        ctx = self.ctx
        self.inputs = make_inputs(ctx.seed, ctx.traffic, ctx.data)
        self.sd = weights.state_dict(ctx.root / ctx.config["weights"])
        self.dev_sd = {k: v.to(ctx.device) for k, v in self.sd.items()}
        self.stats = {"decodes": 0, "decode_s": 0.0}

    def _frame(self, kind: str) -> tuple:
        order = self.inputs["order"][kind]
        with precision(True):
            beta, l1 = ref_unet.ws_predict(
                self.dev_sd, self.inputs["pixels"][kind], self.ctx.device)
        return beta[order], l1[order]

    def release(self):
        del self.dev_sd


CONTROLS = {"control": Control}
