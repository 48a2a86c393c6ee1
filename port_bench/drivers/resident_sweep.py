"""Driver of the B0 detector's sweep over frames already on the card
(traffic kind ``resident_sweep``).

Inputs, from the seed: ``distinct_covers`` grayscale covers of
``side``^2 and their LSB-replacement stego at each of ``alphas``, written
once as PNG files, and ``covers`` catalog paths of each kind (hard links
to those files in an order drawn from the seed): the covers, then each
rate's stego.

Set-up sweeps every path once with ``detect.b0_eval.score_sweep`` at
``batch_size``, which decodes them and keeps each batch in the pipeline's
device cache, as a session's first B0 over a fold leaves it for the next
(the device cache must hold them all: 32 x 512^2 bytes a batch, 256 MiB
in all).  The window repeats that sweep until ``--seconds`` have passed:
every batch is a device-cache hit, so no decode, upload or pass fill
from files is in it; the cell counts the hits (a batch handed to the
detector that is a tensor of the cache) and the decodes.

The check: every P(stego) the window produced against the plain
reference's of the same pixels (``reference.b0``).  ``CONTROLS`` names
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
from port_bench.reference import b0 as ref_b0


# the least P, and the least 1 - P, whose log is compared: near 0 a
# float32 P keeps 7 digits down to its smallest normal value, 1.2e-38 (the
# program flushes below it); near 1 it keeps about 7 digits of P, so 1 - P
# at 1e-3 keeps 4
LOW_FLOOR, HIGH_FLOOR = 1e-36, 1e-3


def make_inputs(seed: int, t: dict, data) -> dict:
    """The distinct images (``pixels`` [kinds x distinct, side, side]), the
    sweep's paths (``names``) and the distinct image behind each
    (``order``)."""
    n, side = t["distinct_covers"], t["side"]
    kinds = ["cover"] + [f"lsbr_{a}" for a in t["alphas"]]

    def one(i):
        c = images.cover(seed, i, side)
        return [c] + [images.lsbr(c, a, seed, i) for a in t["alphas"]]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        per_image = list(pool.map(one, range(n)))
    pixels = np.stack([p[j] for j in range(len(kinds)) for p in per_image])
    images.write_pngs(data, {f"files/{k}/{i:04d}.png": pixels[j * n + i]
                             for j, k in enumerate(kinds) for i in range(n)})
    g = images.rng(seed, 4)
    names, order = [], []
    for j, k in enumerate(kinds):
        idx = g.permutation(np.arange(t["covers"]) % n)
        for m, i in enumerate(idx):
            names.append(f"{k}/{m:05d}.png")
            order.append(j * n + i)
            images.link(data, names[-1], f"files/{k}/{i:04d}.png")
    return {"pixels": pixels, "names": names, "order": np.array(order)}


def reference_answers(sd: dict, inputs: dict, device, cfg: dict,
                      tf32: bool = False) -> np.ndarray:
    """P(stego) of the distinct images, by the reference (in TF32 for the
    control)."""
    dev_sd = {k: v.to(device) for k, v in sd.items()}
    with precision(tf32):
        return ref_b0.p_stego(dev_sd, inputs["pixels"], device, cfg)


def gaps(answers: list, ref: np.ndarray, order: np.ndarray) -> dict:
    """The widest gaps, over every answer, between P(stego) given and the
    reference's:

    - ``p_gap``: |P - P_ref|;
    - ``logp_gap``: the gap in log P where P_ref < 0.5, in log(1 - P) where
      P_ref >= 0.5, over the answers whose P is at least ``LOW_FLOOR``
      and whose 1 - P is at least ``HIGH_FLOOR``: there it is the gap of
      the two logits' difference, which P itself hides once the softmax
      saturates; beyond them the program's float32 P is flushed to 0 or
      cannot resolve 1 - P.

    A missing or NaN answer reads infinite."""
    inf = {"p_gap": float("inf"), "logp_gap": float("inf")}
    low = ref < 0.5
    side = np.where(low, ref, 1.0 - ref)
    kept = np.where(low, ref >= LOW_FLOOR, 1.0 - ref >= HIGH_FLOOR)
    out = {"p_gap": 0.0, "logp_gap": 0.0}
    for p in answers:
        if len(p) != len(order):
            return inf
        p = p.astype(np.float64)
        r = ref[order]
        if not np.all(np.isfinite(p)):
            return inf
        out["p_gap"] = max(out["p_gap"], float(np.abs(p - r).max()))
        k = kept[order]
        mine = np.where(low[order], p, 1.0 - p)[k]
        if np.any(mine <= 0):
            return inf
        if k.any():
            out["logp_gap"] = max(out["logp_gap"], float(np.abs(
                np.log(mine) - np.log(side[order][k])).max()))
    return out


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        from wsunet_tpu_torch.data import pipeline
        from wsunet_tpu_torch.detect import b0_eval
        from wsunet_tpu_torch.io.imread import imread_gray_u8
        from wsunet_tpu_torch.models import get_b0

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.config
        self.inputs = make_inputs(ctx.seed, t, ctx.data)
        self.sd = weights.state_dict(ctx.root / cfg["weights"])
        model = get_b0(in_channels=cfg["in_channels"],
                       no_stem_stride=cfg["no_stem_stride"],
                       quadratic_stem=cfg["quadratic_stem"],
                       parity_features=cfg["parity_features"],
                       norm=cfg["norm"],
                       compute_dtype=getattr(torch, cfg["dtype"]))
        model.load_state_dict(self.sd)
        model = model.to(ctx.device).eval()
        self.hits = 0
        self.cached = set()

        def detect(x):
            if id(x) in self.cached:
                self.hits += 1
            with ctx.spans("predict"):
                return b0_eval.infer_b0(
                    model, x, use_lsbr_reference=cfg["lsbr_reference"],
                    device=ctx.device)

        self.model, self.detect = model, detect
        self.stats = {}
        self.reader = counting_reader(imread_gray_u8, self.stats)
        self.pipeline = pipeline
        pipeline.clear_decode_cache()
        self._sweep()
        self.cached = {id(v[0]) for v in pipeline._DEVICE_CACHE.values()}
        self.n_batches = -(-len(self.inputs["names"]) // t["batch_size"])
        if len(self.cached) != self.n_batches:
            raise RuntimeError(
                f"the device cache holds {len(self.cached)} of the sweep's "
                f"{self.n_batches} batches: the mix is not device-resident")
        # a batch from the device cache: the window's path, on the shape
        # the pass above ran
        self._sweep(self.inputs["names"][:t["batch_size"]])
        self.stats.update(decodes=0, decode_s=0.0)
        self.hits = 0

    def _sweep(self, names=None):
        from wsunet_tpu_torch.detect import b0_eval

        names = self.inputs["names"] if names is None else names
        with self.ctx.spans("sweep"):
            return b0_eval.score_sweep(
                self.ctx.data, names, self.detect,
                self.ctx.traffic["batch_size"],
                threads=self.ctx.traffic["threads"], reader=self.reader,
                device=self.ctx.device)

    def _pass(self) -> np.ndarray:
        return self._sweep()

    def window(self, seconds: float):
        self.answers = []
        t0 = time.perf_counter()
        with self.ctx.spans("window"):
            while time.perf_counter() - t0 < seconds:
                self.answers.append(self._pass())
        window_s = time.perf_counter() - t0
        n = sum(len(p) for p in self.answers)
        self.ctx.counts.update(
            window_s=window_s, images=n, attempted=n,
            failed=sum(int(np.sum(~np.isfinite(p))) for p in self.answers),
            passes=len(self.answers),
            batches=len(self.answers) * self.n_batches,
            device_cache_hits=self.hits, decodes=self.stats["decodes"])

    def evidence(self) -> list:
        c = self.ctx.counts
        return [f"window: {c['passes']} passes, {c['batches']} batches, "
                f"{c['device_cache_hits']} device-cache hits, "
                f"{c['decodes']} decodes"]

    def release(self):
        self.pipeline.clear_decode_cache()
        del self.model, self.detect

    def check(self) -> dict:
        ref = reference_answers(self.sd, self.inputs, self.ctx.device,
                                self.ctx.config)
        return gaps(self.answers, ref, self.inputs["order"])


class Control(Cell):
    """The cell with the plain reference in TF32, the precision below the
    configuration's float32, in the program's place: each pass's answers
    are the reference's of the distinct images, handed out in the
    catalog's order."""

    def setup(self):
        ctx = self.ctx
        self.inputs = make_inputs(ctx.seed, ctx.traffic, ctx.data)
        self.sd = weights.state_dict(ctx.root / ctx.config["weights"])
        self.n_batches = -(-len(self.inputs["names"])
                           // ctx.traffic["batch_size"])
        self.hits = 0
        self.stats = {"decodes": 0, "decode_s": 0.0}

    def _pass(self) -> np.ndarray:
        low = reference_answers(self.sd, self.inputs, self.ctx.device,
                                self.ctx.config, tf32=True)
        return low[self.inputs["order"]]

    def release(self):
        pass


CONTROLS = {"control": Control}
