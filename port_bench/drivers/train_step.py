"""Driver of the U-Net training step (traffic kind ``train_step``).

Inputs, from the seed: ``covers`` grayscale covers of ``side``^2 written
as PNG files, an image order (a permutation of them, repeated), and each
step's draws, made by the benchmark on the device from its own generator:
flips, quarter turns, the cover/stego choice, LSB replacement's mask
(uniform < ``alpha``) and bits, in the keys of
``train.train_unet.Sampler.draw``.

Set-up builds one training step, ``train.train_unet._make_step`` on the
``unet_2`` weights of the committed run (the recipe resumes from a run),
with ``make_optimizer``'s AdamW under the recipe's schedule, fed by
``train.common.rank_batches`` (the trainer's own decode), and drives it
through its first ``checked_steps`` steps, whose rows all differ.  From
them it keeps each step's loss, the first gradient as the optimizer holds
it (AdamW's first moment after one step is (1 - b1) g) and the
parameters' change after the last, before the next step moves them.  The
window goes on with the same object, one step after another, reading the
loss back after each as ``train_names`` does.

The check follows the checked steps with the plain reference
(``reference.train``) from the same weights, covers and draws, and
compares each step's loss, and by the worst parameter the norms of the
first gradient and of the change (see ``compare``).

``CONTROLS`` names the cells with the reference in the program's place
that the check has to fail (``control.py``): ``control``, the reference in
TF32, the precision below the configuration's float32; ``half_batch``,
each step's loss a mean over half of the batch, the rest left out;
``loss_altered``, each step's loss read back 1e-3 higher, as altered
where it is produced.  A step that returns its state unchanged reads 1 on
``change_gap`` by its definition and needs no run.
"""

import concurrent.futures
import time

import numpy as np
import torch

from port_bench.harness import images, weights
from port_bench.harness.cells import counting_reader
from port_bench.reference import precision
from port_bench.reference import train as ref_train


def make_inputs(seed: int, t: dict, data) -> dict:
    n, side = t["covers"], t["side"]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        covers = np.stack(list(pool.map(
            lambda i: images.cover(seed, i, side), range(n))))
    images.write_pngs(data, {f"covers/{i:04d}.png": covers[i]
                             for i in range(n)})
    g = images.rng(seed, 5)
    order = np.concatenate([g.permutation(n)
                            for _ in range(-(-t["max_steps"]
                                             * t["batch_size"] // n))])
    return {"covers": covers, "order": order,
            "names": [f"covers/{i:04d}.png" for i in order]}


def _generator(ctx) -> torch.Generator:
    """The draws' generator, on the device, from the seed."""
    return torch.Generator(device=ctx.device).manual_seed(
        int(images.rng(ctx.seed, 6).integers(2 ** 62)))


def make_draws(t: dict, generator: torch.Generator) -> dict:
    """One step's draws, on the generator's device."""
    B, s, dev = t["batch_size"], t["crop"], generator.device
    d = {}
    if t["augment"]:
        d["flip_h"] = torch.rand(B, generator=generator, device=dev) < 0.5
        d["flip_v"] = torch.rand(B, generator=generator, device=dev) < 0.5
        d["k"] = torch.randint(0, 4, (B,), generator=generator, device=dev)
    d["is_stego"] = torch.rand(B, generator=generator, device=dev) \
        < 1.0 - t["cover_fraction"]
    d["embed"] = torch.rand((B, s, s), generator=generator, device=dev) \
        < t["alpha"]
    d["bits"] = torch.rand((B, s, s), generator=generator, device=dev) < 0.5
    return d


def reference_run(sd: dict, checked: list, t: dict, device,
                  tf32: bool = False, loss_fn=None) -> dict:
    """The reference over the checked steps, (covers, draws) each (in TF32
    for the control; with ``loss_fn`` in the loss's place for a fault)."""
    steps = [(torch.from_numpy(c), d) for c, d in checked]
    with precision(tf32):
        return ref_train.run(sd, steps, t, device, loss_fn)


def program_like(run: dict) -> dict:
    """A reference run's readings in the program's form (``compare``'s
    first argument), for the control."""
    return {"losses": run["losses"], "grad_norms": _norms(run["first_grad"]),
            "change_norms": _norms(run["change"])}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def compare(program: dict, ref: dict) -> dict:
    """The numbers compared, from the program's losses and per-parameter
    norms of the first gradient and of the change, and the reference's
    run (``reference.train.run``):

    - ``loss_gap``: the widest |loss - reference's| / |reference's| over
      the steps;
    - ``grad_gap``: the widest, over the parameters, gap between the norm
      of the program's first gradient and the reference's, over the
      larger of that parameter's reference norm and the median
      parameter's;
    - ``change_gap``: the same for the norm of the change, over the
      parameters whose reference gradient is not nought to rounding (at
      least a thousandth of the median parameter's).

    A missing or non-finite reading is infinite."""
    inf = float("inf")
    out = {"loss_gap": inf, "grad_gap": inf, "change_gap": inf}
    losses = program.get("losses", [])
    if len(losses) == len(ref["losses"]) and all(np.isfinite(losses)):
        out["loss_gap"] = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, ref["losses"]))
    g_ref = _norms(ref["first_grad"])
    g_med = float(np.median(list(g_ref.values())))
    grads = program.get("grad_norms")
    if grads and set(grads) == set(g_ref):
        out["grad_gap"] = max(abs(grads[k] - g_ref[k]) / max(g_ref[k], g_med)
                              for k in g_ref)
    c_ref = _norms(ref["change"])
    moved = [k for k in c_ref if g_ref[k] >= 1e-3 * g_med]
    c_med = float(np.median([c_ref[k] for k in moved]))
    changes = program.get("change_norms")
    if changes and set(changes) == set(c_ref):
        out["change_gap"] = max(abs(changes[k] - c_ref[k])
                                / max(c_ref[k], c_med) for k in moved)
    return {k: (v if np.isfinite(v) else inf) for k, v in out.items()}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        from wsunet_tpu_torch.io.imread import imread_gray_u8
        from wsunet_tpu_torch.models import get_model
        from wsunet_tpu_torch.parallel import get_mesh
        from wsunet_tpu_torch.train import common, losses, train_unet

        ctx, t, cfg = self.ctx, self.ctx.traffic, self.ctx.config
        self.inputs = make_inputs(ctx.seed, t, ctx.data)
        self.sd = weights.state_dict(ctx.root / cfg["weights"])
        model = get_model(cfg["network"], drop_rate=None,
                          compute_dtype=getattr(torch, cfg["dtype"]))
        model.load_state_dict(self.sd)
        model = model.to(ctx.device)
        loss_fn = losses.get_loss(
            t["loss"], per_image=True,
            loss_lambda=t["loss_lambda"] if t["weighted_loss"] else None)
        optimizer, scheduler = train_unet.make_optimizer(
            {"learning_rate": t["learning_rate"],
             "lr_schedule": t["lr_schedule"], "num_epochs": t["num_epochs"]},
            t["steps_per_epoch"], model.parameters())
        self.train_step, _ = train_unet._make_step(
            model, loss_fn, optimizer, scheduler, t["stego_method"],
            t["alpha"], crop=t["crop"], augment=t["augment"],
            cover_fraction=t["cover_fraction"])
        self.model, self.optimizer = model, optimizer
        self.stats = {}
        reader = counting_reader(imread_gray_u8, self.stats)
        self.batches = common.rank_batches(
            get_mesh(), ctx.data, self.inputs["names"], t["batch_size"],
            reader, ctx.device)
        self.generator = _generator(ctx)
        self.steps = 0
        self.losses, self.ends = [], []
        checked = []
        start = {k: v.detach().clone() for k, v in
                 model.named_parameters()}
        for i in range(t["checked_steps"]):
            d = self._step()
            checked.append((self.inputs["covers"][self.inputs["order"][
                i * t["batch_size"]:(i + 1) * t["batch_size"]]],
                {k: v.cpu() for k, v in d.items()}))
            if i == 0:
                b1 = optimizer.param_groups[0]["betas"][0]
                grads = {k: optimizer.state[p]["exp_avg"] / (1.0 - b1)
                         for k, p in model.named_parameters()
                         if p in optimizer.state}
        self.program = {
            "losses": list(self.losses),
            "grad_norms": _norms(grads),
            "change_norms": _norms({k: p.detach() - start[k] for k, p in
                                    model.named_parameters()})}
        self.checked = checked
        del start

    def _step(self) -> dict:
        spans = self.ctx.spans
        with spans("decode"):
            _, pixels, mask = next(self.batches)
        with spans("draw"):
            d = make_draws(self.ctx.traffic, self.generator)
        with spans("step"):
            loss = self.train_step(pixels, mask, draws=d)
        with spans("loss_read"):
            self.losses.append(float(loss))
        self.steps += 1
        self.ends.append(time.perf_counter())
        return d

    def window(self, seconds: float):
        first, losses0 = self.steps, len(self.losses)
        self.stats.update(decodes=0, decode_s=0.0)
        t0 = time.perf_counter()
        with self.ctx.spans("window"):
            while time.perf_counter() - t0 < seconds:
                self._step()
        window_s = time.perf_counter() - t0
        steps = self.steps - first
        B = self.ctx.traffic["batch_size"]
        self.ctx.counts.update(
            window_s=window_s, steps=steps, images=steps * B,
            attempted=steps,
            failed=int(np.sum(~np.isfinite(self.losses[losses0:]))),
            decodes=self.stats["decodes"])

    def evidence(self) -> list:
        c = self.ctx.counts
        ms = 1e3 * np.diff(self.ends[-c["steps"] - 1:])
        q = np.percentile(ms, [10, 50, 90]) if len(ms) else []
        return [f"window: {c['steps']} steps of "
                f"{self.ctx.traffic['batch_size']} images, {c['decodes']} "
                f"decodes; step ms p10/p50/p90 "
                f"{' / '.join(f'{v:.2f}' for v in q)}; checked steps' "
                f"losses {self.program['losses']}"]

    def release(self):
        del self.train_step, self.model, self.optimizer, self.batches

    def check(self) -> dict:
        t = self.ctx.traffic
        return compare(self.program, reference_run(
            self.sd, self.checked, t, self.ctx.device))


class Control(Cell):
    """The cell with the plain reference in TF32 in the program's place:
    the checked steps' readings are the reference's, from the same
    weights, covers and draws.  Training's readings need no window: it
    runs no step."""

    def setup(self):
        ctx, t = self.ctx, self.ctx.traffic
        self.inputs = make_inputs(ctx.seed, t, ctx.data)
        self.sd = weights.state_dict(ctx.root / ctx.config["weights"])
        gen, B = _generator(ctx), t["batch_size"]
        self.checked = [
            (self.inputs["covers"][self.inputs["order"][i * B:(i + 1) * B]],
             {k: v.cpu() for k, v in make_draws(t, gen).items()})
            for i in range(t["checked_steps"])]
        self.program = self.readings()

    def readings(self) -> dict:
        return program_like(reference_run(
            self.sd, self.checked, self.ctx.traffic, self.ctx.device,
            tf32=True))

    def window(self, seconds: float):
        self.ctx.counts.update(window_s=seconds, steps=0, images=0,
                               attempted=0, failed=0, decodes=0)

    def evidence(self) -> list:
        return [f"control: checked steps' losses {self.program['losses']}"]

    def release(self):
        pass


def _half_batch(params, cover, d, alpha, lam):
    h = cover.shape[0] // 2
    return ref_train.loss(params, cover[:h], {k: v[:h] for k, v in d.items()},
                          alpha, lam)


class HalfBatch(Control):
    """The reference in full float32 with each step's loss a mean over the
    first half of the batch."""

    def readings(self) -> dict:
        return program_like(reference_run(
            self.sd, self.checked, self.ctx.traffic, self.ctx.device,
            loss_fn=_half_batch))


class LossAltered(Control):
    """The reference in full float32 with each step's loss read back 1e-3
    higher."""

    def readings(self) -> dict:
        out = program_like(reference_run(
            self.sd, self.checked, self.ctx.traffic, self.ctx.device))
        out["losses"] = [v * (1 + 1e-3) for v in out["losses"]]
        return out


CONTROLS = {"control": Control, "half_batch": HalfBatch,
            "loss_altered": LossAltered}
