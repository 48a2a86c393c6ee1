"""U-Net predictor training (port of ``wsunet_tpu/train/train_unet.py``).

The JAX trainer's surface, on one device:

- the experiment directory ``<output_dir>/<method or "dropout">/<stamp>-
  <platform>-<run name>`` with ``config.json``, ``model/{latest,best}``
  (``train.checkpoint``; torch state), ``best.npz`` (the best parameters in
  the Flax layout that ``ws.unet_eval.load_pretrained_unet`` reads) and
  ``log/scalars.csv`` (TensorBoard event files too where tensorboard
  imports);
- the sample pipeline of a step runs on the device: random crop, flips
  and rot90, a per-image cover/stego draw, and LSBr or HILLr embedding;
  the host ships decoded cover batches only;
- AdamW (optax's defaults: weight decay 1e-4), optionally under optax's
  warmup + cosine decay schedule; early stopping on ``select_metric``.

A step is split in two (``Sampler``): ``draw`` makes every random choice
of the step on the device from one ``torch.Generator`` (crop offsets,
flips, quarter turns, the cover/stego draw, LSBr's mask and bits, the
input dropout's keep mask), and ``loss`` is a pure function of the covers
and those draws.  The draws are torch's, not ``jax.random``'s; given the
same draws the loss and gradients are JAX's (``tests/test_torch_train.py``
and ``chip_smoke.py`` phase 11 replay JAX's own draws).

Validation runs the model in training mode under a fixed generator per
validation batch, as the JAX trainer runs ``deterministic=False`` under a
fixed dropout key: a dropout run is validated with dropout active.

Data parallel under a process group (``parallel``), as the JAX trainer
shards the batch over a 1-D ``data`` mesh with the parameters replicated:
every rank starts from rank 0's parameters, decodes its contiguous block
of each batch (``common.rank_batches``), and makes the global batch's
draws from the same generator and keeps their block.  The masked mean's count is summed over the
ranks, so each rank's loss is its share of the global masked mean, and
the gradients are summed over the ranks: a step on two ranks is the step
on one.  The validation loss is reduced the same way and the validation
outputs gathered, so every rank sees the same metrics and stops at the
same epoch.  ``batch_size`` is the global batch and must divide by the
world size.  Rank 0 alone writes the run; the others wait at barriers.

``train`` reads the split CSVs (pandas) and calls ``train_names``, which
takes image names and reads no CSV, so it runs where pandas is not
installed.
"""

import dataclasses
import math
import pathlib
import typing

import numpy as np
import torch

from .._device import resolve_device
from ..data.simulate import hillr_simulate, lsbr_draws, lsbr_embed
from ..data.transforms import crop, flip, rot90
from ..detect.metrics import LossMeter, MAEMeter, ProgressMeter, WSMeter
from ..io.imread import imread_gray_u8
from ..models import (flax_params_from_unet_state_dict, get_model, init_unet,
                      unet_state_dict_from_flax)
from ..parallel import get_mesh, replicate, shard_batch
from ..utils import setup_logger
from ..utils.errors import UserError
from ..utils.profiling import span
from .checkpoint import (PARAMS_FILE, load_checkpoint, load_params,
                         save_checkpoint, save_config, save_params)
from .common import (epoch_names, on_rank0, rank_batches, rank_writer,
                     repeat_names, run_dir, val_generator)
from .config import UNetTrainConfig
from .losses import get_loss

log = setup_logger("train_unet")

DEFAULT_CONFIG = dataclasses.asdict(UNetTrainConfig())


class Sampler:
    """The draws and the pure loss of one training step (the body of the
    JAX ``_make_step``'s ``compute_loss``).

    ``draw(shape, generator)`` -> dict of tensors on the generator's
    device, present only where the configuration uses them:

    - ``oi``, ``oj`` [B] int64: crop offsets (``crop`` < H);
    - ``flip_h``, ``flip_v``, ``k`` [B]: flips and quarter turns
      (``augment``);
    - ``is_stego`` [B] bool: Bernoulli(1 - ``cover_fraction``);
    - ``embed``, ``bits`` [B, h, w] bool: LSBr's mask (uniform < alpha) and
      bits;
    - ``keep`` [B, 1, h, w] bool: the input dropout's mask (``drop_rate``).

    ``loss(cover_u8, mask, draws)`` -> (masked mean loss, outputs,
    inputs, alphas): crop, flip, rot90, alpha per image, embedding (HILLr:
    ``where(alpha > 0, hillr(cover), cover)``), /255, the model (in the
    mode it is in), per-image loss, mean over ``mask``.  With a ``mesh``
    the batch is this rank's block and the mean's count is the global
    batch's, so the loss is this rank's share of the global mean."""

    def __init__(self, model, loss_fn, stego_method, alpha, crop=None,
                 augment=False, cover_fraction=0.5, mesh=None):
        self.model = model
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.crop = crop
        self.augment = augment
        self.cover_fraction = cover_fraction
        self.alpha = 0.0 if (stego_method is None or alpha is None) \
            else float(alpha)
        if stego_method is None or alpha in (None, 0.0):
            self.method = None
        elif stego_method.upper().startswith("LSB"):
            self.method = "LSBR"
        else:
            self.method = "HILLR"
        dropout = getattr(model, "input_dropout", None)
        self.drop_rate = dropout.rate if dropout is not None else 0.0

    def crops(self, H: int) -> bool:
        return self.crop is not None and self.crop < H

    def draw(self, shape, generator: torch.Generator) -> dict:
        B, H, W = shape
        g, dev = generator, generator.device
        h, w = (self.crop, self.crop) if self.crops(H) else (H, W)
        d = {}
        if self.crops(H):
            d["oi"] = torch.randint(0, H - self.crop + 1, (B,), generator=g,
                                    device=dev)
            d["oj"] = torch.randint(0, W - self.crop + 1, (B,), generator=g,
                                    device=dev)
        if self.augment:
            d["flip_h"] = torch.rand(B, generator=g, device=dev) < 0.5
            d["flip_v"] = torch.rand(B, generator=g, device=dev) < 0.5
            d["k"] = torch.randint(0, 4, (B,), generator=g, device=dev)
        d["is_stego"] = torch.rand(B, generator=g, device=dev) \
            < 1.0 - self.cover_fraction
        if self.method == "LSBR":
            u, d["bits"] = lsbr_draws((B, h, w), g)
            d["embed"] = u < self.alpha
        if self.drop_rate:
            d["keep"] = torch.rand((B, 1, h, w), generator=g, device=dev) \
                < 1.0 - self.drop_rate
        return d

    def embed(self, cover_u8, alphas, d):
        if self.method is None:
            return cover_u8
        stego = alphas[:, None, None] > 0
        if self.method == "LSBR":
            return lsbr_embed(cover_u8, d["embed"] & stego, d["bits"])
        return torch.where(stego, hillr_simulate(cover_u8, self.alpha),
                           cover_u8)

    def loss(self, cover_u8, mask, d):
        x = cover_u8
        if "oi" in d:
            x = crop(x, d["oi"], d["oj"], self.crop)
        if "k" in d:
            x = rot90(flip(x, d["flip_h"], d["flip_v"]), d["k"])
        alphas = torch.where(d["is_stego"], self.alpha, 0.0).to(
            torch.float32)
        stego = self.embed(x, alphas, d)
        covers = x.to(torch.float32)[:, None] / 255.0
        inputs = stego.to(torch.float32)[:, None] / 255.0
        outputs = self.model(inputs, keep=d.get("keep"))
        # masked mean: padded tail rows must not steer gradients or the
        # early-stopping validation loss
        per_image = self.loss_fn(outputs, covers, inputs, alphas)
        w = mask.to(per_image.dtype)
        count = torch.sum(w)
        if self.mesh is not None:
            count = self.mesh.all_reduce(count)
        loss = torch.sum(per_image * w) / torch.clamp(count, min=1.0)
        return loss, outputs, inputs, alphas


def _make_step(model, loss_fn, optimizer, scheduler, stego_method, alpha,
               crop=None, augment=False, cover_fraction=0.5, mesh=None):
    """(train_step, eval_step), each ``(cover_u8 [B, H, W], mask [B],
    generator, draws=None)`` on the model's device.  ``train_step`` draws
    (unless ``draws`` is given), takes one AdamW step and one scheduler
    step, and returns the loss; ``eval_step`` returns (loss, outputs,
    inputs, alphas) without gradients.  Both run the model in training
    mode, as JAX's do.

    With a ``mesh`` (a ``parallel.Mesh`` with a process group) both take
    this rank's contiguous block of the global batch and its mask, make
    (or take) the global batch's draws and keep their block, and return
    what the one-rank step returns: the global loss (its share summed over
    the ranks) and, from ``eval_step``, the global batch's outputs, inputs
    and alphas; ``train_step`` sums the gradients over the ranks before
    its AdamW step.

    A ``train_step`` is the span ``train.step`` (``utils.profiling``), with
    the children ``train.forward`` (draws, forward and loss),
    ``train.backward`` (gradients, summed over the ranks) and
    ``train.optimizer`` (AdamW's and the scheduler's steps)."""
    sampler = Sampler(model, loss_fn, stego_method, alpha, crop=crop,
                      augment=augment, cover_fraction=cover_fraction,
                      mesh=mesh)

    def local(cover_u8, generator, draws):
        if mesh is None:
            return draws if draws is not None else sampler.draw(
                cover_u8.shape, generator)
        shape = (cover_u8.shape[0] * mesh.world,) + tuple(cover_u8.shape[1:])
        return shard_batch(mesh, draws if draws is not None else
                           sampler.draw(shape, generator))

    def train_step(cover_u8, mask, generator=None, draws=None):
        with span("train.step"):
            with span("train.forward"):
                d = local(cover_u8, generator, draws)
                model.train()
                optimizer.zero_grad(set_to_none=True)
                loss = sampler.loss(cover_u8, mask, d)[0]
            with span("train.backward"):
                loss.backward()
                if mesh is not None:
                    mesh.sum_gradients(model)
                    loss = mesh.all_reduce(loss)
            with span("train.optimizer"):
                optimizer.step()
                scheduler.step()
            return loss.detach()

    @torch.no_grad()
    def eval_step(cover_u8, mask, generator=None, draws=None):
        d = local(cover_u8, generator, draws)
        model.train()
        out = sampler.loss(cover_u8, mask, d)
        if mesh is None:
            return out
        return (mesh.all_reduce(out[0]),
                *(mesh.gather_batch(t) for t in out[1:]))

    train_step.sampler = eval_step.sampler = sampler
    return train_step, eval_step


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> typing.Callable:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps must exceed warmup_steps, got "
                         f"{decay_steps} <= {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(cfg: dict, steps_per_epoch: int, params):
    """(AdamW, LambdaLR): AdamW with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4 on every parameter; torch's own default
    decay of 1e-2 is not it), and with ``lr_schedule: "cosine"`` optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total, lr * 0.01)``.
    optax reads the schedule at the step count before the update, so the
    first step's rate is 0 when there is a warmup; ``LambdaLR`` sets the
    rate of step t before it, the same."""
    lr = cfg["learning_rate"]
    schedule = None
    if cfg.get("lr_schedule") == "cosine":
        total = max(1, steps_per_epoch * cfg["num_epochs"])
        warmup = min(total // 20, 2 * steps_per_epoch)
        schedule = warmup_cosine_decay(0.0, lr, warmup, total,
                                       end_value=lr * 0.01)
    elif cfg.get("lr_schedule"):
        raise NotImplementedError(f"lr_schedule {cfg['lr_schedule']!r}")

    def factor(count: int) -> float:
        return schedule(count) / lr if schedule and lr else 1.0

    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def _resume(model, resume_dir: pathlib.Path):
    """Load the parameters of ``resume_dir``'s ``model/best`` (a run the
    port trained) or, without one, of its ``best.npz`` (a JAX run
    exported with ``scripts/export_torch_weights.py``)."""
    if (resume_dir / "model").exists():
        state = load_checkpoint(resume_dir, "best")["params"]
    elif (resume_dir / PARAMS_FILE).exists():
        state = unet_state_dict_from_flax(load_params(resume_dir)[0])
    else:
        raise FileNotFoundError(
            f"no model/best or {PARAMS_FILE} to resume from at {resume_dir}")
    model.load_state_dict(state)


def train_names(config: dict, data_path: pathlib.Path,
                tr_names: typing.Sequence[str],
                va_names: typing.Sequence[str], output_dir: pathlib.Path,
                device=None, reader: typing.Callable = imread_gray_u8
                ) -> pathlib.Path:
    """Run one U-Net training experiment over the training and validation
    images ``tr_names`` / ``va_names`` under ``data_path`` (decoded with
    ``reader``) on ``device`` (None = CUDA); returns the experiment dir.
    Under a process group every rank takes its block of each batch
    (module docstring)."""
    dev = resolve_device(device)
    cfg = UNetTrainConfig.validate(config)
    mesh = get_mesh()
    if cfg["batch_size"] % mesh.world:
        raise UserError(f"batch_size {cfg['batch_size']} does not divide "
                        f"over {mesh.world} ranks")
    step_mesh = mesh if mesh.group is not None else None
    stego_method = cfg["stego_method"]
    exp_dir = run_dir(mesh, output_dir, stego_method or "dropout", dev.type,
                      cfg)
    # registry label: cover-only (dropout-regularised) runs are registered
    # under "dropout"
    on_rank0(mesh, save_config, exp_dir,
             {**cfg, "dataset": str(data_path),
              "stego_method": stego_method or "dropout"})
    writer = rank_writer(mesh, exp_dir / "log")

    model = init_unet(get_model(
        cfg["network"], drop_rate=cfg["drop_rate"],
        disable_center=cfg["disable_center"],
        compute_dtype=getattr(torch, cfg["compute_dtype"])), cfg["seed"] or 0)
    if cfg.get("resume"):
        resume_dir = (pathlib.Path(output_dir) / (stego_method or "dropout")
                      / cfg["resume"])
        _resume(model, resume_dir)
        log.info(f"resumed params from {resume_dir}")
    replicate(mesh, model.to(dev))
    loss_fn = get_loss(
        cfg["loss"], per_image=True,
        loss_lambda=cfg["loss_lambda"] if cfg.get("weighted_loss") else None)

    batch_size = cfg["batch_size"]
    steps_per_epoch = cfg.get("steps_per_epoch") or max(
        1, len(tr_names) // batch_size)
    optimizer, scheduler = make_optimizer(cfg, steps_per_epoch,
                                          model.parameters())
    train_step, eval_step = _make_step(
        model, loss_fn, optimizer, scheduler, stego_method, cfg["alpha"],
        crop=cfg.get("crop"), augment=cfg.get("augment", False),
        cover_fraction=cfg.get("cover_fraction", 0.5), mesh=step_mesh)

    seed = cfg["seed"] or 0
    generator = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(cfg["seed"])
    va_ep = repeat_names(list(va_names), cfg.get("val_steps"), batch_size)

    def batches(names):
        return rank_batches(mesh, data_path, names, batch_size, reader, dev)

    best_val_loss = np.inf
    patience = cfg["patience"]
    try:
        for epoch in range(cfg["num_epochs"]):
            names = epoch_names(tr_names, rng, cfg.get("steps_per_epoch"),
                                batch_size)
            loss_meter = LossMeter(":.4e")
            progress = ProgressMeter(max(1, len(names) // batch_size),
                                     [loss_meter], prefix=f"Epoch: [{epoch}]")
            for valid, pixels, mask in batches(names):
                loss = train_step(pixels, mask, generator)
                loss_meter.update(float(loss), int(valid.sum()))
            log.info(progress.to_str(0))
            writer.add_scalar("train/loss", loss_meter.avg, epoch)

            va_meter, ws_meter = LossMeter(), WSMeter()
            mae_meter = MAEMeter(multiplier=255)
            for vb, (valid, pixels, mask) in enumerate(batches(va_ep)):
                loss, outputs, inputs, alphas = eval_step(
                    pixels, mask, val_generator(seed, vb, dev))
                va_meter.update(float(loss), int(valid.sum()))
                m = valid
                inputs, outputs = inputs.cpu().numpy(), outputs.cpu().numpy()
                ws_meter.update(inputs[m], outputs[m], alphas.cpu().numpy()[m])
                mae_meter.update(inputs[m], outputs[m])
            writer.add_scalar("val/loss", va_meter.avg, epoch)
            writer.add_scalar("val/ws", ws_meter.avg, epoch)
            writer.add_scalar("val/mae", mae_meter.avg, epoch)
            log.info(f"epoch {epoch}: val loss {va_meter.avg:.5f} "
                     f"ws {ws_meter.avg:.5f} mae255 {mae_meter.avg:.3f}")

            val_loss = (ws_meter.avg if cfg.get("select_metric") == "ws"
                        else va_meter.avg)
            state = {"params": model.state_dict(),
                     "opt_state": optimizer.state_dict(),
                     "scheduler": scheduler.state_dict(), "epoch": epoch,
                     "best_val_loss": float(best_val_loss),
                     "patience": patience}
            # "last": best tracks the end of the schedule
            is_best = (True if cfg.get("select_metric") == "last"
                       else val_loss < best_val_loss)
            on_rank0(mesh, save_checkpoint, exp_dir, state, is_best=is_best)
            if is_best:
                on_rank0(mesh, save_params, exp_dir,
                         flax_params_from_unet_state_dict(model.state_dict()))
                patience = cfg["patience"]
                best_val_loss = val_loss
            else:
                patience -= 1
            if patience <= 0:
                log.info("early stopping (patience exhausted)")
                break
    finally:
        writer.close()
    return exp_dir


def train(config: dict, data_path: pathlib.Path, output_dir: pathlib.Path,
          device=None) -> pathlib.Path:
    """Run one U-Net training experiment over the ``tr_csv`` / ``va_csv``
    splits of the catalog at ``data_path``; returns the experiment dir."""
    from ..data.catalog import precovers

    resolve_device(device)
    cfg = UNetTrainConfig.validate(config)
    tr = list(precovers(data_path, split=cfg["tr_csv"])["name"])
    va = list(precovers(data_path, split=cfg["va_csv"])["name"])
    return train_names(config, data_path, tr, va, output_dir, device=device)
