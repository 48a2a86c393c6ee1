"""EfficientNet-B0 detector training (port of
``wsunet_tpu/train/train_b0.py``).

The JAX trainer's surface, on one device:

- the experiment directory ``<output_dir>/<stego_method>/<stamp>-<cuda|
  cpu>-<run name>`` with ``config.json``, ``model/{latest,best}`` (torch
  state: the model's ``state_dict`` with its running statistics, the
  optimizer's and the scheduler's), ``best.npz`` (the best parameters in
  the Flax layout and, with batch norm, the running statistics under
  ``batch_stats/``, as ``detect.b0_eval.load_pretrained_b0`` reads them
  and the JAX ``EfficientNetB0`` takes them) and ``log/scalars.csv``;
- a step's cover/stego pairs are made on the device: random crop, flips
  and quarter turns, a per-image rate from the ``alpha`` mixture, LSBr or
  HILLr embedding; each cover batch becomes its cover half then its stego
  half, labels 0 then 1;
- the masked cross-entropy, sum(ce * w) / max(sum(w), 1), with AdamW
  (optax's defaults) under the optional cosine schedule
  (``train_unet.make_optimizer``);
- ``freeze_bn``: the step runs the model in eval mode, against the
  running statistics and without head dropout, while the gradients still
  flow; otherwise it runs in training mode, where batch norm normalises
  with the batch statistics and moves its running ones as Flax does
  (``models.b0.FlaxBatchNorm``);
- validation in eval mode over ``val_alpha`` pairs, repeated to
  ``val_steps`` batches, under a fixed generator per batch; loss, P_E,
  P_MD@5%FP and accuracy under ``train/`` and ``val/``; selection by
  ``select_metric`` (``loss``, ``p_e`` or ``last``) with patience;
- ``resume`` starts from the named run's parameters and running
  statistics (a run the port trained, or an exported JAX run's
  ``best.npz``).

As in the U-Net trainer a step is split in two (``B0Sampler``): ``draw``
makes every random choice from one ``torch.Generator`` on the device, and
``loss`` is a pure function of the covers and those draws, so a step can
replay the JAX trainer's own draws (``tests/test_torch_train_b0.py``,
``chip_smoke.py`` phase 12).

Data parallel under a process group (``parallel``), as in the U-Net
trainer: every rank starts from rank 0's parameters and running
statistics, decodes its block of each batch's covers
(``common.rank_batches``), makes the global batch's draws and keeps their
block (the head dropout's mask [2B, 1280]: its rows of both halves), so
each rank runs the model on its ``[covers; stegos]``
pairs.  In training mode batch norm takes the statistics of the global
batch (``models.b0.FlaxBatchNorm`` with a mesh), as JAX's batch-sharded
batch norm does, so the running statistics move identically on every
rank.  The cross-entropy's count is summed over the ranks and the
gradients too, and the logits are gathered into the global ``[covers;
stegos]`` order for the meters.  ``batch_size`` must divide by the world
size; rank 0 alone writes the run.

The JAX trainer builds a model with 3 (``grayscale=False``) or 4 and more
(``demosaic_oracle``) input planes while its preprocessing gives 1 or 2,
so its first step fails on the stem's parameter shape; the port refuses
those configurations with a ``UserError`` before it starts.
"""

import dataclasses
import pathlib
import typing

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..data.simulate import hillr_simulate, lsbr_draws, lsbr_embed
from ..data.transforms import crop, flip, lsbr_reference, normalize, rot90
from ..detect.b0_eval import IMAGENET_GREEN_MEAN, IMAGENET_GREEN_STD
from ..detect.metrics import (AccuracyMeter, LossMeter, PEMeter,
                              PMD5FPMeter, ProgressMeter)
from ..io.imread import imread_gray_u8
from ..models import (b0_state_dict_from_flax,
                      flax_b0_params_from_state_dict, get_b0, init_b0)
from ..models.b0 import HEAD_WIDTH, set_batch_norm_mesh
from ..parallel import get_mesh, replicate
from ..utils import setup_logger
from ..utils.errors import UserError
from .checkpoint import (PARAMS_FILE, load_checkpoint, load_params,
                         save_checkpoint, save_config, save_params)
from .common import (epoch_names, on_rank0, rank_batches, rank_writer,
                     repeat_names, run_dir, val_generator)
from .config import B0TrainConfig
from .train_unet import make_optimizer

log = setup_logger("train_b0")

DEFAULT_CONFIG = dataclasses.asdict(B0TrainConfig())


def _rates(alpha):
    """A rate mixture as a list, a single rate as a float."""
    return [float(a) for a in alpha] if isinstance(alpha, (list, tuple)) \
        else float(alpha)


class B0Sampler:
    """The draws and the pure loss of one B0 step (the JAX trainer's
    ``make_pair`` and ``loss_fn``).

    ``draw(shape, generator)`` -> dict of tensors on the generator's
    device:

    - ``oi``, ``oj`` [B] int64: crop offsets (``crop`` < H);
    - ``flip_h``, ``flip_v``, ``k`` [B]: flips, then quarter turns
      (``augment``);
    - ``alphas`` [B] f32: each image's rate, drawn uniformly from a rate
      list, or the single rate;
    - ``embed``, ``bits`` [B, h, w] bool: LSBr's mask (uniform < the
      image's rate) and bits;
    - ``keep`` [2B, 1280] bool: the head dropout's mask
      (``dropout_rate``, the training step without ``freeze_bn``).

    ``loss(cover_u8, mask, draws)`` -> (masked mean cross-entropy,
    logits [2B, 2], labels [2B]): crop, flip, rot90, the stego half
    (HILLr: each image at the listed rate nearest its own), /255, the
    optional LSBr-reference plane, ImageNet-green normalisation, the model
    (in the mode it is in) on [covers; stegos].  With a ``mesh`` the batch
    is this rank's block (``shard`` takes its block of the draws) and the
    mean's count is the global batch's."""

    def __init__(self, model, stego_method: str, alpha, crop: int = None,
                 augment: bool = False, use_lsbr_reference: bool = False,
                 dropout_rate: float = 0.0, mesh=None):
        self.model = model
        self.mesh = mesh
        self.rates = _rates(alpha)
        self.lsbr = stego_method.upper().startswith("LSB")
        self.crop = crop
        self.augment = augment
        self.use_lsbr_reference = use_lsbr_reference
        self.dropout_rate = dropout_rate or 0.0

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
        if isinstance(self.rates, list):
            r = torch.tensor(self.rates, dtype=torch.float32, device=dev)
            d["alphas"] = r[torch.randint(0, len(r), (B,), generator=g,
                                          device=dev)]
        else:
            d["alphas"] = torch.full((B,), self.rates, dtype=torch.float32,
                                     device=dev)
        if self.lsbr:
            u, d["bits"] = lsbr_draws((B, h, w), g)
            d["embed"] = u < d["alphas"][:, None, None]
        if self.dropout_rate:
            d["keep"] = torch.rand((2 * B, HEAD_WIDTH), generator=g,
                                   device=dev) < 1.0 - self.dropout_rate
        return d

    def shard(self, d: dict) -> dict:
        """This rank's block of the global batch's draws: the leading
        axis of each, and of the head dropout's mask [2B, 1280] the
        rank's rows of the cover half and of the stego half."""
        out = {}
        for k, v in d.items():
            if k == "keep":
                halves = v.unflatten(0, (2, -1))
                out[k] = halves[:, self.mesh.block(halves.shape[1])].flatten(
                    0, 1)
            else:
                out[k] = v[self.mesh.block(v.shape[0])]
        return out

    def embed(self, cover_u8: torch.Tensor, d: dict) -> torch.Tensor:
        if self.lsbr:
            return lsbr_embed(cover_u8, d["embed"], d["bits"])
        if not isinstance(self.rates, list):
            return hillr_simulate(cover_u8, self.rates)
        # HILLr flips a fixed count per rate: every listed rate's stego,
        # then each image's at the rate nearest its own (as JAX selects)
        r = torch.tensor(self.rates, dtype=torch.float32,
                         device=cover_u8.device)
        idx = torch.argmin(torch.abs(r[:, None] - d["alphas"][None, :]),
                           dim=0)
        out = cover_u8
        for i, a in enumerate(self.rates):
            out = torch.where((idx == i)[:, None, None],
                              hillr_simulate(cover_u8, a), out)
        return out

    def preprocess(self, x_u8: torch.Tensor) -> torch.Tensor:
        x = x_u8.to(torch.float32)[:, None] / 255.0
        if self.use_lsbr_reference:
            x = lsbr_reference(x)
        return normalize(x, IMAGENET_GREEN_MEAN, IMAGENET_GREEN_STD)

    def pair(self, cover_u8: torch.Tensor, d: dict) -> tuple:
        """(inputs [2B, C, h, w], labels [2B]) of a cover batch."""
        x = cover_u8
        if "oi" in d:
            x = crop(x, d["oi"], d["oj"], self.crop)
        if "k" in d:
            x = rot90(flip(x, d["flip_h"], d["flip_v"]), d["k"])
        stego = self.embed(x, d)
        inputs = torch.cat([self.preprocess(x), self.preprocess(stego)])
        B = x.shape[0]
        y = torch.cat([torch.zeros(B, dtype=torch.int64, device=x.device),
                       torch.ones(B, dtype=torch.int64, device=x.device)])
        return inputs, y

    def loss(self, cover_u8: torch.Tensor, mask: torch.Tensor,
             d: dict) -> tuple:
        inputs, y = self.pair(cover_u8, d)
        logits = self.model(inputs, keep=d.get("keep"))
        ce = F.cross_entropy(logits, y, reduction="none")
        # masked mean: padded tail rows must not steer gradients or the
        # early-stopping validation loss
        w = torch.cat([mask, mask]).to(ce.dtype)
        count = torch.sum(w)
        if self.mesh is not None:
            count = self.mesh.all_reduce(count)
        loss = torch.sum(ce * w) / torch.clamp(count, min=1.0)
        return loss, logits, y


def _gather_pairs(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's [covers; stegos] rows of ``t`` in the global
    [covers; stegos] order."""
    halves = mesh.all_gather(t.unflatten(0, (2, -1)).contiguous())
    return torch.cat(halves, dim=1).flatten(0, 1)


def _make_steps(model, optimizer, scheduler, cfg: dict, mesh=None) -> tuple:
    """(train_step, eval_step), each ``(cover_u8 [B, H, W], mask [B],
    generator=None, draws=None)`` -> (loss, logits, labels) on the model's
    device.  ``train_step`` draws (unless ``draws`` is given), runs the
    model in training mode (eval mode with ``freeze_bn``), takes one AdamW
    and one scheduler step; ``eval_step`` runs it in eval mode on
    ``val_alpha`` pairs, without gradients.

    With a ``mesh`` (a ``parallel.Mesh`` with a process group) both take
    this rank's contiguous block of the global batch and its mask, make
    (or take) the global batch's draws and keep their block, and return
    the global loss, logits and labels; the model's batch norms take the
    global batch's statistics and ``train_step`` sums the gradients over
    the ranks."""
    freeze_bn = cfg.get("freeze_bn", False)
    kw = dict(crop=cfg.get("crop"), augment=cfg.get("augment", False),
              use_lsbr_reference=cfg["lsbr_reference"], mesh=mesh)
    set_batch_norm_mesh(model, mesh)
    train_sampler = B0Sampler(
        model, cfg["stego_method"], cfg["alpha"],
        dropout_rate=0.0 if freeze_bn else model.dropout.rate, **kw)
    val_sampler = B0Sampler(model, cfg["stego_method"],
                            cfg.get("val_alpha") or cfg["alpha"], **kw)

    def local(sampler, cover_u8, generator, draws):
        if mesh is None:
            return draws if draws is not None else sampler.draw(
                cover_u8.shape, generator)
        shape = (cover_u8.shape[0] * mesh.world,) + tuple(cover_u8.shape[1:])
        return sampler.shard(draws if draws is not None else
                             sampler.draw(shape, generator))

    def global_(loss, logits, y):
        if mesh is None:
            return loss, logits, y
        return (mesh.all_reduce(loss), _gather_pairs(mesh, logits),
                _gather_pairs(mesh, y))

    def train_step(cover_u8, mask, generator=None, draws=None):
        d = local(train_sampler, cover_u8, generator, draws)
        model.train(not freeze_bn)
        optimizer.zero_grad(set_to_none=True)
        loss, logits, y = train_sampler.loss(cover_u8, mask, d)
        loss.backward()
        if mesh is not None:
            mesh.sum_gradients(model)
        optimizer.step()
        scheduler.step()
        return global_(loss.detach(), logits.detach(), y)

    @torch.no_grad()
    def eval_step(cover_u8, mask, generator=None, draws=None):
        d = local(val_sampler, cover_u8, generator, draws)
        model.eval()
        return global_(*val_sampler.loss(cover_u8, mask, d))

    train_step.sampler, eval_step.sampler = train_sampler, val_sampler
    return train_step, eval_step


def check_trainable(cfg: dict) -> None:
    """Refuse what the JAX trainer cannot train: its model takes 3 input
    planes with ``grayscale=False`` and 3 more with ``demosaic_oracle``,
    while its preprocessing feeds the grayscale plane (and the LSBr
    reference) alone, so its first step fails on the stem's shape."""
    bad = [k for k, v in (("grayscale=False", not cfg["grayscale"]),
                          ("demosaic_oracle=True", cfg["demosaic_oracle"]))
           if v]
    if bad:
        raise UserError(
            f"train-b0 cannot train {' and '.join(bad)}: the model would "
            "take more input planes than the preprocessing gives (the JAX "
            "trainer fails on its first step)")


def b0_params_tree(model) -> dict:
    """The model's Flax params tree with its running statistics under
    ``batch_stats``, as ``best.npz`` holds them."""
    params, stats = flax_b0_params_from_state_dict(model.state_dict())
    return {**params, "batch_stats": stats} if stats else params


def _resume(model, resume_dir: pathlib.Path):
    """Load the parameters and running statistics of ``resume_dir``'s
    ``model/best`` (a run the port trained) or, without one, of its
    ``best.npz`` (a JAX run exported with
    ``scripts/export_torch_weights.py``)."""
    if (resume_dir / "model").exists():
        state = load_checkpoint(resume_dir, "best")["params"]
    elif (resume_dir / PARAMS_FILE).exists():
        state = b0_state_dict_from_flax(*load_params(resume_dir))
    else:
        raise FileNotFoundError(
            f"no model/best or {PARAMS_FILE} to resume from at {resume_dir}")
    model.load_state_dict(state)


def build_model(cfg: dict):
    """The seeded B0 of a validated config (Flax's initialisers, the
    config's ``stem_init``)."""
    return init_b0(get_b0(
        in_channels=1 + (1 if cfg["lsbr_reference"] else 0),
        no_stem_stride=cfg["no_stem_stride"], drop_rate=cfg["drop_rate"],
        stem_init=cfg.get("stem_init", "default"),
        quadratic_stem=cfg.get("quadratic_stem", False),
        parity_features=cfg.get("parity_features", False),
        norm=cfg.get("norm", "batch"),
        compute_dtype=getattr(torch, cfg["compute_dtype"])),
        cfg["seed"] or 0)


def _meters() -> tuple:
    """Loss, P_E, P_MD@5%FP and accuracy, in the JAX trainer's order."""
    return LossMeter(":.4e"), PEMeter(), PMD5FPMeter(), AccuracyMeter()


def _update_meters(meters, loss, logits, y, mask):
    """One step's rows (``mask`` twice: covers, then stegos): P(stego) by
    softmax, the label by argmax."""
    loss_meter, pe, pmd, acc = meters
    m = np.concatenate([mask, mask])
    loss_meter.update(float(loss), int(m.sum()))
    probs = torch.softmax(logits.float(), dim=1)[:, 1].cpu().numpy()[m]
    y_np = y.cpu().numpy()[m]
    acc.update(y_np, logits.argmax(dim=1).cpu().numpy()[m])
    pe.update(y_np, probs)
    pmd.update(y_np, probs)


def train_names(config: dict, data_path: pathlib.Path,
                tr_names: typing.Sequence[str],
                va_names: typing.Sequence[str], output_dir: pathlib.Path,
                device=None, reader: typing.Callable = imread_gray_u8
                ) -> pathlib.Path:
    """Run one B0 training experiment over the training and validation
    images ``tr_names`` / ``va_names`` under ``data_path`` (decoded with
    ``reader``) on ``device`` (None = CUDA); returns the experiment dir.
    Under a process group every rank takes its block of each batch
    (module docstring)."""
    dev = resolve_device(device)
    cfg = B0TrainConfig.validate(config)
    check_trainable(cfg)
    mesh = get_mesh()
    if cfg["batch_size"] % mesh.world:
        raise UserError(f"batch_size {cfg['batch_size']} does not divide "
                        f"over {mesh.world} ranks")
    exp_dir = run_dir(mesh, output_dir, cfg["stego_method"], dev.type, cfg)
    on_rank0(mesh, save_config, exp_dir, {**cfg, "dataset": str(data_path)})
    writer = rank_writer(mesh, exp_dir / "log")

    model = build_model(cfg)
    if cfg.get("resume"):
        resume_dir = pathlib.Path(output_dir) / cfg["stego_method"] / \
            cfg["resume"]
        _resume(model, resume_dir)
        log.info(f"resumed from {resume_dir}")
    replicate(mesh, model.to(dev))

    batch_size = cfg["batch_size"]
    steps_per_epoch = cfg.get("steps_per_epoch") or max(
        1, len(tr_names) // batch_size)
    optimizer, scheduler = make_optimizer(cfg, steps_per_epoch,
                                          model.parameters())
    train_step, eval_step = _make_steps(
        model, optimizer, scheduler, cfg,
        mesh=mesh if mesh.group is not None else None)

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
            tr = _meters()
            progress = ProgressMeter(max(1, len(names) // batch_size),
                                     list(tr), prefix=f"Epoch: [{epoch}]")
            for valid, pixels, mask in batches(names):
                _update_meters(tr, *train_step(pixels, mask, generator),
                               valid)
            log.info(progress.to_str(0))
            for m in tr:
                writer.add_scalar(f"train/{m.name}", m.avg, epoch)

            va = _meters()
            for vb, (valid, pixels, mask) in enumerate(batches(va_ep)):
                _update_meters(va, *eval_step(
                    pixels, mask, val_generator(seed, vb, dev)), valid)
            for m in va:
                writer.add_scalar(f"val/{m.name}", m.avg, epoch)
            va_loss, va_pe, _, va_acc = va
            log.info(f"epoch {epoch}: val loss {va_loss.avg:.5f} "
                     f"p_e {va_pe.avg:.3f} acc {va_acc.avg:.3f}")

            val_loss = (va_pe.avg if cfg.get("select_metric") == "p_e"
                        else va_loss.avg)
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
                on_rank0(mesh, save_params, exp_dir, b0_params_tree(model))
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
    """Run one B0 training experiment over the ``tr_csv`` / ``va_csv``
    splits of the catalog at ``data_path``; returns the experiment dir."""
    from ..data.catalog import precovers

    resolve_device(device)
    cfg = B0TrainConfig.validate(config)
    tr = list(precovers(data_path, split=cfg["tr_csv"])["name"])
    va = list(precovers(data_path, split=cfg["va_csv"])["name"])
    return train_names(config, data_path, tr, va, output_dir, device=device)
