"""Typed training configurations (port of ``wsunet_tpu/train/config.py``,
unchanged).

One typed dataclass per trainer is the single source of truth: the
CLI's ``--config '<json>'`` overrides are validated against it (unknown
keys and wrong types fail fast instead of being silently ignored), the
trainers consume it as a plain dict, and the same dict is dumped beside
the checkpoints for the eval-time registry.
"""

import dataclasses
import typing


def _validate(cls, overrides: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(overrides) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys: {sorted(unknown)}; "
            f"valid keys: {sorted(names)}")
    cfg = cls(**overrides)
    return dataclasses.asdict(cfg)


@dataclasses.dataclass
class UNetTrainConfig:
    """U-Net predictor training (wsunet_tpu_torch.train.train_unet)."""

    network: str = "unet_2"
    crop: typing.Optional[int] = None
    augment: bool = False
    cover_fraction: float = 0.5
    steps_per_epoch: typing.Optional[int] = None
    stego_method: typing.Optional[str] = "LSBR"
    alpha: typing.Optional[float] = 0.4
    loss: str = "l1ws"
    loss_lambda: float = 0.25
    # False keeps the reference's live unweighted L1+WS sum
    # (losses.py:114-115); True applies the anchor checkpoints' recorded
    # lambda form 2*(lambda*L1+(1-lambda)*WS) (losses.py:117, commented
    # but encoded in every shipped config.json/run name)
    weighted_loss: bool = False
    learning_rate: float = 1e-4
    lr_schedule: typing.Optional[str] = None   # None | "cosine"
    select_metric: str = "loss"                # "loss" | "ws" | "last"
    # repeat the (possibly single-cover) val catalog so the selection
    # metric averages many deterministic crop/embedding draws — with one
    # val image and one fixed key the cover/stego Bernoulli never varies
    # and a "ws"-selected run can pin its best checkpoint at epoch 0
    val_steps: typing.Optional[int] = None
    batch_size: int = 8
    num_epochs: int = 50
    patience: int = 10
    grayscale: bool = True
    drop_rate: typing.Optional[float] = None
    disable_center: bool = False
    seed: int = 12345
    shape: tuple = (512, 512)
    tr_csv: str = "split_tr.csv"
    va_csv: str = "split_va.csv"
    resume: typing.Optional[str] = None
    debug: bool = False
    compute_dtype: str = "float32"

    @classmethod
    def validate(cls, overrides: dict) -> dict:
        return _validate(cls, overrides)


@dataclasses.dataclass
class B0TrainConfig:
    """EfficientNet-B0 detector training
    (wsunet_tpu_torch.train.train_b0)."""

    network: str = "b0"
    crop: typing.Optional[int] = None
    augment: bool = False
    steps_per_epoch: typing.Optional[int] = None
    stego_method: str = "LSBR"
    alpha: typing.Any = 0.01            # float or list (rate mixture)
    loss: str = "crossentropy"
    learning_rate: float = 1e-4
    lr_schedule: typing.Optional[str] = None
    select_metric: str = "loss"         # "loss" | "p_e" | "last"
    val_alpha: typing.Any = None        # rate(s) for validation pairs
    val_steps: typing.Optional[int] = None
    batch_size: int = 8
    num_epochs: int = 50
    patience: int = 5
    grayscale: bool = True
    drop_rate: float = 0.2
    no_stem_stride: bool = False
    lsbr_reference: bool = False
    stem_init: str = "default"          # "default" | "highpass"
    quadratic_stem: bool = False        # products of stem-feature pairs
    parity_features: bool = False       # append cos(pi x) parity channel
    norm: str = "batch"                 # "batch" | "group" (models/b0.py)
    freeze_bn: bool = False             # train against frozen BN stats
    demosaic_oracle: bool = False
    seed: int = 12345
    shape: tuple = (512, 512)
    tr_csv: str = "split_tr.csv"
    va_csv: str = "split_va.csv"
    resume: typing.Optional[str] = None
    debug: bool = False
    compute_dtype: str = "bfloat16"

    @classmethod
    def validate(cls, overrides: dict) -> dict:
        return _validate(cls, overrides)
