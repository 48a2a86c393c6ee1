"""The plain references against the port at small sizes on the CPU, on
the committed weights, with the same inputs and draws."""

import pathlib

import numpy as np
import pytest
import torch

from port_bench.drivers import train_step as train_driver
from port_bench.harness import cells, images, weights
from port_bench.reference import b0 as ref_b0
from port_bench.reference import train as ref_train
from port_bench.reference import unet as ref_unet

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _weights(config):
    c = cells.load_json(ROOT / "port_bench" / "configs" / f"{config}.json")
    return c, weights.state_dict(ROOT / c["weights"])


def _pixels(n, side, seed=7):
    covers = [images.cover(seed, i, side) for i in range(n)]
    return np.stack(covers + [images.lsbr(c, 0.4, seed, i)
                              for i, c in enumerate(covers)])


@pytest.mark.parametrize("fast_conv", [True, False])
def test_unet_sweep_step(fast_conv):
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.ws.unet_eval import predict_batch

    _, sd = _weights("unet_2")
    model = get_model("unet_2", fast_conv=fast_conv)
    model.load_state_dict(sd)
    px = _pixels(2, 48)
    beta, l1 = predict_batch(model.eval(), px, device="cpu")
    rb, rl = ref_unet.ws_predict(sd, px, "cpu")
    np.testing.assert_allclose(beta.numpy(), rb, rtol=0, atol=2e-5)
    np.testing.assert_allclose(l1.numpy(), rl, rtol=1e-5, atol=0)


def test_b0_step():
    from wsunet_tpu_torch.detect.b0_eval import infer_b0
    from wsunet_tpu_torch.models import get_b0

    c, sd = _weights("efficientnet_b0_nostride")
    model = get_b0(in_channels=2, no_stem_stride=True, quadratic_stem=True)
    model.load_state_dict(sd)
    px = _pixels(2, 64)
    p = infer_b0(model.eval(), px, use_lsbr_reference=True,
                 device="cpu").double().numpy()
    r = ref_b0.p_stego(sd, px, "cpu", c)
    np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-7)
    with torch.no_grad():
        x = torch.as_tensor(px)[:, None].float() / 255.0
        planes = torch.cat([x, (torch.round(x * 255) // 2 * 2) / 255.0], 1)
        planes = (planes - 0.456) / 0.224
        np.testing.assert_allclose(model(planes).numpy(),
                                   ref_b0.logits(sd, planes, c).numpy(),
                                   rtol=1e-4, atol=1e-3)


def test_training_step_with_the_same_draws():
    """Three steps of the port's ``train_step`` against the reference from
    the committed weights, on the same covers and draws."""
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.train import losses, train_unet

    _, sd = _weights("unet_2")
    t = dict(cells.load_json(ROOT / "port_bench" / "traffic"
                             / "train-lsbr-b4.json"), crop=32, side=32)
    model = get_model("unet_2")
    model.load_state_dict(sd)
    opt, sched = train_unet.make_optimizer(
        {"learning_rate": t["learning_rate"], "lr_schedule": "cosine",
         "num_epochs": t["num_epochs"]}, t["steps_per_epoch"],
        model.parameters())
    step, _ = train_unet._make_step(
        model, losses.get_loss("l1ws", per_image=True, loss_lambda=0.25),
        opt, sched, "LSBR", 0.4, crop=32, augment=True)
    gen = torch.Generator().manual_seed(3)
    covers = _pixels(6, 32)[:12].reshape(3, 4, 32, 32)
    checked, program = [], {"losses": []}
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for i in range(3):
        d = train_driver.make_draws(t, gen)
        checked.append((covers[i], d))
        program["losses"].append(float(step(
            torch.from_numpy(covers[i]), torch.ones(4, dtype=torch.bool),
            draws=d)))
        if i == 0:
            program["grad_norms"] = train_driver._norms(
                {k: opt.state[p]["exp_avg"] / 0.1
                 for k, p in model.named_parameters()})
    program["change_norms"] = train_driver._norms(
        {k: p.detach() - start[k] for k, p in model.named_parameters()})
    ref = train_driver.reference_run(sd, checked, t, "cpu")
    gaps = train_driver.compare(program, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    assert ref_train.schedule(0, 2e-5, 60, 25) == 0.0
    assert ref_train.schedule(1, 2e-5, 60, 25) == pytest.approx(2e-5 / 75)
