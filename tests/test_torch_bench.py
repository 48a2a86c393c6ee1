"""Port parity of the benchmark (``wsunet_tpu_torch.bench`` and
``python -m wsunet_tpu_torch bench``) against ``wsunet_tpu/bench.py``, on
the CPU, small.

- The headline step (``bench.make_step`` on ``bench.build_model``) on
  JAX's seed-0 ``unet_2`` parameters, carried across with
  ``unet_state_dict_from_flax``, against JAX's bench step (f32, B=2,
  128x128) on each conv route: beta_hat within 1e-5 and l1 within rel
  1e-4, the U-Net bounds of ``tests/test_torch_runs.py``.
- ``flops_per_image`` (``bench.unet_flops``, 2 x the layer shapes'
  multiply-accumulates) against XLA's cost analysis of JAX's pure-XLA
  step at 128x128 (``wsunet_tpu.bench._cost_flops``), within 2%; measured
  gap: XLA counts 0.07% more in f32 and 0.6% more in bf16 (its
  elementwise work and casts).
- ``run_bench(device="cpu")`` with the side patched to 64, the route
  variable, the decode sections over ``data_ablation/p128`` (the port's
  reader, with PIL and the native loader beside it where they load), the
  device rule and the subcommand.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_p128 import P128
from wsunet_tpu.bench import _cost_flops
from wsunet_tpu.cli import build_parser as jax_parser
from wsunet_tpu.models.unet import UNet as JaxUNet
from wsunet_tpu.ops import ws_estimate_unet as jax_ws_estimate_unet
from wsunet_tpu.ws.unet_eval import infer_unet as jax_infer_unet
from wsunet_tpu_torch import bench
from wsunet_tpu_torch.cli import build_parser
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.data import pipeline
from wsunet_tpu_torch.models import get_model, unet_state_dict_from_flax
from wsunet_tpu_torch.utils.errors import UserError

SIDE, BATCH = 128, 2
# the U-Net bounds of tests/test_torch_runs.py: f32 conv sums in another
# order
BETA_ATOL, L1_RTOL = 1e-5, 1e-4
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
                 "device", "flops_per_image", "tflops_per_sec", "fast_conv",
                 "b1_launches_per_step", "decode_only"}
CARD_KEYS = {"mfu", "peak_memory_gib", "step_ms", "floor_value",
             "floor_mfu", "floor_ok", "latency_ms_b1", "rtt_floor_ms",
             "latency_ms_b1_net", "serial_images_per_sec",
             "streamed_images_per_sec", "stream_speedup", "ws_fused",
             "e2e_decode"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype):
    precision = (jax.lax.Precision.DEFAULT if dtype == jnp.bfloat16
                 else jax.lax.Precision.HIGHEST)
    return JaxUNet(nsteps=2, compute_dtype=dtype, precision=precision,
                   fast_conv=False)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's bench step (``wsunet_tpu/bench.py:348-353``) in f32 on its
    seed-0 parameters, on seeded uint8 pixels."""
    model = _jax_model(jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIDE, SIDE, 1)))

    @jax.jit
    def step(pixels_u8):
        x = pixels_u8.astype(jnp.float32)
        x_hat = jax_infer_unet(model, variables, x)
        return jax_ws_estimate_unet(x, x_hat)

    pixels = np.random.default_rng(0).integers(
        0, 256, (BATCH, SIDE, SIDE)).astype(np.uint8)
    beta, l1 = step(jnp.asarray(pixels))
    params = jax.tree.map(np.asarray, variables["params"])
    return pixels, params, np.asarray(beta), np.asarray(l1)


@pytest.mark.parametrize("fast_conv", [False, "borderfix", True])
def test_headline_step_matches_jax_bench_step(jax_run, fast_conv):
    pixels, params, beta_want, l1_want = jax_run
    model = bench.build_model(torch.float32, fast_conv, "cpu")
    model.load_state_dict(unet_state_dict_from_flax(params))
    beta, l1 = bench.make_step(model, "cpu")(torch.from_numpy(pixels))
    assert beta.shape == (BATCH,) and l1.shape == (BATCH,)
    np.testing.assert_allclose(beta.numpy(), beta_want, rtol=0,
                               atol=BETA_ATOL)
    np.testing.assert_allclose(l1.numpy(), l1_want, rtol=L1_RTOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flops_per_image_matches_xla_cost_analysis(dtype):
    """JAX's ``ref_step`` (``wsunet_tpu/bench.py:359-371``) at 128x128."""
    model = _jax_model(dtype)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, SIDE, SIDE, 1)))

    def ref_step(pixels_u8):
        x = pixels_u8.astype(jnp.float32)
        return jax_ws_estimate_unet(x, jax_infer_unet(model, variables, x))

    pixels = jnp.zeros((BATCH, SIDE, SIDE), jnp.uint8)
    xla = _cost_flops(jax.jit(ref_step).lower(pixels).compile()) / BATCH
    assert xla > 0
    ours = bench.unet_flops(SIDE)
    assert abs(ours - xla) <= 0.02 * xla, (ours, xla)


def test_unet_flops_at_512_is_two_macs_a_parameter_pixel():
    """202.2 GFLOP an image at 512x512, a quarter of that at 256x256."""
    assert bench.unet_flops(512) == 202_199_007_232
    assert bench.unet_flops(512) == 4 * bench.unet_flops(256)


@pytest.mark.parametrize("mode, route", [("1", True),
                                         ("borderfix", "borderfix"),
                                         ("0", False), (None, True)])
def test_route_variable_names_the_conv_route(monkeypatch, mode, route):
    if mode is None:
        monkeypatch.delenv("WSUNET_BENCH_FAST_CONV", raising=False)
    else:
        monkeypatch.setenv("WSUNET_BENCH_FAST_CONV", mode)
    assert bench.conv_route() is route


@pytest.mark.parametrize("mode", ["2", "true", "", "BORDERFIX"])
def test_any_other_route_raises(monkeypatch, mode):
    monkeypatch.setenv("WSUNET_BENCH_FAST_CONV", mode)
    with pytest.raises(UserError, match="WSUNET_BENCH_FAST_CONV"):
        bench.conv_route()
    with pytest.raises(UserError, match="WSUNET_BENCH_FAST_CONV"):
        bench.run_bench(device="cpu")


@pytest.mark.parametrize("mode, route", [("1", True), ("0", False)])
def test_run_bench_on_cpu(monkeypatch, mode, route):
    monkeypatch.setattr(bench, "SIDE", 64)
    monkeypatch.setenv("WSUNET_BENCH_FAST_CONV", mode)
    out = bench.run_bench(dtype="float32", device="cpu", root=P128)
    assert set(out) == HEADLINE_KEYS and not set(out) & CARD_KEYS
    assert out["fast_conv"] is route
    assert out["platform"] == "cpu" and out["device"] == "cpu"
    # JAX's smallest honest sizes off the accelerator
    assert out["metric"].endswith("(unet_2, 64x64, float32, batch 2)")
    assert out["flops_per_image"] == bench.unet_flops(64) / 1e9
    assert out["value"] > 0 and out["tflops_per_sec"] > 0
    # the plain version of B1 on the CPU: no launch
    assert out["b1_launches_per_step"] == 0
    assert out["decode_only"]["images"] == 64
    json.dumps(out)


def test_run_bench_rejects_another_dtype():
    with pytest.raises(UserError, match="float16"):
        bench.run_bench(dtype="float16", device="cpu")


def test_decode_only_over_p128():
    """``io.png`` at 1 and 2 threads, with PIL's and the native loader's
    rates beside it (both load here)."""
    out = bench._bench_decode_only(root=P128, repeats=2, threads=2)
    assert out["reader"] == "io.png" and out["images"] == 64
    assert out["threads"] == 2
    for key in ("decode_ms_per_img", "decode_ms_per_img_threads",
                "pil_ms_per_img", "native_ms_per_img",
                "native_ms_per_img_threads"):
        assert out[key] > 0, key
    assert out["speedup_vs_pil"] == \
        out["pil_ms_per_img"] / out["decode_ms_per_img"]
    assert out["floor_ok"] == (out["speedup_vs_pil"] >= 2.0)
    assert "pil" not in out and "native" not in out


def test_e2e_decode_over_p128():
    model = get_model("unet_0").eval()
    out = bench._bench_e2e_decode(model, root=P128, device="cpu",
                                  batch_size=16, repeats=2)
    assert out["images"] == 128 and out["sweep_passes"] == 2
    for key in ("png", "pil", "native", "sweep"):
        assert out[f"{key}_images_per_sec"] > 0
    # the section restores the default decoder (io.png) and its caches
    assert pipeline._FORCE_NATIVE is False and not pipeline._DECODE_CACHE


@pytest.mark.parametrize("missing", ["PIL", "pandas"])
def test_a_missing_package_makes_a_section_unavailable(monkeypatch,
                                                       missing):
    """Without PIL only PIL's comparison is unavailable; the port's
    reader, the native loader and the sweeps need neither PIL nor
    pandas."""
    monkeypatch.setitem(sys.modules, missing, None)
    model = get_model("unet_0").eval()
    e2e = bench._bench_e2e_decode(model, root=P128, device="cpu",
                                  batch_size=16, repeats=1)
    only = bench._bench_decode_only(root=P128, repeats=1, threads=2)
    for out, key in ((e2e, "png_images_per_sec"),
                     (only, "decode_ms_per_img")):
        assert out[key] > 0
        if missing == "PIL":
            assert missing in out["pil"]["unavailable"]
            assert not any(k.startswith("pil_") for k in out)
        else:
            assert "pil" not in out
    assert ("floor_ok" in only) == (missing != "PIL")


def test_a_missing_decoder_makes_both_sections_unavailable(monkeypatch):
    """Where the native loader does not build, its comparison alone is
    ``unavailable`` in both sections; the port's reader runs."""
    from wsunet_tpu_torch.io import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error",
                        lambda: "fatal error: libdeflate.h: No such file")
    model = get_model("unet_0").eval()
    for out in (bench._bench_decode_only(root=P128, repeats=1, threads=2),
                bench._bench_e2e_decode(model, root=P128, device="cpu",
                                        batch_size=16, repeats=1)):
        assert out["native"]["unavailable"].startswith(
            "native PNG decoder (fatal error: libdeflate.h")
        assert not any(k.startswith("native_") for k in out)
        assert out.get("decode_ms_per_img", 0) > 0 or \
            out["png_images_per_sec"] > 0


def test_any_other_decode_failure_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        bench._bench_decode_only(root=tmp_path)
    with pytest.raises(FileNotFoundError):
        bench._bench_e2e_decode(get_model("unet_0").eval(), root=tmp_path,
                                device="cpu")
    # a cover that does not decode: the section raises, it does not skip it
    (tmp_path / "images").mkdir()
    (tmp_path / "images" / "a.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        bench._bench_decode_only(root=tmp_path, repeats=1)


def test_run_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UserError, match="CUDA is not available"):
        bench.run_bench()
    with pytest.raises(SystemExit) as e:
        torch_main(["bench"])
    msg = str(e.value)
    assert msg.startswith("bench: CUDA is not available") and "\n" not in msg
    with pytest.raises(SystemExit, match="^bench: CUDA is not available"):
        bench.main()


def test_bench_subcommand_parses_jax_flags():
    sub = next(a for a in build_parser()._actions
               if a.dest == "command")
    assert "bench" in sub.choices
    argv = ["bench", "--dtype", "float32", "--iters", "3", "--batch-size",
            "4"]
    ours, theirs = build_parser().parse_args(argv), \
        jax_parser().parse_args(argv)
    for key in ("command", "dtype", "iters", "batch_size"):
        assert getattr(ours, key) == getattr(theirs, key)
    # the defaults are the JAX CLI's: bf16, 20 iterations, --batch-size 8
    ours, theirs = build_parser().parse_args(["bench"]), \
        jax_parser().parse_args(["bench"])
    assert (ours.dtype, ours.iters, ours.batch_size) == \
        (theirs.dtype, theirs.iters, theirs.batch_size) == \
        ("bfloat16", 20, 8)
    assert ours.data is None and ours.device is None


def test_bench_subcommand_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SIDE", 64)
    monkeypatch.delenv("WSUNET_BENCH_FAST_CONV", raising=False)
    assert torch_main(["bench", "--device", "cpu", "--dtype", "float32",
                       "--data", str(P128)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == HEADLINE_KEYS and out["fast_conv"] is True


@pytest.mark.parametrize("flag", [["--fast-conv"], ["--take", "2"]])
def test_bench_subcommand_refuses_flags_it_does_not_use(flag):
    with pytest.raises(SystemExit, match="^bench"):
        torch_main(["bench", "--device", "cpu", *flag])
