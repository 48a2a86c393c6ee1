"""Port parity: the rank-parallel runtime (wsunet_tpu_torch.parallel, on
torch.distributed) against the JAX package's ``parallel`` on its 8-device
CPU mesh (tests/conftest.py), on the CPU.

Two ranks are two gloo processes of this file (its ``__main__`` body),
which rendezvous through a file store; each runs every case once and
pickles what it got for the tests below.  A world of one runs in this
process under a one-rank file-store group.  The JAX side runs here while
the two ranks run.

Cases and tolerances:
- ``ws_attack_spatial`` (KB, weighted 0, 1, -1, uint8 [2, 128, 128]) at
  one and two ranks against JAX's on 8 devices and against the port's
  ``ws_attack``: rtol 1e-4, atol 1e-6 (tests/test_multichip.py's bound);
- ``infer_unet_spatial`` (``unet_2`` on JAX-initialised weights carried
  across, [2, 128, 128]) at one and two ranks against JAX's on 8 devices
  at rtol 1e-4 / atol 1e-3 (tests/test_multichip.py), and against the
  port's ``infer_unet`` bit for bit; rows that do not divide and
  ``fast_conv=True`` raise ``UserError``;
- the rank-sharded sweeps (``ws.estimate.run`` KB, KB-w, OLS;
  ``ws.unet_eval.run``; ``detect.b0_eval.run``) over 8 p128 covers and
  their LSBr stego at alpha 0.1 (the port's ``simulate``), one stego file
  corrupt: every rank's frame equals the one-process frame bit for bit
  (B0's P(stego) at rtol 1e-6: on the CPU B0 is not invariant to an
  image's place in its batch, ``B0_SHARD_RTOL``);
  the one-process frame is held to JAX's 8-device one at the bounds of
  tests/test_torch_runs.py, test_torch_ols.py and test_torch_b0_runs.py;
- ``host_shard`` / ``allgather_rows`` on 7 rows: exact;
- the trainers' batches (``train.common.rank_batches``, 6 names in
  batches of 4, one corrupt): each rank's block equals the one-process
  batch's block, exactly;
- one ``train_unet`` step on the golden draws (B=4, crop 64, two ranks
  of 2): loss rel 1e-6 and gradients (max|d| / max|g|) 1e-5 of the
  one-rank step, and JAX's golden step at 1e-3;
- one B0 live step (``freeze_bn`` off) in float64 at two ranks of one
  pair: loss, logits and gradients within 1e-6 of the one-rank float64
  step and of JAX's float64 golden step; the running statistics equal
  on both ranks and within rtol 1e-6 of JAX's;
- the B0 step in f32, live and in the committed recipe (``freeze_bn``),
  at two ranks: loss rel, logits and gradients (of the largest) within
  1e-3 of the one-rank f32 step, and loss, logits and JAX's full
  gradients within 1e-3 of JAX's f32 golden step; the running
  statistics equal on both ranks;
- rank 0 alone writes a training run, which ``load_pretrained_unet`` /
  ``load_pretrained_b0`` read back.
"""

import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
P128 = REPO / "data_ablation" / "p128"
GOLDEN = REPO / "weights" / "golden"
UNET_WEIGHTS = REPO / "weights" / "unet"
B0_WEIGHTS = REPO / "weights" / "b0"
LSBR_RUN = UNET_WEIGHTS / "LSBR" / \
    "260819071329-tpu-unet_2-alpha_0.4_grayscale_l1ws_0.25_lr_2e-05_"
KB = np.array([[-1, 2, -1], [2, 0, 2], [-1, 2, -1]], dtype="float32") / 4.0
WEIGHTED = (0, 1, -1)
SWEEP_BATCH = 3
# a hung rank fails its test instead of the suite's clock
TIMEOUT = 120


# --- the cases, run by each rank (and some by this process) -------------

def spatial_inputs():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (2, 128, 128), dtype=np.uint8)


def case_spatial(job: pathlib.Path) -> dict:
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.parallel.spatial import (infer_unet_spatial,
                                                   ws_attack_spatial)
    from wsunet_tpu_torch.utils.errors import UserError

    x = spatial_inputs()
    out = {f"beta/{w}": ws_attack_spatial(torch.from_numpy(x), KB,
                                          weighted=w).numpy()
           for w in WEIGHTED}
    model = get_model("unet_2")
    model.load_state_dict(torch.load(job / "unet_2.pt"))
    model.eval()
    out["unet"] = infer_unet_spatial(model, x.astype("float32")).numpy()
    refused = []
    for bad in (lambda: infer_unet_spatial(
                    model, np.zeros((1, 130, 64), "float32")),
                lambda: infer_unet_spatial(
                    get_model("unet_2", fast_conv=True), x[:1]),
                lambda: ws_attack_spatial(torch.zeros(1, 129, 8,
                                                      dtype=torch.uint8),
                                          KB)):
        try:
            bad()
        except UserError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def case_sweeps(job: pathlib.Path) -> dict:
    import pandas as pd

    from wsunet_tpu_torch.detect import b0_run
    from wsunet_tpu_torch.parallel import set_eval_devices
    from wsunet_tpu_torch.ws import unet_run, ws_run

    cat = job / "cat"

    def frames():
        ws = pd.concat(
            [ws_run(cat, "LSBR", 0.1, m, batch_size=SWEEP_BATCH,
                    device="cpu") for m in ("KB", "KB-w", "OLS")] +
            [ws_run(cat, None, None, "KB", batch_size=SWEEP_BATCH,
                    device="cpu")]).reset_index(drop=True)
        return {"ws": ws,
                "unet": unet_run(cat, UNET_WEIGHTS, "LSBR",
                                 batch_size=SWEEP_BATCH, device="cpu"),
                "b0": b0_run(cat, B0_WEIGHTS, "LSBR",
                             batch_size=SWEEP_BATCH, device="cpu")}

    set_eval_devices(1)
    try:
        single = frames()
    finally:
        set_eval_devices(None)
    return {"single": single, "sharded": frames()}


def batch_names(job: pathlib.Path) -> list:
    """Six names of the catalog, the fifth the corrupt stego file: in
    batches of 4 the last batch holds it, one cover and two rows of
    padding, so rank 1's block of that batch has no decodable image."""
    covers = sorted(f"images/{p.name}" for p in (job / "cat" / "images")
                    .glob("*.png"))
    stego = f"stego_LSBr_alpha_0.1_independent_images/" \
        f"{covers[5][len('images/'):]}"
    return covers[:4] + [stego, covers[4]]


def case_batches(job: pathlib.Path) -> list:
    """``train.common.rank_batches`` over ``batch_names`` in batches of
    4: (global mask, pixels, mask) of each batch this rank feeds."""
    from wsunet_tpu_torch.io.imread import imread_gray_u8
    from wsunet_tpu_torch.parallel import get_mesh
    from wsunet_tpu_torch.train.common import rank_batches

    return [(valid, pixels.numpy(), mask.numpy()) for valid, pixels, mask
            in rank_batches(get_mesh(), job / "cat", batch_names(job), 4,
                            imread_gray_u8, torch.device("cpu"))]


def case_rows(job: pathlib.Path) -> dict:
    from wsunet_tpu_torch.parallel import allgather_rows, host_shard

    names = [f"n{i}" for i in range(7)]
    local, n_true = host_shard(names)
    vals = np.array([[np.pi * int(n[1:]), 1 / (1 + int(n[1:]))]
                     for n in local])[:n_true]
    return {"local": local, "n_true": n_true,
            "rows": allgather_rows(vals, len(names)),
            "col": allgather_rows(vals[:, 0].astype("float32"), 7)}


def _block(mesh, a: np.ndarray) -> torch.Tensor:
    """This rank's block of a batch (the whole batch without a mesh)."""
    t = torch.from_numpy(a)
    return t if mesh is None else t[mesh.block(len(t))]


def _flat_grads(model, flax_of) -> dict:
    from wsunet_tpu_torch.train.checkpoint import flatten_tree
    return flatten_tree(flax_of({k: p.grad
                                 for k, p in model.named_parameters()}))


def unet_golden_step(mesh=None) -> dict:
    """One AdamW step of the committed LSBR recipe on JAX's golden draws:
    (loss, gradients)."""
    from wsunet_tpu_torch.models import (flax_params_from_unet_state_dict,
                                         get_model, unet_state_dict_from_flax)
    from wsunet_tpu_torch.train import get_loss, load_params
    from wsunet_tpu_torch.train import train_unet as ttrain

    z = np.load(GOLDEN / "p128_train_step.npz")
    cfg = json.loads(str(z["config"]))
    model = get_model(cfg["network"])
    model.load_state_dict(unet_state_dict_from_flax(load_params(LSBR_RUN)[0]))
    fn = get_loss(cfg["loss"], per_image=True,
                  loss_lambda=cfg["loss_lambda"])
    opt, sch = ttrain.make_optimizer(cfg, cfg["steps_per_epoch"],
                                     model.parameters())
    step = ttrain._make_step(model, fn, opt, sch, cfg["stego_method"],
                             cfg["alpha"], crop=cfg["crop"],
                             augment=cfg["augment"],
                             cover_fraction=cfg["cover_fraction"],
                             mesh=mesh)[0]
    p = "draws/0/"
    draws = {k[len(p):]: torch.from_numpy(z[k]).long()
             if z[k].dtype.kind == "i" else torch.from_numpy(z[k])
             for k in z.files if k.startswith(p)}
    loss = step(_block(mesh, z["pixels"][0]), _block(mesh, z["mask"][0]),
                draws=draws)
    return {"loss": float(loss),
            "grad": _flat_grads(model, flax_params_from_unet_state_dict)}


def b0_step(mesh=None, live: bool = True,
            dtype: torch.dtype = torch.float64) -> dict:
    """One B0 step on JAX's golden draws: the committed recipe
    (``freeze_bn``, its first step) or, with ``live``, the step with
    ``freeze_bn`` off (its last pixels and ``live/`` draws), the model in
    ``dtype``; in float64 the pixels go through the table of JAX's jitted
    preprocessing, as JAX's float64 step fed its model: (loss, logits,
    labels, gradients, running statistics)."""
    from wsunet_tpu_torch.models import (b0_state_dict_from_flax,
                                         flax_b0_params_from_state_dict)
    from wsunet_tpu_torch.train import load_params
    from wsunet_tpu_torch.train import train_b0 as ttrain
    from wsunet_tpu_torch.train.checkpoint import flatten_tree
    from wsunet_tpu_torch.train.train_unet import make_optimizer

    z = np.load(GOLDEN / "p128_b0_train_step.npz")
    cfg = {**ttrain.B0TrainConfig.validate(json.loads(str(z["config"]))),
           "freeze_bn": not live}
    model = ttrain.build_model(cfg)
    model.load_state_dict(b0_state_dict_from_flax(*load_params(
        B0_WEIGHTS / "LSBR" / str(z["run"]))))
    model = model.to(dtype)
    model.compute_dtype = dtype
    opt, sch = make_optimizer(cfg, cfg["steps_per_epoch"],
                              model.parameters())
    step = ttrain._make_steps(model, opt, sch, cfg, mesh=mesh)[0]
    if dtype == torch.float64:
        lut = torch.from_numpy(z["live/preprocess_lut"])
        step.sampler.preprocess = lambda x_u8: lut[x_u8.long()][:, None]
    p, i = ("live/draws/", -1) if live else ("draws/0/", 0)
    draws = {k[len(p):]: torch.from_numpy(z[k]).long()
             if z[k].dtype.kind == "i" else torch.from_numpy(z[k])
             for k in z.files if k.startswith(p)}
    loss, logits, y = step(_block(mesh, z["pixels"][i]),
                           _block(mesh, z["mask"][i]), draws=draws)
    params, stats = flax_b0_params_from_state_dict(model.state_dict())
    return {"loss": float(loss), "logits": logits.double().numpy(),
            "labels": y.numpy(),
            "grad": flatten_tree(flax_b0_params_from_state_dict(
                {k: p.grad for k, p in model.named_parameters()})[0]),
            "stats": flatten_tree(stats)}


# the B0 steps each rank runs: (live, dtype)
B0_STEPS = {"b0": (True, torch.float64), "b0_live32": (True, torch.float32),
            "b0_recipe32": (False, torch.float32)}


def case_steps(job: pathlib.Path) -> dict:
    from wsunet_tpu_torch.parallel import get_mesh
    mesh = get_mesh()
    return {"unet": unet_golden_step(mesh),
            **{k: b0_step(mesh, *v) for k, v in B0_STEPS.items()}}


def case_runs(job: pathlib.Path) -> dict:
    from wsunet_tpu_torch.train import train_b0, train_unet
    from wsunet_tpu_torch.utils.errors import UserError

    names = sorted(f"images/{p.name}" for p in (P128 / "images").glob(
        "*.png"))
    unet = train_unet.train_names(
        {"network": "unet_1", "crop": 32, "batch_size": 4,
         "steps_per_epoch": 2, "num_epochs": 1, "val_steps": 1},
        P128, names[:8], names[8:12], job / "runs_unet", device="cpu")
    b0 = train_b0.train_names(
        {"crop": 64, "batch_size": 2, "steps_per_epoch": 1,
         "num_epochs": 1, "val_steps": 1, "alpha": [0.1, 0.05],
         "compute_dtype": "float32"},
        P128, names[:4], names[4:6], job / "runs_b0", device="cpu")
    try:
        train_unet.train_names({"network": "unet_1", "batch_size": 3}, P128,
                               names[:3], names[3:6], job / "runs_odd",
                               device="cpu")
        refused = ""
    except UserError as e:
        refused = str(e)
    return {"unet": str(unet), "b0": str(b0), "refused": refused}


def case_cli(job: pathlib.Path) -> dict:
    """``unet-eval`` through the CLI inside the ranks' group: each rank
    sweeps its rows, rank 0 alone writes the CSV."""
    from wsunet_tpu_torch.cli import main as torch_main

    out = job / "cli"
    torch_main(["unet-eval", "--device", "cpu", "--data", str(job / "cat"),
                "--results", str(out), "--model-dir", str(UNET_WEIGHTS),
                "--batch-size", str(SWEEP_BATCH)])
    return {"csv": str(out / "estimation" / "ws_LSBR.csv")}


CASES = {"spatial": case_spatial, "sweeps": case_sweeps, "rows": case_rows,
         "batches": case_batches, "steps": case_steps, "runs": case_runs,
         "cli": case_cli}


def rank_main(rank: int, world: int, job: pathlib.Path) -> None:
    """One rank of the two-rank run: every case, pickled to
    ``<job>/rank<rank>.pkl``."""
    import torch.distributed as dist

    from wsunet_tpu_torch.parallel.distributed import distributed_init

    torch.set_num_threads(2)
    # TensorBoard writes the runs' event files without TensorFlow, whose
    # import alone takes about 15 s here
    sys.modules.setdefault("tensorflow", None)
    distributed_init(init_method=f"file://{job / 'rdzv'}", world_size=world,
                     rank=rank, device="cpu")
    try:
        out = {name: case(job) for name, case in CASES.items()}
    finally:
        dist.destroy_process_group()
    with open(job / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
    sys.exit(0)


# --- the tests (pytest imports the module; the ranks stop above) --------

@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as each rank runs with (the suite runs six
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_unet_2_variables() -> dict:
    import jax
    import jax.numpy as jnp
    from wsunet_tpu.models.unet import UNet as JaxUNet

    return jax.jit(JaxUNet(nsteps=2).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1), jnp.float32))


@pytest.fixture(scope="module")
def job(tmp_path_factory) -> pathlib.Path:
    """The two ranks' inputs: a catalog of 8 p128 covers with the port's
    LSBr stego at alpha 0.1, one stego file corrupt, and ``unet_2`` with
    JAX's initial parameters carried across."""
    import jax

    from wsunet_tpu_torch.cli import main as torch_main
    from wsunet_tpu_torch.models import unet_state_dict_from_flax

    job = tmp_path_factory.mktemp("parallel")
    cat = job / "cat"
    (cat / "images").mkdir(parents=True)
    names = sorted(p.name for p in (P128 / "images").glob("*.png"))[:8]
    lines = ["name,height,width"]
    for name in names:
        shutil.copyfile(P128 / "images" / name, cat / "images" / name)
        lines.append(f"images/{name},128,128")
    (cat / "images" / "files.csv").write_text("\n".join(lines) + "\n")
    torch_main(["simulate", "--device", "cpu", "--data", str(cat),
                "--method", "LSBr", "--alphas", "0.1"])
    stego = cat / "stego_LSBr_alpha_0.1_independent_images"
    (stego / names[5]).write_bytes(b"not a png")
    params = jax.tree.map(np.asarray, _jax_unet_2_variables()["params"])
    torch.save(unet_state_dict_from_flax(params), job / "unet_2.pt")
    return job


@pytest.fixture(scope="module")
def launched(job):
    """The two ranks, started (they run while the JAX side runs here)."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", str(job)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_side(job, launched) -> dict:
    """JAX's spatial paths on the 8-device mesh, and its sweeps over the
    catalog (every sweep sharded over the 8 devices)."""
    import jax
    import jax.numpy as jnp
    import pandas as pd
    from wsunet_tpu.detect import b0_run as jax_b0_run
    from wsunet_tpu.models.unet import UNet as JaxUNet
    from wsunet_tpu.parallel import get_mesh
    from wsunet_tpu.parallel.spatial import (infer_unet_spatial,
                                             ws_attack_spatial)
    from wsunet_tpu.ws import unet_run as jax_unet_run
    from wsunet_tpu.ws import ws_run as jax_ws_run

    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    mesh = get_mesh(8, axis="spatial")
    x = jnp.asarray(spatial_inputs())
    out = {f"beta/{w}": np.asarray(ws_attack_spatial(
        x, KB, mesh, axis="spatial", weighted=w)) for w in WEIGHTED}
    out["unet"] = np.asarray(infer_unet_spatial(
        JaxUNet(nsteps=2), _jax_unet_2_variables(), x.astype(jnp.float32),
        mesh, axis="spatial"))
    cat = job / "cat"
    out["ws"] = pd.concat(
        [jax_ws_run(cat, "LSBR", 0.1, m, batch_size=SWEEP_BATCH)
         for m in ("KB", "KB-w", "OLS")] +
        [jax_ws_run(cat, None, None, "KB", batch_size=SWEEP_BATCH)]
    ).reset_index(drop=True)
    out["unet_run"] = jax_unet_run(cat, REPO / "models" / "unet", "LSBR",
                                   batch_size=SWEEP_BATCH)
    out["b0_run"] = jax_b0_run(cat, REPO / "models" / "b0", "LSBR",
                               batch_size=SWEEP_BATCH)
    return out


@pytest.fixture(scope="module")
def ranks(job, launched, jax_side) -> list:
    """What each of the two ranks got."""
    for r, p in enumerate(launched):
        try:
            log, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            pytest.fail(f"rank {r} did not finish in {TIMEOUT} s:\n{log}")
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    out = []
    for r in range(2):
        with open(job / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process (file store), torn down
    after the test."""
    import torch.distributed as dist

    from wsunet_tpu_torch.parallel.distributed import distributed_init

    assert distributed_init(init_method=f"file://{tmp_path / 'rdzv'}",
                            world_size=1, rank=0, device="cpu") is False
    assert dist.is_initialized()
    try:
        yield
    finally:
        dist.destroy_process_group()


# --- (a), (b): the spatial paths -----------------------------------------

def _spatial_checks(got: dict, want: dict, job: pathlib.Path, world: int):
    from wsunet_tpu_torch.models import get_model
    from wsunet_tpu_torch.ops import ws_attack
    from wsunet_tpu_torch.ws.unet_eval import infer_unet

    x = spatial_inputs()
    for w in WEIGHTED:
        np.testing.assert_allclose(got[f"beta/{w}"], want[f"beta/{w}"],
                                   rtol=1e-4, atol=1e-6, err_msg=str(w))
        plain = ws_attack(torch.from_numpy(x), pixel_kernel=KB, weighted=w)
        np.testing.assert_allclose(got[f"beta/{w}"], plain.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=str(w))
    assert got["unet"].shape == (2, 126, 126)
    np.testing.assert_allclose(got["unet"], want["unet"], rtol=1e-4,
                               atol=1e-3)
    model = get_model("unet_2")
    model.load_state_dict(torch.load(job / "unet_2.pt"))
    single = infer_unet(model.eval(), x.astype("float32"), device="cpu")
    np.testing.assert_array_equal(got["unet"], single.numpy())
    # 129 rows divide over one rank, not over two
    assert len(got["refused"]) == 1 + world, got["refused"]
    assert "2**2" in got["refused"][0] and "fast_conv" in got["refused"][1]


def test_spatial_paths_at_one_rank_match_jax(job, jax_side, world1):
    _spatial_checks(case_spatial(job), jax_side, job, world=1)


def test_spatial_paths_at_two_ranks_match_jax(job, jax_side, ranks):
    for got in ranks:
        _spatial_checks(got["spatial"], jax_side, job, world=2)
    for key in ("beta/0", "beta/1", "beta/-1", "unet"):
        np.testing.assert_array_equal(ranks[0]["spatial"][key],
                                      ranks[1]["spatial"][key])


def test_spatial_paths_without_a_group(job, jax_side):
    _spatial_checks(case_spatial(job), jax_side, job, world=1)


# --- (c): the rank-sharded sweeps ----------------------------------------

# B0 on the CPU is not invariant to an image's place in its batch: the
# same process scoring the same images in another order within a batch
# moves P(stego) by up to 3.0e-8 (1-2 ulps near 0.45); a rank-sharded
# sweep puts each image in another batch, so B0's rows are held at rtol
# 1e-6 (the other columns, and the ws-eval and U-Net rows, bit for bit)
B0_SHARD_RTOL = 1e-6


def _equal_rows(got, want, obj: str, b0: bool):
    import pandas as pd

    if not b0:
        pd.testing.assert_frame_equal(got, want, check_exact=True, obj=obj)
        return
    pd.testing.assert_frame_equal(got.drop(columns=["output", "prediction"]),
                                  want.drop(columns=["output", "prediction"]),
                                  check_exact=True, obj=obj)
    np.testing.assert_allclose(got["output"], want["output"],
                               rtol=B0_SHARD_RTOL, atol=0, err_msg=obj)
    clear = (want["output"] - 0.5).abs() > B0_SHARD_RTOL
    assert (got["prediction"][clear] == want["prediction"][clear]).all()


@pytest.mark.parametrize("sweep", ["ws", "unet", "b0"])
def test_sharded_sweeps_equal_one_process(ranks, sweep):
    for r, got in enumerate(ranks):
        _equal_rows(got["sweeps"]["sharded"][sweep],
                    got["sweeps"]["single"][sweep], f"rank {r} {sweep}",
                    b0=sweep == "b0")
    # the rows were all-gathered: both ranks hold the same bits
    import pandas as pd
    pd.testing.assert_frame_equal(ranks[0]["sweeps"]["sharded"][sweep],
                                  ranks[1]["sweeps"]["sharded"][sweep],
                                  check_exact=True)


def _same_text(got, want, numbers):
    """The same columns and rows; every column but ``numbers`` equal as
    text."""
    assert list(got.columns) == list(want.columns)
    for col in got.columns:
        if col not in numbers:
            assert got[col].astype(str).tolist() == \
                want[col].astype(str).tolist(), col


def test_sharded_sweeps_match_jax(ranks, jax_side):
    frames = ranks[0]["sweeps"]["single"]
    ws, want = frames["ws"], jax_side["ws"]
    # the corrupt stego file: dropped from the ws-eval rows, a NaN row in
    # the U-Net and B0 sweeps
    assert len(ws) == len(want) == 3 * 7 + 8
    _same_text(ws, want, ("beta_hat",))
    for model, (rtol, atol) in (("KB", (1e-4, 1e-6)), ("KB-w", (1e-4, 1e-6)),
                                ("OLS", (0.0, 2e-4))):
        sel = (ws["model_name"] == model).to_numpy()
        np.testing.assert_allclose(ws["beta_hat"][sel],
                                   want["beta_hat"][sel], rtol=rtol,
                                   atol=atol, err_msg=model)
    unet, want = frames["unet"], jax_side["unet_run"]
    assert len(unet) == 16 and unet["beta_hat"].isna().sum() == 1
    _same_text(unet, want, ("beta_hat", "l1"))
    np.testing.assert_allclose(unet["beta_hat"], want["beta_hat"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(unet["l1"], want["l1"], rtol=1e-4, atol=0)
    b0, want = frames["b0"], jax_side["b0_run"]
    assert len(b0) == 16 and b0["output"].isna().sum() == 1
    _same_text(b0, want, ("output", "prediction"))
    np.testing.assert_allclose(b0["output"], want["output"], rtol=0,
                               atol=1e-4)


# --- (d): host_shard / allgather_rows ------------------------------------

def test_host_shard_and_allgather_rows(ranks):
    want = np.array([[np.pi * i, 1 / (1 + i)] for i in range(7)])
    assert ranks[0]["rows"]["local"] == ["n0", "n2", "n4", "n6"]
    assert ranks[1]["rows"]["local"] == ["n1", "n3", "n5", "n0"]
    assert [r["rows"]["n_true"] for r in ranks] == [4, 3]
    for got in ranks:
        assert got["rows"]["rows"].dtype == np.float64
        np.testing.assert_array_equal(got["rows"]["rows"], want)
        assert got["rows"]["col"].dtype == np.float32
        np.testing.assert_array_equal(got["rows"]["col"],
                                      want[:, 0].astype("float32"))


def test_eval_shard_at_one_process():
    from wsunet_tpu_torch import parallel

    assert parallel.eval_device_count() == 1 == parallel.device_count()
    assert parallel.round_batch(5) == 5
    v = np.array([1.0, 2.0])
    assert parallel.allgather_rows(v, 2) is v
    names = ["a", "b", "c"]
    assert parallel.host_shard(names) == (names, 3)
    assert parallel.cache_on_device()
    step = lambda x: x  # noqa: E731
    assert parallel.jit_sharded(step) is step
    mesh = parallel.get_mesh()
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    batch = {"x": np.arange(6), "y": (torch.arange(4),)}
    assert parallel.shard_batch(mesh, batch)["x"] is not None
    np.testing.assert_array_equal(parallel.shard_batch(mesh, batch)["x"],
                                  batch["x"])


def test_each_rank_decodes_its_block_of_a_training_batch(job, ranks):
    """The trainers' batches at two ranks: each rank's block of every
    batch, padding and failed decodes included, is the one-process
    batch's block, and every rank sees the global mask."""
    from wsunet_tpu_torch.data.pipeline import clear_decode_cache

    clear_decode_cache()
    one = case_batches(job)
    assert [v.tolist() for v, _, _ in one] == \
        [[True] * 4, [False, True, False, False]]
    for r, got in enumerate(ranks):
        assert len(got["batches"]) == len(one)
        for (valid, pixels, mask), (v1, px1, m1) in zip(got["batches"], one):
            np.testing.assert_array_equal(valid, v1)
            np.testing.assert_array_equal(pixels, px1[2 * r:2 * r + 2])
            np.testing.assert_array_equal(mask, m1[2 * r:2 * r + 2])
    # rank 1's block of the last batch is two rows of padding by the
    # corrupt file: zeros, as the one-process batch pads
    assert not ranks[1]["batches"][1][1].any()


# --- (e), (f): the training steps ----------------------------------------

def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() /
                 max(float(np.abs(want).max()), 1e-30))


def test_unet_step_at_two_ranks_is_the_one_rank_step(ranks):
    one = unet_golden_step()
    z = np.load(GOLDEN / "p128_train_step.npz")
    for got in (r["steps"]["unet"] for r in ranks):
        assert abs(got["loss"] / one["loss"] - 1) <= 1e-6
        assert sorted(got["grad"]) == sorted(one["grad"])
        for k, g in got["grad"].items():
            assert _rel(g, one["grad"][k]) <= 1e-5, k
        assert abs(got["loss"] / float(z["loss"]) - 1) <= 1e-3
        for k in (k[len("grad/"):] for k in z.files
                  if k.startswith("grad/")):
            assert _rel(got["grad"][k], z[f"grad/{k}"]) <= 1e-3, k


def test_b0_live_float64_step_at_two_ranks(ranks):
    one = b0_step()
    z = np.load(GOLDEN / "p128_b0_train_step.npz")
    gmax = max(float(np.abs(v).max()) for v in one["grad"].values())
    for got in (r["steps"]["b0"] for r in ranks):
        assert abs(got["loss"] / one["loss"] - 1) <= 1e-6
        assert abs(got["loss"] / float(z["live64/loss"]) - 1) <= 1e-6
        np.testing.assert_array_equal(got["labels"], one["labels"])
        np.testing.assert_allclose(got["logits"], one["logits"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["logits"], z["live64/logits"],
                                   rtol=0, atol=1e-6)
        for k, g in got["grad"].items():
            assert float(np.abs(g - one["grad"][k]).max()) <= 1e-6 * gmax, k
        for k in (k[len("live64/grad/"):] for k in z.files
                  if k.startswith("live64/grad/")):
            assert _rel(got["grad"][k], z[f"live64/grad/{k}"]) <= 1e-6, k
        for k, s in got["stats"].items():
            np.testing.assert_allclose(s, one["stats"][k], rtol=1e-6,
                                       atol=0, err_msg=k)
        for k in (k[len("live64/stats/"):] for k in z.files
                  if k.startswith("live64/stats/")):
            np.testing.assert_allclose(got["stats"][k], z[f"live64/stats/{k}"],
                                       rtol=1e-6, atol=0, err_msg=k)
    for k, s in ranks[0]["steps"]["b0"]["stats"].items():
        np.testing.assert_array_equal(s, ranks[1]["steps"]["b0"]["stats"][k])


# the f32 B0 steps against the one-rank f32 step and JAX's f32 golden
# step at the f32 step's 1e-3 (tests/test_torch_train_b0.py; chip_smoke.py
# phase 12): loss rel, logits, each of JAX's full gradients max|d| /
# max|g|, and every gradient against the one-rank step's max|d| of the
# largest gradient of any tensor (the biases of norms that another norm
# follows have gradients at the f32 rounding floor)
B0_F32 = 1e-3


@pytest.mark.parametrize("kind", ["b0_recipe32", "b0_live32"])
def test_b0_f32_step_at_two_ranks(ranks, kind):
    live = B0_STEPS[kind][0]
    one = b0_step(None, *B0_STEPS[kind])
    z = np.load(GOLDEN / "p128_b0_train_step.npz")
    tag = "live/" if live else ""
    for got in (r["steps"][kind] for r in ranks):
        for want in (one["loss"], float(z[f"{tag}loss"])):
            assert abs(got["loss"] / want - 1) <= B0_F32
        np.testing.assert_array_equal(got["labels"], one["labels"])
        for want in (one["logits"], z[f"{tag}logits"]):
            np.testing.assert_allclose(got["logits"], want, rtol=0,
                                       atol=B0_F32)
        assert sorted(got["grad"]) == sorted(one["grad"])
        gmax = max(float(np.abs(v).max()) for v in one["grad"].values())
        for k, g in got["grad"].items():
            assert float(np.abs(g - one["grad"][k]).max()) <= \
                B0_F32 * gmax, k
        for k in (k[len(f"{tag}grad/"):] for k in z.files
                  if k.startswith(f"{tag}grad/")):
            assert _rel(got["grad"][k], z[f"{tag}grad/{k}"]) <= B0_F32, k
    for k, s in ranks[0]["steps"][kind]["stats"].items():
        np.testing.assert_array_equal(s, ranks[1]["steps"][kind]["stats"][k])


# --- (g): rank 0 writes the run ------------------------------------------

@pytest.mark.parametrize("kind", ["unet", "b0"])
def test_rank0_alone_writes_the_run(job, ranks, kind):
    from wsunet_tpu_torch.detect import load_pretrained_b0
    from wsunet_tpu_torch.ws import load_pretrained_unet

    exp = pathlib.Path(ranks[0]["runs"][kind])
    assert ranks[1]["runs"][kind] == str(exp)
    method = exp.parent
    assert [p.name for p in method.iterdir()] == [exp.name]
    for f in ("config.json", "best.npz", "model/best/state.pt",
              "model/latest/state.pt", "log/scalars.csv"):
        assert (exp / f).exists(), f
    load = load_pretrained_unet if kind == "unet" else load_pretrained_b0
    model, config = load(method, exp.name, device="cpu")
    assert config["batch_size"] == (4 if kind == "unet" else 2)
    x = torch.from_numpy(np.load(GOLDEN / "p128_lsbr.npz")["pixels"][0, :2])
    if kind == "unet":
        from wsunet_tpu_torch.ws import predict_batch
        out = torch.stack(predict_batch(model, x, device="cpu"))
    else:
        from wsunet_tpu_torch.detect import infer_b0
        out = infer_b0(model, x, device="cpu")
    assert torch.isfinite(out).all()


def test_trainers_refuse_a_batch_that_does_not_divide(job, ranks):
    from wsunet_tpu_torch.parallel.mesh import Mesh
    from wsunet_tpu_torch.utils.errors import UserError

    for got in ranks:
        assert "batch_size 3 does not divide over 2 ranks" in \
            got["runs"]["refused"]
    assert not (job / "runs_odd").exists()
    assert Mesh(rank=1, world=2).block(4) == slice(2, 4)
    with pytest.raises(UserError, match="does not divide"):
        Mesh(rank=0, world=2).block(3)


def test_cli_sweep_under_two_ranks_writes_once(ranks):
    """The CLI keeps the group it finds and leaves it up; rank 0's CSV
    holds the sharded frame's rows."""
    import pandas as pd

    path = pathlib.Path(ranks[0]["cli"]["csv"])
    assert ranks[1]["cli"]["csv"] == str(path) and path.exists()
    got = pd.read_csv(path)
    want = ranks[0]["sweeps"]["sharded"]["unet"]
    assert got["name"].tolist() == want["name"].tolist()
    np.testing.assert_allclose(got["beta_hat"], want["beta_hat"], rtol=1e-6)


# --- the process group ---------------------------------------------------

def test_distributed_init_rules(monkeypatch):
    import torch.distributed as dist

    from wsunet_tpu_torch.parallel.distributed import (distributed_init,
                                                       process_local_rows)
    from wsunet_tpu_torch.utils.errors import UserError

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() is False and not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed_init() is False and not dist.is_initialized()
    with pytest.raises(UserError, match="nccl"):
        distributed_init(init_method="file:///nonexistent", world_size=1,
                         rank=0, backend="nccl")
    with pytest.raises(UserError, match="CUDA"):
        distributed_init(init_method="file:///nonexistent", world_size=1,
                         rank=0)
    assert not dist.is_initialized()
    assert process_local_rows(list("abcde"), 1, 2) == ["b", "d"]
