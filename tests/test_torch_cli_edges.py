"""Port parity of the CLI's host edges: ``init-dataset`` and ``serve``
(``python -m wsunet_tpu_torch``) against ``python -m wsunet_tpu``, on the
CPU, and the profiling and NaN hooks that wrap every command
(``utils.profiling``: ``WSUNET_PROFILE``, ``WSUNET_DEBUG_NANS``).

- ``init-dataset``: ``files.csv`` and ``split_{tr,va,te}.csv`` byte for
  byte JAX's, on a tree with a stego subdirectory, also in a process where
  pandas, PIL, cv2, matplotlib and seaborn cannot be imported, and where
  the stego ``files.csv`` lacks the size columns (pandas' ``concat`` then
  writes the covers' sizes as floats).  PNG sizes come from the IHDR
  alone, so 16-bit and interlaced files are sized as PIL sizes them;
  without PIL a ``.jpg`` raises a ``UserError`` naming it.
- ``serve --device cpu --dtype float32 --size 128`` on the committed LSBR
  ``unet_2`` (JAX from ``models/unet``, the port from ``weights/unet``):
  the JSON lines of both loops (paths streamed, stdin serial) name the
  same images, in order, with beta_hat and l1 within the server bounds of
  ``tests/test_torch_serve.py`` (rtol 1e-4, atol 1e-5) and the same error
  lines.
"""

import io
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_p128 import P128, REPO, make_catalog, run_without_host_packages
from wsunet_tpu.cli import main as jax_main
from wsunet_tpu_torch.cli import main as torch_main
from wsunet_tpu_torch.ops import fused_reflect_conv
from wsunet_tpu_torch.serve import UNetWSServer, serve_lines
from wsunet_tpu_torch.utils import profiling
from wsunet_tpu_torch.ws import load_pretrained_unet

JAX_MODELS = REPO / "models" / "unet"
PORT_MODELS = REPO / "weights" / "unet"
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_init_dataset_files_equal_jax_byte_for_byte(tmp_path):
    a = make_catalog(tmp_path / "jax", n=8, alphas=(0.1,))
    b = tmp_path / "port"
    shutil.copytree(a, b)
    assert jax_main(["init-dataset", "--data", str(a)]) == 0
    assert torch_main(["init-dataset", "--data", str(b)]) == 0
    files = ["images/files.csv", "split_tr.csv", "split_va.csv",
             "split_te.csv"]
    for rel in files:
        assert (b / rel).read_bytes() == (a / rel).read_bytes(), rel
    rows = sum(len((b / rel).read_text().splitlines()) - 1
               for rel in files[1:])
    assert rows == 16    # every cover and its stego, once
    with pytest.raises(SystemExit, match="does not support --split"):
        torch_main(["init-dataset", "--data", str(b), "--take", "2"])
    with pytest.raises(SystemExit, match="^init-dataset: no images"):
        (tmp_path / "empty" / "images").mkdir(parents=True)
        torch_main(["init-dataset", "--data", str(tmp_path / "empty")])


INIT_FILES = ["images/files.csv", "split_tr.csv", "split_va.csv",
              "split_te.csv"]


@pytest.mark.parametrize("stego", ["with sizes", "without sizes"])
def test_init_dataset_without_host_packages_is_jax_bytes(tmp_path, stego):
    import pandas as pd

    a = make_catalog(tmp_path / "jax", n=8, alphas=(0.1,))
    if stego == "without sizes":
        fcsv = a / "stego_LSBr_alpha_0.1_independent_images" / "files.csv"
        pd.read_csv(fcsv).drop(columns=["height", "width"]).to_csv(
            fcsv, index=False)
    b = tmp_path / "port"
    shutil.copytree(a, b)
    assert jax_main(["init-dataset", "--data", str(a)]) == 0
    run_without_host_packages(["init-dataset", "--data", b], tmp_path)
    for rel in INIT_FILES:
        assert (b / rel).read_bytes() == (a / rel).read_bytes(), rel
    floats = ",128.0,128.0," in (b / "split_tr.csv").read_text()
    assert floats == (stego == "without sizes")


def _interlaced_png(path, img: np.ndarray) -> None:
    """An 8-bit gray Adam7-interlaced PNG of ``img`` (filter 0 rows)."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))

    h, w = img.shape
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\0" + row.tobytes() for row in sub)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1)) +
        chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_init_dataset_sizes_16_bit_and_interlaced_pngs_as_pil(tmp_path):
    """``io.png.read`` rejects both files; ``image_size`` reads their
    IHDR, and ``init-dataset`` without the host packages writes the JAX
    CLI's (PIL's) sizes."""
    from PIL import Image

    from wsunet_tpu_torch.io import image_size
    from wsunet_tpu_torch.io.png import png_size, read_png
    from wsunet_tpu_torch.utils.errors import UserError

    a = tmp_path / "jax"
    (a / "images").mkdir(parents=True)
    rng = np.random.default_rng(5)
    deep = rng.integers(0, 65536, (21, 37)).astype(np.uint16)
    Image.fromarray(deep).save(a / "images" / "deep.png")
    laced = rng.integers(0, 256, (10, 13)).astype(np.uint8)
    _interlaced_png(a / "images" / "laced.png", laced)
    shutil.copyfile(P128 / "images" / "6_00.png", a / "images" / "6_00.png")
    with Image.open(a / "images" / "laced.png") as im:
        np.testing.assert_array_equal(np.asarray(im), laced)
    for name, size in (("deep", (37, 21)), ("laced", (13, 10))):
        p = a / "images" / f"{name}.png"
        with Image.open(p) as im:
            assert image_size(p) == png_size(p) == im.size == size
        with pytest.raises(UserError, match="unsupported PNG"):
            read_png(p)
    b = tmp_path / "port"
    shutil.copytree(a, b)
    assert jax_main(["init-dataset", "--data", str(a)]) == 0
    run_without_host_packages(["init-dataset", "--data", b], tmp_path)
    for rel in INIT_FILES:
        assert (b / rel).read_bytes() == (a / rel).read_bytes(), rel
    assert "images/deep.png,21,37" in (b / "images/files.csv").read_text()


def test_init_dataset_needs_pil_for_a_jpg(tmp_path):
    """Without PIL a ``.jpg`` cover raises a ``UserError`` naming it (one
    line from the CLI); with PIL the files are JAX's."""
    from PIL import Image

    a = tmp_path / "jax"
    (a / "images").mkdir(parents=True)
    shutil.copyfile(P128 / "images" / "6_00.png", a / "images" / "6_00.png")
    Image.fromarray(np.full((24, 40), 100, np.uint8)).save(
        a / "images" / "x.jpg")
    b = tmp_path / "port"
    shutil.copytree(a, b)
    proc = run_without_host_packages(["init-dataset", "--data", b],
                                     tmp_path, check=False)
    assert proc.returncode != 0
    assert proc.stderr.strip().splitlines()[-1] == (
        f"init-dataset: {b / 'images' / 'x.jpg'}: only PNG sizes are read "
        f"without PIL, which is not installed")
    assert jax_main(["init-dataset", "--data", str(a)]) == 0
    assert torch_main(["init-dataset", "--data", str(b)]) == 0
    for rel in INIT_FILES:
        assert (b / rel).read_bytes() == (a / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def serve_inputs(tmp_path_factory):
    """Four p128 covers as PNGs, a missing path and a 64x64 image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("serve")
    paths = [str(p) for p in sorted((P128 / "images").glob("*.png"))[:4]]
    small = root / "small.png"
    Image.fromarray(np.zeros((64, 64), np.uint8), mode="L").save(small)
    return [paths[0], str(root / "missing.png"), paths[1], str(small),
            paths[2], paths[3]]


def _serve(main, argv, stdin, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    assert main(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


@pytest.fixture(scope="module")
def jax_lines(serve_inputs):
    """JAX's serve lines: paths as arguments, then the same on stdin."""
    mp = pytest.MonkeyPatch()
    # no TPU probe: the conftest pins JAX to the CPU
    mp.setenv("WSUNET_ASSUME_TPU", "1")
    out = {}
    try:
        for mode in ("paths", "stdin"):
            buf = io.StringIO()
            mp.setattr(sys, "stdout", buf)
            mp.setattr(sys, "stdin", io.StringIO(
                "\n".join(serve_inputs) + "\n" if mode == "stdin" else ""))
            argv = ["serve", "--model-dir", str(JAX_MODELS), "--size", "128",
                    "--dtype", "float32"]
            assert jax_main(argv + (serve_inputs if mode == "paths"
                                    else [])) == 0
            out[mode] = [json.loads(x) for x in
                         buf.getvalue().strip().splitlines()]
    finally:
        mp.undo()
    return out


def _assert_lines_match(got, want):
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        assert ("error" in g) == ("error" in w), (g, w)
        if "error" in w:
            assert g["error"].split(":")[0] == w["error"].split(":")[0]
            continue
        np.testing.assert_allclose([g["beta_hat"], g["l1"]],
                                   [w["beta_hat"], w["l1"]],
                                   rtol=SERVE_RTOL, atol=SERVE_ATOL)


@pytest.mark.parametrize("mode", ["paths", "stdin"])
@pytest.mark.parametrize("fast_conv", [False, True])
def test_cli_serve_matches_jax(serve_inputs, jax_lines, capsys, monkeypatch,
                               mode, fast_conv):
    argv = ["serve", "--device", "cpu", "--size", "128", "--dtype",
            "float32"] + (["--fast-conv"] if fast_conv else [])
    stdin = "\n".join(serve_inputs) + "\n\n"     # a blank line is skipped
    got = _serve(torch_main, argv + (serve_inputs if mode == "paths" else []),
                 stdin if mode == "stdin" else "", capsys, monkeypatch)
    want = jax_lines[mode]
    assert len(want) == 6 and "error" in want[1] and "error" in want[3]
    _assert_lines_match(got, want)
    assert "64x64" in got[3]["error"] and "--size" in got[3]["error"]


def test_serve_lines_answers_each_line_before_reading_the_next():
    model, _ = load_pretrained_unet(
        PORT_MODELS / "LSBR", sorted(p.name for p in
                                     (PORT_MODELS / "LSBR").iterdir())[0],
        device="cpu")
    server = UNetWSServer(model, size=32, compute_dtype=torch.float32,
                          device="cpu")
    rng = np.random.default_rng(0)
    images = {"a": rng.integers(0, 256, (32, 32), dtype=np.uint8),
              "b": np.zeros((16, 32), np.uint8),
              "c": rng.integers(0, 256, (32, 32), dtype=np.uint8)}
    read, answered = [], []

    def lines():
        for name in images:
            read.append(name)
            assert len(answered) == len(read) - 1   # the last one answered
            yield name + "\n"

    for out in serve_lines(server, lines(), reader=images.__getitem__):
        answered.append(out)
    assert [o["name"] for o in answered] == ["a", "b", "c"]
    assert answered[1]["error"].startswith("ValueError: expected 32x32, "
                                           "got 16x32")
    for name in ("a", "c"):
        out = answered["abc".index(name)]
        assert (out["beta_hat"], out["l1"]) == server.predict(images[name])


def test_serve_without_a_card_exits_with_one_line(serve_inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        torch_main(["serve", *serve_inputs[:1]])
    msg = str(e.value)
    assert msg.startswith("serve: CUDA is not available") and "\n" not in msg
    with pytest.raises(SystemExit, match="^serve: --dtype int8"):
        torch_main(["serve", "--device", "cpu", "--dtype", "int8"])


def test_nan_check_raises_in_the_forward_and_the_backward():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with profiling.nan_check(False):
        assert torch.isnan(torch.zeros(1) / 0).all()   # off: nothing
    with profiling.nan_check():
        y = torch.where(x > 0, torch.log(x), torch.zeros(()))  # no NaN
        with pytest.raises(FloatingPointError, match="div"):
            torch.zeros(2) / torch.zeros(2)
        with pytest.raises(FloatingPointError):
            y.sum().backward()      # d log(x) / dx at 0, times 0
    assert not profiling._state["nans"]
    torch.zeros(1) / 0              # off again


class _Opaque(torch.autograd.Function):
    """A backward that returns a NaN tensor without dispatching an op, as
    a kernel writing through ctypes would."""

    nan = torch.tensor([float("nan")])

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _Opaque.nan


def test_nan_check_catches_a_backward_the_dispatch_mode_cannot_see():
    x = torch.ones(1, requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan values"):
        with profiling.nan_check():
            _Opaque.apply(x).sum().backward()
    assert not profiling._state["nans"]


def test_nan_check_sees_kernel_outputs_and_b1s_plain_version():
    out = torch.tensor([1.0, float("nan")])
    profiling.check_output(out, "B1 (wgmma)")     # off: no check
    with profiling.nan_check():
        with pytest.raises(FloatingPointError, match="B1"):
            profiling.check_output(out, "B1 (wgmma)")
        x = torch.zeros((1, 4, 4, 2))
        w = torch.full((3, 3, 2, 3), float("inf"))
        b = torch.zeros(3)
        fused_reflect_conv.reset_launches()
        with pytest.raises(FloatingPointError):   # 0 * inf on the CPU
            fused_reflect_conv.conv3x3_reflect_fused(x, w, b)
        assert fused_reflect_conv.launches == 0
        torch.empty(1000)                          # uninitialised: skipped


def test_cli_hooks_profile_and_nan_check(tmp_path, monkeypatch):
    """WSUNET_PROFILE writes a trace around a command; WSUNET_DEBUG_NANS=1
    runs it under nan_check."""
    seen = []
    monkeypatch.setattr("wsunet_tpu_torch.cli._dispatch", lambda args: (
        seen.append(profiling._state["nans"]), torch.ones(3).sum())[0] or 0)
    monkeypatch.setenv("WSUNET_PROFILE", str(tmp_path / "trace"))
    monkeypatch.setenv("WSUNET_DEBUG_NANS", "1")
    assert torch_main(["init-dataset", "--data", str(tmp_path)]) == 0
    monkeypatch.delenv("WSUNET_DEBUG_NANS")
    monkeypatch.delenv("WSUNET_PROFILE")
    assert torch_main(["init-dataset", "--data", str(tmp_path)]) == 0
    assert seen == [True, False]
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)


def test_log_compiles_restores_its_state(caplog):
    assert not profiling._state["compiles"]
    with profiling.log_compiles():
        assert profiling._state["compiles"]
        with profiling.log_compiles(False):
            profiling.note_compile("x", ["nvcc", "x.cu"], 1.5)
        assert profiling._state["compiles"]
        profiling.note_compile("ws_fused", ["nvcc", "-O3", "ws_fused.cu"],
                               2.25)
    assert not profiling._state["compiles"]
    profiling.note_compile("y", ["nvcc"], 1.0)
    logged = [r.getMessage() for r in caplog.records]
    assert logged == ["compiled ws_fused in 2.2 s: nvcc -O3 ws_fused.cu"]
